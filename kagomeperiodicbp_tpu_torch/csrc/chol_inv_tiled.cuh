// K2's tiled variant (chol_inv_tiled.cu), as chol_inv.cu's C interface
// calls it. dtype: a KpbpDtype code; nb: the tile width, 64 or (for 4- and
// 8-byte types) 128.
#pragma once

#include <cuda_runtime.h>

// the tile width the variant takes by default at size k, elements of `size` bytes
int chol_inv_tiled_default_nb(int k, int size);
// enqueues the launches on `stream`; the first nonzero cudaGetLastError(),
// or cudaErrorInvalidValue for arguments it does not take, else 0
int chol_inv_tiled(const void* g, void* scratch, void* l, void* w, int k, int batch, int dtype,
                   int nb, double tiny, cudaStream_t stream);
// the most dynamic shared memory one of its blocks takes, and its launches
long long chol_inv_tiled_smem(int dtype, int nb);
long long chol_inv_tiled_launches(int k, int dtype, int nb);
