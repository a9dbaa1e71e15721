// K1 · fused_tensor: the double-layer (ket ⊗ bra) tensor of one site.
//
// Replaces: kagomeperiodicbp_tpu/ops/pallas_kernels.py · fused_tensor_pallas
// (kernel _fused_kernel_real), the Pallas twin of networks/unit_cell.fused_tensor.
//
//   out[(aA),(bB),(cC),(eE)] = Σ_s T[s,a,b,c,e] · conj(T[s,A,B,C,E])
//
// with T [d, D,D,D,D] and out [D²,D²,D²,D²], (aA) = a·D + A.
//
// What bounds it on this card: device-memory writes. The output has D⁸
// elements (16.8 M at D=8, 268 MB in complex128) and each one costs only d
// (= 2) complex multiply-adds, while the input is d·D⁴ elements (8 192 at
// D=8) and stays in L1/L2. So the kernel is a store stream.
//
// What the design does about it: one thread per output element in a
// grid-stride loop, consecutive threads on consecutive output addresses, so
// every element is written exactly once with coalesced stores; each thread
// decodes (a,A,b,B,c,C,e,E) from its flat index and reads its 2·d inputs
// through the read-only cache. Complex values stay in their interleaved
// storage (float2/double2): the re/im planes of the Pallas kernel existed
// only because the TPU has no complex type.
#include "common.cuh"

template <typename T>
__global__ void fused_tensor_kernel(const T* __restrict__ t, T* __restrict__ out,
                                    int d, int D) {
  using S = Scalar<T>;
  const long long p = (long long)D * D;
  const long long d4 = p * p;
  const long long n = d4 * d4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += stride) {
    long long r = idx;
    const int eE = (int)(r % p); r /= p;
    const int cC = (int)(r % p); r /= p;
    const int bB = (int)(r % p); r /= p;
    const int aA = (int)r;
    const int ket = (((aA / D) * D + bB / D) * D + cC / D) * D + eE / D;
    const int bra = (((aA % D) * D + bB % D) * D + cC % D) * D + eE % D;
    T acc = S::zero();
    for (int s = 0; s < d; ++s) {
      acc = S::mul_add_conj(acc, __ldg(t + s * d4 + ket), __ldg(t + s * d4 + bra));
    }
    out[idx] = acc;
  }
}

template <typename T>
static void launch_fused(const void* t, void* out, int d, int D, cudaStream_t stream) {
  const long long p = (long long)D * D;
  const long long n = p * p * p * p;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  fused_tensor_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(t), static_cast<T*>(out), d, D);
}

// t: contiguous [d, D,D,D,D]; out: contiguous [D²,D²,D²,D²]; both of `dtype`.
// Returns cudaGetLastError() after the launch.
extern "C" int kpbp_fused_tensor(const void* t, void* out, int d, int D, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KPBP_LAUNCH(T) launch_fused<T>(t, out, d, D, s)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return (int)cudaGetLastError();
}
