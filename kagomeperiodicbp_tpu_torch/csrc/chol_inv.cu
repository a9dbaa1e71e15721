// K2 · chol_inv: Cholesky factor and its inverse of a Hermitian PSD matrix.
//
// Replaces: kagomeperiodicbp_tpu/ops/pallas_kernels.py · chol_inv_pallas
// (kernel _chol_inv_kernel), the small-matrix half of CholeskyQR2
// (ops/linalg._cholqr_once).
//
//   G = L·L†  (L lower triangular),   W = L⁻¹  (forward substitution)
//
// G is the shifted gram A†A + u·tr(G)·I, so it is positive definite; as in
// the Pallas kernel every pivot is clamped as max(Re g_jj, tiny) and every
// diagonal divisor as max(Re l_jj, tiny) (tiny = 1e-300 in double, 1e-30 in
// float), so rank-deficient padded bonds behave as they do there.
//
// What bounds it on this card: the column order of the factorization. Each
// of the k columns depends on the one before it, so the k³/6 multiply-adds
// of the trailing updates come as k dependent rounds of shrinking size, and
// at the slice's sizes (k ≤ ~500) one matrix cannot fill 132 SMs; latency
// and the L2 traffic of the trailing matrix (4 MB at k=504 in complex128,
// above a block's 227 KB of shared memory) bound it, not the FP64 rate.
//
// What the design does about it: one thread block per matrix (blockIdx.x is
// the matrix index, so a later change can batch the QRs of a window into one
// launch). The factorization is right-looking, column by column, in a
// scratch copy of G in global memory (L2-resident); only the current column
// sits in shared memory, and the block synchronises between columns. The
// inverse then needs no synchronisation at all: each thread owns whole
// columns of W and runs forward substitution down them. Complex values stay
// interleaved (float2/double2), and double precision is native here, so
// complex128 runs in double (the TPU kernel was float32 planes only). The
// 128-padding of the Pallas version was the TPU's tile size and is gone.
#include "common.cuh"

template <typename T>
__global__ void chol_inv_kernel(const T* __restrict__ g_all, T* __restrict__ s_all,
                                T* __restrict__ l_all, T* __restrict__ w_all, int k,
                                typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  extern __shared__ unsigned char smem_raw[];
  T* col = reinterpret_cast<T*>(smem_raw);  // current column of L, rows ≥ j

  const long long off = (long long)blockIdx.x * k * k;
  const T* g = g_all + off;
  T* s = s_all + off;
  T* l = l_all + off;
  T* w = w_all + off;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int kk = k * k;

  for (int i = tid; i < kk; i += nt) {
    s[i] = g[i];
    l[i] = S::zero();
  }
  __syncthreads();

  // ---- right-looking Cholesky on the lower triangle of s ----
  for (int j = 0; j < k; ++j) {
    const R gjj = S::re(s[j * k + j]);
    const R dinv = krsqrt(gjj > tiny ? gjj : tiny);
    for (int i = j + tid; i < k; i += nt) {
      const T c = S::scale(s[i * k + j], dinv);
      col[i] = c;
      l[i * k + j] = c;
    }
    __syncthreads();
    // trailing update s[i][m] −= c_i·conj(c_m) for j < m ≤ i < k
    const int t = k - j - 1;
    for (int q = tid; q < t * t; q += nt) {
      const int i = j + 1 + q / t;
      const int m = j + 1 + q % t;
      if (m <= i) s[i * k + m] = S::mul_sub_conj(s[i * k + m], col[i], col[m]);
    }
    __syncthreads();
  }

  // ---- W = L⁻¹: one thread per column, forward substitution down it ----
  //   W[i][c] = (δ_ic − Σ_{m < i} L[i][m]·W[m][c]) / max(Re L[i][i], tiny)
  // Every thread walks the same (i, m) sequence (W[m][c] = 0 above the
  // diagonal), so a warp reads one L[i][m] by broadcast and a contiguous run
  // of W[m][c..c+31].
  for (int c = tid; c < k; c += nt) {
    for (int i = 0; i < k; ++i) {
      T acc = (i == c) ? S::from_real(R(1)) : S::zero();
      for (int m = 0; m < i; ++m) acc = S::mul_sub(acc, l[i * k + m], w[m * k + c]);
      const R lii = S::re(l[i * k + i]);
      w[i * k + c] = S::scale(acc, R(1) / (lii > tiny ? lii : tiny));
    }
  }
}

template <typename T>
static int launch_chol_inv(const void* g, void* scratch, void* l, void* w, int k, int batch,
                           double tiny, cudaStream_t stream) {
  using R = typename Scalar<T>::real;
  const int threads = 512;
  const size_t smem = (size_t)k * sizeof(T);
  chol_inv_kernel<T><<<batch, threads, smem, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(scratch), static_cast<T*>(l),
      static_cast<T*>(w), k, (R)tiny);
  return 0;
}

// g: contiguous [batch, k, k] Hermitian PSD (lower triangle read);
// scratch, l, w: contiguous [batch, k, k] of the same dtype, written.
// Returns cudaGetLastError() after the launch.
extern "C" int kpbp_chol_inv(const void* g, void* scratch, void* l, void* w, int k, int batch,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double tiny = (dtype == KPBP_F64 || dtype == KPBP_C128) ? 1e-300 : 1e-30;
#define KPBP_LAUNCH(T) launch_chol_inv<T>(g, scratch, l, w, k, batch, tiny, s)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return (int)cudaGetLastError();
}
