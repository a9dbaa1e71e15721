// K2 · chol_inv, its tiled variant (c): the large grams, k from about 1300
// to the D=8 records' 8832. The entry points are declared in
// chol_inv_tiled.cuh and called by chol_inv.cu's C interface, which holds
// the variants (a) and (b), the clamps' contract and the plan queries.
//
// What bounds it on this card: at k = 2952…8832 the 8k³/3 flops (27.4 ms
// at k=8832 in complex64 at the CUDA cores' 67 TFLOP/s FP32); bytes stay
// below that as long as the tile width keeps the trailing matrix's trips
// through device memory few (below).
#include "chol_inv_tiled.cuh"
#include "common.cuh"

namespace {

// ------------------------------- (c) tiled ---------------------------------
//
// Right-looking blocked Cholesky and forward substitution with NB-wide tile
// columns (NB = 64, or 128 from k=4608 for 4- and 8-byte types; a 128-wide
// complex128 diagonal tile would not fit one block's shared memory), three
// launches per tile column j (the last one needs no update; at NB=64 the
// update factors the next diagonal tile itself, see fuses_diag):
//
//   diag    one block per matrix: L_jj = chol(A_jj) in shared memory
//           (smem_chol_tiled, with the clamps), written to L, and transposed to
//           the scratch (LT) with each column's rsqrt pivot and each clamped
//           reciprocal 1/max(Re L_tt, tiny);
//   panel   64 rows of the panel per block: L_ij = A_ij·L_jj^{-†} by
//           substitution along each row (a warp per row, 8 rows at once,
//           lanes over the columns), to L and, transposed, to the scratch
//           (PT[t][i] = L[i][jNB+t]) for the update; and 64 columns of W's
//           row block per block: W_jc = L_jj^{-1}·X_jc by forward
//           substitution down each column (X_jj = I). Row block j right of
//           its diagonal tile is written as zeros;
//   update  one complex GEMM over the lower trapezoid below the panel,
//           output tiles of TM×64 (TM = 128, 64 for complex128),
//           register-tiled (RM×4 outputs a thread), the panel depth staged
//           through shared memory by cp.async in a 3-stage ring of 16-deep
//           slices:
//             trailing  A_im −= L_ij·L_mj†     (columns ≥ (j+1)·NB, in L)
//             inverse   X_ic −= L_ij·W_jc      (columns < (j+1)·NB, in W)
//
// The trailing matrix is updated in place in L and X in W, so the scratch
// holds only PT, LT and the scales (NB·k + NB² + 2·NB elements a matrix);
// launch 0 reads G, every later one reads L. The panel is a substitution,
// never a product with an explicit inverse of L_jj (see panel_solve); only
// the off-diagonal updates are products. They carry all but ~NB/k of the
// 8k³/3 flops, and with NB=128 the trailing matrix and X stream through
// device memory k/128 times: ≈ 8.6 ms at 3.35 TB/s for k=8832 in
// complex64, below its 27.4 ms operation bound.

namespace tiled {
constexpr int CHUNK = 64;          // panel: rows (or W columns) per block
constexpr int P_THREADS = 256;     // 8 warps × 8 rows (or columns)
constexpr int P_VEC = CHUNK / (P_THREADS / 32);
constexpr int D_THREADS = 512;
constexpr int U_THREADS = 256;     // update: 4×2 warps of 4×8 lanes
constexpr int TN = 64;             // update: output tile columns
constexpr int KC = 16;             // update: panel depth per stage
constexpr int STAGES = 3;

template <typename T> __host__ __device__ constexpr int tm() { return sizeof(T) <= 8 ? 128 : 64; }
// The default tile width: 64, and 128 for 4- and 8-byte types from k=4608
// (ops/kernels.CHOL_WIDE_MIN_K), where the deeper update outweighs the
// diagonal factor it cannot fuse (chip_smoke.py phase 3 times both;
// PERF.md)
constexpr int NB_WIDE_MIN_K = 4608;
constexpr int default_nb(int k, int size) { return size <= 8 && k >= NB_WIDE_MIN_K ? 128 : 64; }
__host__ __device__ constexpr int stage_elems(int nb) {
  return CHUNK * (nb + 1) > nb * (CHUNK + 1) ? CHUNK * (nb + 1) : nb * (CHUNK + 1);
}

// scratch per matrix, in elements of T: PT [NB][k], LT [NB][NB], then the
// rsqrt pivots and the clamped reciprocals, NB reals each
__host__ __device__ inline long long scratch_elems(int k, int nb) {
  return (long long)nb * k + nb * nb + 2 * nb;
}

template <typename T> size_t diag_smem(int nb) {
  return (size_t)nb * (nb + 1) * sizeof(T) + nb * sizeof(typename Scalar<T>::real);
}
template <typename T> size_t panel_smem(int nb) {
  return ((size_t)nb * nb + stage_elems(nb)) * sizeof(T) + nb * sizeof(typename Scalar<T>::real);
}
template <typename T> size_t update_smem() { return (size_t)STAGES * KC * (tm<T>() + TN) * sizeof(T); }
// At nb = TN the update's tile at the next diagonal holds that tile whole,
// and where the factor fits the update's shared memory the block that
// computes it factors it too: one launch less per tile column.
template <typename T> bool fuses_diag(int nb) { return nb == TN && diag_smem<T>(nb) <= update_smem<T>(); }
template <typename T> size_t smem(int nb) {
  size_t m = diag_smem<T>(nb);
  if (panel_smem<T>(nb) > m) m = panel_smem<T>(nb);
  if (update_smem<T>() > m) m = update_smem<T>();
  return m;
}

// The update's output tiles lie in the lower trapezoid below tile column j,
// row by row: tile row a spans rows r0 + a·TM… and columns 0…min(r0 +
// (a+1)·TM, k).
inline int row_tiles(int k, int r0, int tm_) { return (k - r0 + tm_ - 1) / tm_; }
__host__ __device__ inline int tiles_in_row(int k, int r0, int tm_, int a) {
  const int end = r0 + (a + 1) * tm_ < k ? r0 + (a + 1) * tm_ : k;
  return (end + TN - 1) / TN;
}

template <typename T> struct __align__(16) Vec16 { T e[16 / sizeof(T)]; };

// one element global → shared, asynchronously; zero-filled when !pred
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(BYTES),
                 "r"(n));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float minus(float a, float b) { return a - b; }
__device__ __forceinline__ double minus(double a, double b) { return a - b; }
__device__ __forceinline__ float2 minus(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ double2 minus(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float plus(float a, float b) { return a + b; }
__device__ __forceinline__ double plus(double a, double b) { return a + b; }
__device__ __forceinline__ float2 plus(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 plus(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }

}  // namespace tiled

// Substitution through L_jj of NV vectors at once by one warp, element
// t = lane + 32q of vector i in v[i][q], with L_jj[t][c] at lt[c·cs + t·ts]
// in shared memory: right-looking, step c finalises element c as
// y = v_c·sc[c] and takes y's share out of every later element. CONJ: a
// panel row, v_t −= y·conj(L[t][c]) with sc the rsqrt pivots (panel_solve's
// formula); else a column of W, v_t −= L[t][c]·y with sc the clamped
// reciprocals (column_solve's). Elements at or before c take a zero factor
// instead of a branch (y is finite: the pivots are clamped).
template <bool CONJ, int NB, int NV, typename T>
__device__ __forceinline__ void tiled_substitute(T (&v)[NV][NB / 32], const T* lt, int cs, int ts,
                                                 const typename Scalar<T>::real* sc) {
  using S = Scalar<T>;
  constexpr int NQ = NB / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int cq = 0; cq < NQ; ++cq) {
#pragma unroll 4
    for (int cl = 0; cl < 32; ++cl) {
      const int c = cq * 32 + cl;
      const auto s = sc[c];
      T y[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        y[i] = S::shfl(S::scale(v[i][cq], s), cl);
        v[i][cq] = lane == cl ? y[i] : v[i][cq];
      }
#pragma unroll
      for (int q = cq; q < NQ; ++q) {
        const int t = lane + 32 * q;
        const T lq = t > c ? lt[c * cs + t * ts] : S::zero();
#pragma unroll
        for (int i = 0; i < NV; ++i)
          v[i][q] = CONJ ? S::mul_sub_conj(v[i][q], y[i], lq) : S::mul_sub(v[i][q], lq, y[i]);
      }
    }
  }
}

// In-place Cholesky of the nb×nb lower triangle at `a` (row stride lda, nb
// a multiple of 32) in shared memory, by the whole block, in 32-wide
// column blocks: warp 0 factors the 32×32 diagonal block left-looking (lane
// = row, a column per round, four partial sums; the pivot max(Re a_cc,
// tiny) and the column scaled by its rsqrt, as smem_chol), each warp solves
// four rows below it at a time by substitution (tiled_substitute), and the
// rest of the lower triangle takes their rank-32 product, 4×4 outputs a
// thread. (A round of smem_chol waits on its own shared-memory writes, so
// its nb rounds are nb round trips through shared memory.) rs[c] receives
// each column's rsqrt pivot. Ends with a barrier.
template <typename T>
__device__ void smem_chol_tiled(T* a, int nb, int lda, typename Scalar<T>::real tiny,
                                typename Scalar<T>::real* rs) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int c0 = 0; c0 < nb; c0 += 32) {
    T* d = a + c0 * lda + c0;
    if (warp == 0) {
      for (int c = 0; c < 32; ++c) {
        T acc[4] = {d[lane * lda + c], S::zero(), S::zero(), S::zero()};
        int m = 0;
        for (; m + 4 <= c; m += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc[u] = S::mul_sub_conj(acc[u], d[lane * lda + m + u], d[c * lda + m + u]);
        }
        for (; m < c; ++m) acc[0] = S::mul_sub_conj(acc[0], d[lane * lda + m], d[c * lda + m]);
        const T sum = tiled::plus(tiled::plus(acc[0], acc[1]), tiled::plus(acc[2], acc[3]));
        const R r = krsqrt(clamped(kshfl(S::re(sum), c), tiny));
        if (lane >= c) d[lane * lda + c] = S::scale(sum, r);
        if (lane == 0) rs[c0 + c] = r;
        __syncwarp();
      }
    }
    __syncthreads();
    for (int r0 = c0 + 32 + 4 * warp; r0 < nb; r0 += 4 * nwarps) {
      T v[4][1];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i][0] = r0 + i < nb ? a[(r0 + i) * lda + c0 + lane] : S::zero();
      tiled_substitute<true, 32>(v, d, 1, lda, rs + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (r0 + i < nb) a[(r0 + i) * lda + c0 + lane] = v[i][0];
    }
    __syncthreads();
    const int m0 = c0 + 32, nblk = (nb - m0) / 4;
    for (int t = threadIdx.x; t < nblk * (nblk + 1) / 2; t += blockDim.x) {
      int bi = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
      while (bi * (bi + 1) / 2 > t) --bi;
      const int r0 = m0 + 4 * bi, q0 = m0 + 4 * (t - bi * (bi + 1) / 2);
      T acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = a[(r0 + i) * lda + q0 + q];
#pragma unroll 4
      for (int c = c0; c < c0 + 32; ++c) {
        T x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = a[(r0 + i) * lda + c];
          y[i] = a[(q0 + i) * lda + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = S::mul_sub_conj(acc[i][q], x[i], y[q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q0 + q <= r0 + i) a[(r0 + i) * lda + q0 + q] = acc[i][q];
    }
    __syncthreads();
  }
}

// The diagonal tile at rows and columns r0… (nb×nb, lower triangle, row
// stride nb+1, in shared memory `a`, with nb reals for the pivots after
// it) factored, L_jj written to `l` with zeros above its diagonal (inside
// the matrix), its transpose LT and the scales to the scratch `lt`.
template <typename T>
__device__ void tiled_diag_factor(T* a, T* l, T* lt, int k, int nb, int r0,
                                  typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  const int lda = nb + 1;
  R* rs = reinterpret_cast<R*>(a + nb * lda);
  R* rs_g = reinterpret_cast<R*>(lt + nb * nb);
  smem_chol_tiled(a, nb, lda, tiny, rs);
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e - r * nb;
    if (r0 + r < k && r0 + c < k) l[(long long)(r0 + r) * k + r0 + c] = c <= r ? a[r * lda + c] : S::zero();
    // LT[c][r] = L[r][c], r fastest
    lt[e] = c >= r ? a[c * lda + r] : S::zero();
  }
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    rs_g[t] = rs[t];
    rs_g[nb + t] = R(1) / clamped(S::re(a[t * lda + t]), tiny);
  }
}

// L_jj of tile column j: A_jj's lower triangle from `src` (G for j = 0, L
// after), the identity outside the matrix (a ragged last tile), factored in
// shared memory (tiled_diag_factor).
template <typename T>
__global__ void __launch_bounds__(tiled::D_THREADS)
chol_inv_tiled_diag(const T* src_all, T* l_all, T* scr_all, int k, int nb, int j,
                    typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = nb + 1, r0 = j * nb;
  T* a = reinterpret_cast<T*>(smem_raw);
  const long long off = (long long)blockIdx.y * k * k;
  const T* src = src_all + off;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e - r * nb;
    if (c <= r)
      a[r * lda + c] = r0 + r < k ? src[(long long)(r0 + r) * k + r0 + c]
                                  : (c == r ? S::from_real(R(1)) : S::zero());
  }
  __syncthreads();
  tiled_diag_factor(a, l_all + off, scr_all + blockIdx.y * tiled::scratch_elems(k, nb) + (long long)nb * k,
                    k, nb, r0, tiny);
}

// Tile column j's panel (blocks below n_row_blocks: 64 rows of L_ij each)
// and W's row block j (the other blocks: 64 columns each).
template <typename T, int NB>
__global__ void __launch_bounds__(tiled::P_THREADS)
chol_inv_tiled_panel(const T* src_all, T* l_all, T* w_all, T* scr_all, int k, int j,
                     int n_row_blocks) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  using namespace tiled;
  constexpr int NQ = NB / 32, NV = P_VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* lt = reinterpret_cast<T*>(smem_raw);
  T* stage = lt + NB * NB;
  R* sc = reinterpret_cast<R*>(stage + stage_elems(NB));
  const long long off = (long long)blockIdx.y * k * k;
  const T* src = src_all + off;
  T* l = l_all + off;
  T* w = w_all + off;
  T* pt = scr_all + blockIdx.y * scratch_elems(k, NB);
  const T* lt_g = pt + (long long)NB * k;
  const R* rs_g = reinterpret_cast<const R*>(lt_g + NB * NB);
  const bool rows = blockIdx.x < n_row_blocks;
  for (int e = threadIdx.x; e < NB * NB; e += blockDim.x) lt[e] = lt_g[e];
  for (int t = threadIdx.x; t < NB; t += blockDim.x) sc[t] = rs_g[rows ? t : NB + t];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, c0 = j * NB;
  T v[NV][NQ];

  if (rows) {  // L_ij = A_ij·L_jj^{-†}, rows i0…i0+63
    const int i0 = (j + 1) * NB + blockIdx.x * CHUNK;
    // row block j right of its diagonal tile, above these rows: zeros
    for (int e = threadIdx.x; e < NB * CHUNK; e += blockDim.x) {
      const int r = e / CHUNK, gc = i0 + e % CHUNK;
      if (gc < k) {
        l[(long long)(c0 + r) * k + gc] = S::zero();
        w[(long long)(c0 + r) * k + gc] = S::zero();
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int gr = i0 + warp * NV + i;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        v[i][q] = gr < k ? src[(long long)gr * k + c0 + lane + 32 * q] : S::zero();
    }
    __syncthreads();
    tiled_substitute<true, NB>(v, lt, NB, 1, sc);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int r = warp * NV + i, gr = i0 + r;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (gr < k) l[(long long)gr * k + c0 + lane + 32 * q] = v[i][q];
        stage[r * (NB + 1) + lane + 32 * q] = v[i][q];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < NB * CHUNK; e += blockDim.x) {
      const int t = e / CHUNK, r = e % CHUNK;
      if (i0 + r < k) pt[(long long)t * k + i0 + r] = stage[r * (NB + 1) + t];
    }
    return;
  }

  // W_jc = L_jj^{-1}·X_jc, columns cw…cw+63 of W's row block j
  const int cw = (blockIdx.x - n_row_blocks) * CHUNK;
  const int ncols = (j + 1) * NB < k ? (j + 1) * NB : k;
  for (int e = threadIdx.x; e < NB * CHUNK; e += blockDim.x) {
    const int t = e / CHUNK, c = e % CHUNK, gr = c0 + t, gc = cw + c;
    T x = S::zero();
    if (gr < k && gc < ncols)
      x = gc >= c0 ? (gc == gr ? S::from_real(R(1)) : S::zero()) : w[(long long)gr * k + gc];
    stage[t * (CHUNK + 1) + c] = x;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) v[i][q] = stage[(lane + 32 * q) * (CHUNK + 1) + warp * NV + i];
  tiled_substitute<false, NB>(v, lt, NB, 1, sc);
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) stage[(lane + 32 * q) * (CHUNK + 1) + warp * NV + i] = v[i][q];
  __syncthreads();
  for (int e = threadIdx.x; e < NB * CHUNK; e += blockDim.x) {
    const int t = e / CHUNK, c = e % CHUNK, gr = c0 + t, gc = cw + c;
    if (gr < k && gc < ncols) w[(long long)gr * k + gc] = gc > gr ? S::zero() : stage[t * (CHUNK + 1) + c];
  }
}

// acc[r][s] += Σ_t A[r][t]·op(B[t][s]) over the panel depth nb, with A^T
// (a_src[t·ld + r], r < a_rows) and B (b_src[t·ld + s], s < b_cols; zeros
// past either) staged slice by slice; op = conj when CONJ. Thread (warp w,
// lane = 8·ty + tx) owns rows (w/2)·TM/4 + ty·RM + (0…RM−1) and columns
// (w%2)·32 + (8h + tx)·VN + (0…VN−1), h < 4/VN: a slice costs it RM/VN +
// 4/VN 16-byte shared loads for 4·RM multiply-adds, free of bank conflicts
// (a quarter-warp shares its A row and reads 128 contiguous bytes of B).
template <bool CONJ, typename T>
__device__ __forceinline__ void tiled_gemm(T (&acc)[tiled::tm<T>() / 16][4], T* as, T* bs,
                                           const T* a_src, const T* b_src, int a_rows, int b_cols,
                                           int nb, int ld) {
  using namespace tiled;
  using S = Scalar<T>;
  constexpr int TM = tm<T>(), RM = TM / 16, RN = 4, VN = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ty = lane >> 3, tx = lane & 7;
  const int row0 = (warp >> 1) * (TM / 4) + ty * RM, col0 = (warp & 1) * 32 + tx * VN;

  // this thread's element of each slice row it copies: A^T row t = tid/TM
  // + u·(U_THREADS/TM), element tid%TM; B likewise with TN
  const bool a_ok = threadIdx.x % TM < a_rows, b_ok = threadIdx.x % TN < b_cols;
  const T* a_th = a_ok ? a_src + (long long)(threadIdx.x / TM) * ld + threadIdx.x % TM : a_src;
  const T* b_th = b_ok ? b_src + (long long)(threadIdx.x / TN) * ld + threadIdx.x % TN : b_src;
  const long long a_step = a_ok ? (long long)(U_THREADS / TM) * ld : 0;
  const long long b_step = b_ok ? (long long)(U_THREADS / TN) * ld : 0;
  auto load = [&](int slot, int chunk) {
    T* a_dst = as + slot * KC * TM + threadIdx.x;
    T* b_dst = bs + slot * KC * TN + threadIdx.x;
    const T* a_at = a_th + (a_ok ? (long long)chunk * KC * ld : 0);
    const T* b_at = b_th + (b_ok ? (long long)chunk * KC * ld : 0);
#pragma unroll
    for (int u = 0; u < KC * TM / U_THREADS; ++u)
      cp_async<sizeof(T)>(a_dst + u * U_THREADS, a_at + u * a_step, a_ok);
#pragma unroll
    for (int u = 0; u < KC * TN / U_THREADS; ++u)
      cp_async<sizeof(T)>(b_dst + u * U_THREADS, b_at + u * b_step, b_ok);
  };

  const int nch = nb / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nch) load(s, s);
    cp_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (ch + STAGES - 1 < nch) load((ch + STAGES - 1) % STAGES, ch + STAGES - 1);
    cp_commit();
    const T* a_st = as + (ch % STAGES) * KC * TM + row0;
    const T* b_st = bs + (ch % STAGES) * KC * TN + col0;
#pragma unroll 2
    for (int t = 0; t < KC; ++t) {
      T av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM / VN; ++i) {
        const Vec16<T> x = reinterpret_cast<const Vec16<T>*>(a_st + t * TM)[i];
#pragma unroll
        for (int e = 0; e < VN; ++e) av[i * VN + e] = x.e[e];
      }
#pragma unroll
      for (int h = 0; h < RN / VN; ++h) {
        const Vec16<T> x = *reinterpret_cast<const Vec16<T>*>(b_st + t * TN + h * 8 * VN);
#pragma unroll
        for (int e = 0; e < VN; ++e) bv[h * VN + e] = x.e[e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < RN; ++c)
          acc[i][c] = CONJ ? S::mul_add_conj(acc[i][c], av[i], bv[c]) : S::mul_add(acc[i][c], av[i], bv[c]);
    }
  }
  cp_wait<0>();
}

// One output tile of tile column j's update.
template <typename T>
__global__ void __launch_bounds__(tiled::U_THREADS, 2)
chol_inv_tiled_update(const T* src_all, T* l_all, T* w_all, T* scr_all, int k, int nb, int j,
                      bool fuse_diag, typename Scalar<T>::real tiny) {
  using namespace tiled;
  using S = Scalar<T>;
  constexpr int TM = tm<T>(), RM = TM / 16, RN = 4, VN = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* as = reinterpret_cast<T*>(smem_raw);
  T* bs = as + STAGES * KC * TM;
  const long long off = (long long)blockIdx.y * k * k;
  const T* src = src_all + off;
  T* l = l_all + off;
  T* w = w_all + off;
  const T* pt = scr_all + blockIdx.y * scratch_elems(k, nb);

  const int r0 = (j + 1) * nb;
  int tile = blockIdx.x, a = 0;
  for (int n; tile >= (n = tiles_in_row(k, r0, TM, a)); ++a) tile -= n;
  const int gr0 = r0 + a * TM, gc0 = tile * TN;
  const bool trailing = gc0 >= r0;

  T acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < RN; ++c) acc[i][c] = S::zero();
  // A^T = PT[·][gr0…]; B = conj(PT[·][gc0…]) (trailing) or W[jNB + ·][gc0…]
  if (trailing)
    tiled_gemm<true>(acc, as, bs, pt + gr0, pt + gc0, k - gr0, k - gc0, nb, k);
  else
    tiled_gemm<false>(acc, as, bs, pt + gr0, w + (long long)j * nb * k + gc0, k - gr0, TN, nb, k);

  // C −= acc: the trailing part of L's lower triangle (read from G at
  // j = 0), or X in W (zero before this launch in tile column j's columns)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ty = lane >> 3, tx = lane & 7;
  const int row0 = (warp >> 1) * (TM / 4) + ty * RM, col0 = (warp & 1) * 32 + tx * VN;
  const T* old = trailing ? src : w;
  T* out = trailing ? l : w;
  const bool has_old = trailing || gc0 < j * nb;
  // with fuse_diag (nb = TN), the tile at (r0, r0) holds the next diagonal
  // tile whole: this block also factors it, from its own outputs
  const bool diag = fuse_diag && gr0 == r0 && gc0 == r0;
  const int lda = nb + 1;
  T* d = reinterpret_cast<T*>(smem_raw);
  if (diag) __syncthreads();  // the stages are free
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = gr0 + row0 + i;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int gc = gc0 + col0 + (c / VN) * 8 * VN + c % VN;
      if (gr >= k || (trailing && (gc > gr || gc >= k))) continue;
      const long long at = (long long)gr * k + gc;
      const T x = tiled::minus(has_old ? old[at] : S::zero(), acc[i][c]);
      out[at] = x;
      if (diag && gr < r0 + nb) d[(gr - r0) * lda + gc - r0] = x;
    }
  }
  if (!diag) return;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {  // the identity past k
    const int r = e / nb, c = e - r * nb;
    if (r0 + r >= k && c <= r) d[r * lda + c] = c == r ? S::from_real(typename Scalar<T>::real(1)) : S::zero();
  }
  __syncthreads();
  tiled_diag_factor(d, l, scr_all + blockIdx.y * scratch_elems(k, nb) + (long long)nb * k, k, nb, r0, tiny);
}

template <typename T, int NB>
int launch_tiled_nb(const T* g, T* scratch, T* l, T* w, int k, int batch, double tiny,
                    cudaStream_t stream) {
  using namespace tiled;
  using R = typename Scalar<T>::real;
  const size_t sd = diag_smem<T>(NB), sp = panel_smem<T>(NB), su = update_smem<T>();
  if (smem<T>(NB) > (size_t)KPBP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if ((sd > 48 * 1024 && (err = kpbp_allow_smem(chol_inv_tiled_diag<T>)) != cudaSuccess) ||
      (sp > 48 * 1024 && (err = kpbp_allow_smem(chol_inv_tiled_panel<T, NB>)) != cudaSuccess) ||
      (su > 48 * 1024 && (err = kpbp_allow_smem(chol_inv_tiled_update<T>)) != cudaSuccess))
    return (int)err;
  const int nt = (k + NB - 1) / NB;
  const bool fuse = fuses_diag<T>(NB);
  for (int j = 0; j < nt; ++j) {
    const T* src = j == 0 ? g : l;
    if (j == 0 || !fuse) {
      chol_inv_tiled_diag<T><<<dim3(1, batch), D_THREADS, sd, stream>>>(src, l, scratch, k, NB, j, (R)tiny);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const int r0 = (j + 1) * NB;
    const int n_rows = r0 < k ? (k - r0 + CHUNK - 1) / CHUNK : 0;
    const int n_cols = ((r0 < k ? r0 : k) + CHUNK - 1) / CHUNK;
    chol_inv_tiled_panel<T, NB><<<dim3(n_rows + n_cols, batch), P_THREADS, sp, stream>>>(
        src, l, w, scratch, k, j, n_rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (r0 >= k) break;
    int n_tiles = 0;
    for (int a = 0; a < row_tiles(k, r0, tm<T>()); ++a) n_tiles += tiles_in_row(k, r0, tm<T>(), a);
    chol_inv_tiled_update<T><<<dim3(n_tiles, batch), U_THREADS, su, stream>>>(src, l, w, scratch, k,
                                                                              NB, j, fuse, (R)tiny);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

// nb: the tile width, 64 or (for 4- and 8-byte types) 128
template <typename T>
int launch_tiled(const void* g, void* scratch, void* l, void* w, int k, int batch, int nb,
                 double tiny, cudaStream_t stream) {
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const T* gt = static_cast<const T*>(g);
  T* st = static_cast<T*>(scratch);
  T* lt = static_cast<T*>(l);
  T* wt = static_cast<T*>(w);
  if (nb == 64) return launch_tiled_nb<T, 64>(gt, st, lt, wt, k, batch, tiny, stream);
  if constexpr (sizeof(T) <= 8) {
    if (nb == 128) return launch_tiled_nb<T, 128>(gt, st, lt, wt, k, batch, tiny, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

int chol_inv_tiled_default_nb(int k, int size) { return tiled::default_nb(k, size); }

int chol_inv_tiled(const void* g, void* scratch, void* l, void* w, int k, int batch, int dtype,
                   int nb, double tiny, cudaStream_t stream) {
#define KPBP_LAUNCH(T) return launch_tiled<T>(g, scratch, l, w, k, batch, nb, tiny, stream)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

long long chol_inv_tiled_smem(int dtype, int nb) {
#define KPBP_LAUNCH(T) return (long long)tiled::smem<T>(nb)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return -1;
}

long long chol_inv_tiled_launches(int k, int dtype, int nb) {
  const int nt = (k + nb - 1) / nb;
#define KPBP_LAUNCH(T) return tiled::fuses_diag<T>(nb) ? 2 * nt : 3 * nt - 1
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return -1;
}

