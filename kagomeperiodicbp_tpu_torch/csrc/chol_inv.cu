// K2 · chol_inv: Cholesky factor and its inverse of a Hermitian PSD matrix.
//
// Replaces: kagomeperiodicbp_tpu/ops/pallas_kernels.py · chol_inv_pallas
// (kernel _chol_inv_kernel), the small-matrix half of CholeskyQR2
// (ops/linalg._cholqr_once).
//
//   G = L·L†  (L lower triangular),   W = L⁻¹
//
// G is the shifted gram A†A + u·tr(G)·I, so it is positive definite; as in
// the Pallas kernel every pivot is clamped as max(Re g_jj, tiny) and every
// diagonal divisor of the inverse as max(Re l_jj, tiny) (tiny = 1e-300 in
// double, 1e-30 in float), so rank-deficient padded bonds behave as they do
// there. Only the lower triangle of G is read; L and W come back lower
// triangular with zeros above the diagonal.
//
// What bounds it on this card: up to k ≈ 1000, latency, not arithmetic or
// bytes. At k=324 in complex128 the whole job is ~91 MFLOP and ~5 MB (a few
// µs at the card's peaks), but the k columns of the factor, and the k rows
// of the inverse, depend on each other in order. One SM alone would need
// ~0.4 ms for those flops even at its full FP64 rate, so large k must
// spread each dependent phase over many SMs; small k must keep every round
// on chip. At the D=6–8 grams (k = 2952…8832) the 8k³/3 flops bound it:
// 27.4 ms at k=8832 in complex64 on the CUDA cores' FP32 rate.
//
// What the design does about it — three variants, chosen per call by
// ops/kernels.chol_inv_plan from k (the switches are measured on the card):
//
// (a) resident, for small k (and at most the k whose k×(k|1) matrix fits
//     one block's 227 KB of shared memory): one block per matrix
//     (blockIdx.x is the matrix), the matrix read once into shared memory,
//     factored in place column by column (smem_chol), L written out, then
//     inverted in place row by row (smem_trtri) and W written out. One
//     barrier per column and per row.
//
// (b) blocked, for larger k: a right-looking blocked Cholesky with NB-wide
//     tiles, fused with a right-looking blocked forward substitution for W,
//     as one launch per tile column j (nt = ceil(k/NB) launches, enqueued
//     back to back on the caller's stream; the stream orders them). Launch
//     j runs one block per task, all independent:
//       trailing  (i, m), j < m ≤ i:  A_im −= L_ij·L_mj†
//       inverse   (i, c), c ≤ j < i:  X_ic −= L_ij·W_jc
//       output    (·, c):             row j of L and W, column j of L
//     Every block first factors the diagonal tile A_jj itself, in
//     registers (tile_chol: one barrier per column, the same NB rounds on
//     every SM at once), then forms the panel tiles it needs by
//     substitution in registers — L_ij = A_ij·L_jj^{-†} (panel_solve) and
//     W_jc = L_jj^{-1}·X_jc (column_solve), eight lanes of one warp per row
//     or column, synchronised by shuffles — and ends with one tile product.
//     X (the right-hand side of L·W = I, updated in place) and the trailing
//     matrix live in a scratch of 2·k² elements that the wrapper allocates;
//     launch 0 reads G itself. The clamp acts inside every diagonal tile.
//     At k=504 that is 16 launches of up to ~150 blocks each.
//
// (c) tiled, for the large grams: 64- or 128-wide tile columns, the
//     diagonal tile factored once, the panel solved once, and one
//     register-tiled complex GEMM per tile column for both updates; in
//     chol_inv_tiled.cu (a source of its own, so the two compile side by
//     side), reached through chol_inv_tiled.cuh.
//
// Complex values stay interleaved (float2/double2) and double precision is
// native, so complex128 runs in double (the TPU kernel was float32 planes
// only). The 128-padding of the Pallas version was the TPU's tile size and
// is gone; a ragged edge tile reads as the identity outside the matrix.
#include "chol_inv_tiled.cuh"
#include "common.cuh"

namespace {

constexpr int NB = 32;              // blocked: tile width
constexpr int NB_LD = NB + 1;       // odd row stride: conflict-free column reads
constexpr int BLOCKED_THREADS = 256;
constexpr int PER_THREAD = NB * NB / BLOCKED_THREADS;  // tile outputs per thread
constexpr int COLS_STEP = NB / PER_THREAD;             // thread t: row t/COLS_STEP
static_assert(NB * NB % BLOCKED_THREADS == 0, "tile outputs must split evenly");

enum Variant { RESIDENT = 0, BLOCKED = 1, TILED = 2 };

// In-place Cholesky of the n×n lower triangle at `a` (row stride lda) in
// shared memory, by the whole block. Right-looking, one column per round,
// warps over rows and lanes over columns. Column j is scaled lazily: round
// j reads it unscaled and multiplies by rsqrt(pivot) on the fly, and round
// j+1 writes it back scaled, so a round needs one barrier. Reads and writes
// only the lower triangle. Ends with a barrier.
template <typename T>
__device__ void smem_chol(T* a, int n, int lda, typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  R prev = R(0);
  for (int j = 0; j < n; ++j) {
    const R rs = krsqrt(clamped(S::re(a[j * lda + j]), tiny));
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const T lij = S::scale(a[i * lda + j], rs);
      for (int m = j + 1 + lane; m <= i; m += 32)
        a[i * lda + m] = S::mul_sub_conj(a[i * lda + m], lij, S::scale(a[m * lda + j], rs));
    }
    if (j > 0)  // column j-1: nobody reads it in this round
      for (int i = j - 1 + threadIdx.x; i < n; i += blockDim.x)
        a[i * lda + j - 1] = S::scale(a[i * lda + j - 1], prev);
    prev = rs;
    __syncthreads();
  }
  if (threadIdx.x == 0 && n > 0) a[(n - 1) * lda + n - 1] = S::scale(a[(n - 1) * lda + n - 1], prev);
  __syncthreads();
}

// In-place inverse of the lower-triangular L at `a` (as smem_chol leaves
// it): W = L⁻¹ by forward substitution L·W = I on all columns at once,
// right-looking. After round i, row i of X is final and W[i][c] =
// X[i][c]/max(Re L_ii, tiny); the rows below take X[r][c] −= L[r][i]·W[i][c]
// (c ≤ i) in the places where L's consumed columns were. Row i is scaled
// lazily, as in smem_chol, so a round needs one barrier. Ends with a barrier.
template <typename T>
__device__ void smem_trtri(T* a, int n, int lda, typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  R prev = R(0);
  for (int i = 0; i < n; ++i) {
    const R inv = R(1) / clamped(S::re(a[i * lda + i]), tiny);
    for (int r = i + 1 + warp; r < n; r += nwarps) {
      const T lri = a[r * lda + i];
      __syncwarp();  // lane c == i overwrites L[r][i] below
      for (int c = lane; c <= i; c += 32) {
        const T wic = c == i ? S::from_real(inv) : S::scale(a[i * lda + c], inv);
        a[r * lda + c] = S::mul_sub(c == i ? S::zero() : a[r * lda + c], lri, wic);
      }
    }
    if (i > 0)  // row i-1: nobody reads it in this round
      for (int c = threadIdx.x; c < i; c += blockDim.x)
        a[(i - 1) * lda + c] = c == i - 1 ? S::from_real(prev) : S::scale(a[(i - 1) * lda + c], prev);
    prev = inv;
    __syncthreads();
  }
  for (int c = threadIdx.x; c < n; c += blockDim.x)
    a[(n - 1) * lda + c] = c == n - 1 ? S::from_real(prev) : S::scale(a[(n - 1) * lda + c], prev);
  __syncthreads();
}

// ------------------------------ (a) resident -------------------------------

template <typename T>
__global__ void __launch_bounds__(512)
chol_inv_resident(const T* __restrict__ g_all, T* __restrict__ l_all, T* __restrict__ w_all,
                  int k, typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a = reinterpret_cast<T*>(smem_raw);
  const int lda = k | 1;
  const long long off = (long long)blockIdx.x * k * k;
  const T* g = g_all + off;
  T* l = l_all + off;
  T* w = w_all + off;
  const int kk = k * k;

  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const int i = e / k, m = e - i * k;
    if (m <= i) a[i * lda + m] = g[e];
  }
  __syncthreads();
  smem_chol(a, k, lda, tiny);
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const int i = e / k, m = e - i * k;
    l[e] = m <= i ? a[i * lda + m] : S::zero();
  }
  __syncthreads();
  smem_trtri(a, k, lda, tiny);
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const int i = e / k, m = e - i * k;
    w[e] = m <= i ? a[i * lda + m] : S::zero();
  }
}

// ------------------------------ (b) blocked --------------------------------
//
// Thread t of a tile owns four elements: in the row layout, row t/8 and
// columns t%8 + 8q; in the column layout, column t/8 and rows t%8 + 8q
// (q = 0..3). Either way the eight lanes that share a row (or column) sit
// in one warp, so a substitution along it needs shuffles, not barriers.

// Off-diagonal tile (ti, tc) of the row-major k×k matrix `m` into shared
// memory, zeros outside the matrix.
template <typename T>
__device__ void load_tile(T* dst, const T* m, int k, int ti, int tc) {
  for (int e = threadIdx.x; e < NB * NB; e += blockDim.x) {
    const int r = e / NB, c = e % NB, gr = ti * NB + r, gc = tc * NB + c;
    dst[r * NB_LD + c] = (gr < k && gc < k) ? m[(long long)gr * k + gc] : Scalar<T>::zero();
  }
}

// Zeros to tile (ti, tc) of `m`, inside the matrix.
template <typename T>
__device__ void zero_tile(T* m, int k, int ti, int tc) {
  for (int e = threadIdx.x; e < NB * NB; e += blockDim.x) {
    const int gr = ti * NB + e / NB, gc = tc * NB + e % NB;
    if (gr < k && gc < k) m[(long long)gr * k + gc] = Scalar<T>::zero();
  }
}

__device__ __forceinline__ int own_major() { return threadIdx.x / COLS_STEP; }
__device__ __forceinline__ int own_minor(int q) { return threadIdx.x % COLS_STEP + COLS_STEP * q; }

// The thread's four elements of shared tile `t`, row layout (COL = false)
// or column layout (COL = true), to and from registers.
template <bool COL, typename T>
__device__ __forceinline__ void get_own(T (&v)[PER_THREAD], const T* t) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q)
    v[q] = COL ? t[own_minor(q) * NB_LD + own_major()] : t[own_major() * NB_LD + own_minor(q)];
}

template <bool COL, typename T>
__device__ __forceinline__ void put_own(T* t, const T (&v)[PER_THREAD]) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q)
    (COL ? t[own_minor(q) * NB_LD + own_major()] : t[own_major() * NB_LD + own_minor(q)]) = v[q];
}

// The thread's four elements of tile (ti, tc) of global `m`, row or column
// layout, inside the matrix; `lower` reads zeros above the tile's diagonal.
template <bool COL, typename T>
__device__ void load_own(T (&v)[PER_THREAD], const T* m, int k, int ti, int tc, bool lower) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = COL ? own_minor(q) : own_major(), c = COL ? own_major() : own_minor(q);
    const int gr = ti * NB + r, gc = tc * NB + c;
    v[q] = (gr < k && gc < k && (!lower || c <= r)) ? m[(long long)gr * k + gc] : Scalar<T>::zero();
  }
}

template <bool COL, typename T>
__device__ void store_own(T* m, const T (&v)[PER_THREAD], int k, int ti, int tc, bool lower) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int r = COL ? own_minor(q) : own_major(), c = COL ? own_major() : own_minor(q);
    const int gr = ti * NB + r, gc = tc * NB + c;
    if (gr < k && gc < k) m[(long long)gr * k + gc] = (!lower || c <= r) ? v[q] : Scalar<T>::zero();
  }
}

// acc[q] −= Σ_t A[r][t]·op(B)[t][c] over the thread's row-layout elements,
// op(B)[t][c] = conj(B[c][t]) when ADJ, else B[t][c]; tiles in shared memory.
template <bool ADJ, typename T>
__device__ __forceinline__ void tile_fms(T (&acc)[PER_THREAD], const T* a, const T* b) {
  using S = Scalar<T>;
  const int r = own_major();
#pragma unroll 4
  for (int t = 0; t < NB; ++t) {
    const T x = a[r * NB_LD + t];
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int c = own_minor(q);
      acc[q] = ADJ ? S::mul_sub_conj(acc[q], x, b[c * NB_LD + t]) : S::mul_sub(acc[q], x, b[t * NB_LD + c]);
    }
  }
}

// Cholesky of the diagonal tile held in registers (row layout, identity
// outside the matrix), one column per round: round j reads column j, which
// its owners published to shared memory (double-buffered `col`), updates
// the trailing elements, scales column j by rs_j = rsqrt(max(Re a_jj,
// tiny)) and publishes column j+1 — one barrier a round, and the same
// arithmetic, element by element, as smem_chol. Leaves L_jj in `v`, and
// rs_j in `rs` for the panel solves.
template <typename T>
__device__ void tile_chol(T (&v)[PER_THREAD], T* col, typename Scalar<T>::real* rs,
                          typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  const int r = own_major(), g = threadIdx.x % COLS_STEP;
  if (g == 0) col[r] = v[0];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const T* cj = col + (j & 1) * NB;
    const R rsj = krsqrt(clamped(S::re(cj[j]), tiny));
    if (threadIdx.x == 0) rs[j] = rsj;
    const T lr = S::scale(cj[r], rsj);
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q) {
      const int c = own_minor(q);
      if (j < c && c <= r) v[q] = S::mul_sub_conj(v[q], lr, S::scale(cj[c], rsj));
    }
    if (g == (j % COLS_STEP) && r >= j) v[j / COLS_STEP] = S::scale(v[j / COLS_STEP], rsj);
    if (j + 1 < NB && g == ((j + 1) % COLS_STEP)) col[((j + 1) & 1) * NB + r] = v[(j + 1) / COLS_STEP];
    __syncthreads();
  }
}

// X := A·L_jj^{-†} for the thread's row (row layout; v holds A's row):
// x_c = (a_c − Σ_{t<c} x_t·conj(L[c][t]))·rs_c, the column algorithm's own
// formula, by substitution along the row — backward stable, as LAPACK's
// trsm panel is. A product with an explicit inverse instead would carry
// cond(L_jj)-sized errors into the trailing matrix, and the shifted gram's
// pivots sit only u·tr(G) above zero.
template <typename T>
__device__ __forceinline__ void panel_solve(T (&v)[PER_THREAD], const T* l,
                                            const typename Scalar<T>::real* rs) {
  using S = Scalar<T>;
  const int g = threadIdx.x % COLS_STEP, base = (threadIdx.x & 31) & ~(COLS_STEP - 1);
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    const T y = S::shfl(S::scale(v[c / COLS_STEP], rs[c]), base | (c % COLS_STEP));
    if (g == c % COLS_STEP) v[c / COLS_STEP] = y;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      if (own_minor(q) > c) v[q] = S::mul_sub_conj(v[q], y, l[own_minor(q) * NB_LD + c]);
  }
}

// Y := L_jj^{-1}·X for the thread's column (column layout; v holds X's
// column): y_t = (x_t − Σ_{u<t} L[t][u]·y_u)/max(Re L_tt, tiny), forward
// substitution as in smem_trtri; dinv holds the clamped reciprocals.
template <typename T>
__device__ __forceinline__ void column_solve(T (&v)[PER_THREAD], const T* l,
                                             const typename Scalar<T>::real* dinv) {
  using S = Scalar<T>;
  const int g = threadIdx.x % COLS_STEP, base = (threadIdx.x & 31) & ~(COLS_STEP - 1);
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const T y = S::shfl(S::scale(v[t / COLS_STEP], dinv[t]), base | (t % COLS_STEP));
    if (g == t % COLS_STEP) v[t / COLS_STEP] = y;
#pragma unroll
    for (int q = 0; q < PER_THREAD; ++q)
      if (own_minor(q) > t) v[q] = S::mul_sub(v[q], l[own_minor(q) * NB_LD + t], y);
  }
}

// The thread's column of the identity tile (ti == tc; also outside the matrix).
template <typename T>
__device__ __forceinline__ void identity_own(T (&v)[PER_THREAD]) {
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q)
    v[q] = own_minor(q) == own_major() ? Scalar<T>::from_real(typename Scalar<T>::real(1))
                                       : Scalar<T>::zero();
}

// One tile column j of the blocked factorization and inverse; see the top
// of the file. src is G for j = 0 and the trailing scratch s after.
template <typename T>
__global__ void __launch_bounds__(BLOCKED_THREADS)
chol_inv_blocked_step(const T* __restrict__ g_all, T* s_all, T* x_all, T* __restrict__ l_all,
                      T* __restrict__ w_all, int k, int nt, int j,
                      typename Scalar<T>::real tiny) {
  using S = Scalar<T>;
  using R = typename Scalar<T>::real;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* dl = reinterpret_cast<T*>(smem_raw);  // L_jj
  T* p = dl + NB * NB_LD;
  T* q = p + NB * NB_LD;
  T* col = q + NB * NB_LD;  // [2][NB]
  R* rs = reinterpret_cast<R*>(col + 2 * NB);
  R* dinv = rs + NB;
  const long long off = (long long)blockIdx.y * k * k;
  const T* src = (j == 0 ? g_all : s_all) + off;
  T* s = s_all + off;
  T* x = x_all + off;
  T* l = l_all + off;
  T* w = w_all + off;

  // which task: trailing (i, m), inverse (i, c) or output column c
  const int below = nt - j - 1;
  const int n_trail = below * (below + 1) / 2;
  const int n_inv = below * (j + 1);
  int task = blockIdx.x, kind, ti = 0, tc;
  if (task < n_trail) {
    kind = 0;
    int row = 0;
    while (task > row) task -= ++row;  // row `row` of the triangle holds row+1 tiles
    ti = j + 1 + row;
    tc = j + 1 + task;
  } else if ((task -= n_trail) < n_inv) {
    kind = 1;
    ti = j + 1 + task / (j + 1);
    tc = task % (j + 1);
  } else {
    kind = 2;
    tc = task - n_inv;
  }

  // the panel tiles this task reads (their loads overlap the diagonal factor)
  if (kind == 0 || kind == 1 || tc > j) load_tile(p, src, k, kind == 2 ? tc : ti, j);
  if (kind == 0 && tc != ti) load_tile(q, src, k, tc, j);
  if ((kind == 1 || kind == 2) && tc < j) load_tile(q, x, k, j, tc);

  // every block: L_jj of the diagonal tile, in registers, then shared memory
  T v[PER_THREAD];
  load_own<false>(v, src, k, j, j, true);
  if (j == nt - 1) {  // a ragged last tile reads as the identity outside the matrix
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e)
      if (j * NB + own_major() >= k && own_minor(e) == own_major()) v[e] = S::from_real(R(1));
  }
  tile_chol(v, col, rs, tiny);
  put_own<false>(dl, v);
  if (kind == 2 && tc == j) store_own<false>(l, v, k, j, j, true);
  __syncthreads();
  if (threadIdx.x < NB) dinv[threadIdx.x] = R(1) / clamped(S::re(dl[threadIdx.x * NB_LD + threadIdx.x]), tiny);
  __syncthreads();

  T a[PER_THREAD], b[PER_THREAD];
  if (kind == 0) {  // A_im −= L_ij·L_mj†
    get_own<false>(a, p);
    panel_solve(a, dl, rs);
    put_own<false>(p, a);
    if (tc != ti) {
      get_own<false>(b, q);
      panel_solve(b, dl, rs);
      put_own<false>(q, b);
    }
    __syncthreads();
    load_own<false>(a, src, k, ti, tc, tc == ti);
    tile_fms<true>(a, p, tc == ti ? p : q);
    store_own<false>(s, a, k, ti, tc, false);
  } else if (kind == 1) {  // X_ic −= L_ij·W_jc, W_jc = L_jj^{-1}·X_jc (X_jj = I)
    get_own<false>(a, p);
    panel_solve(a, dl, rs);
    put_own<false>(p, a);
    if (tc < j) get_own<true>(b, q); else identity_own(b);
    column_solve(b, dl, dinv);
    put_own<true>(q, b);
    __syncthreads();
    if (tc < j) {
      load_own<false>(a, x, k, ti, tc, false);
    } else {
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) a[e] = S::zero();
    }
    tile_fms<false>(a, p, q);
    store_own<false>(x, a, k, ti, tc, false);
  } else if (tc <= j) {  // W_jc = L_jj^{-1}·X_jc
    if (tc < j) get_own<true>(b, q); else identity_own(b);
    column_solve(b, dl, dinv);
    store_own<true>(w, b, k, j, tc, tc == j);
  } else {  // L_cj = A_cj·L_jj^{-†}; zeros above the diagonal
    get_own<false>(a, p);
    panel_solve(a, dl, rs);
    store_own<false>(l, a, k, tc, j, false);
    zero_tile(l, k, j, tc);
    zero_tile(w, k, j, tc);
  }
}

int resident_threads(int k) { return k <= 32 ? 128 : 512; }

// A variant code's tile width at size k: blocked NB; tiled the width in
// bits 8 and up (0 there: the tiled variant's default), 64 or, for 4- and
// 8-byte types, 128; resident 0; -1 for a code no variant takes.
template <typename T>
int tile_of(int variant, int k) {
  if (variant == RESIDENT) return 0;
  if (variant == BLOCKED) return NB;
  if ((variant & 0xff) != TILED) return -1;
  const int nb = (variant >> 8) ? (variant >> 8) : chol_inv_tiled_default_nb(k, sizeof(T));
  return nb == 64 || (nb == 128 && sizeof(T) <= 8) ? nb : -1;
}

template <typename T>
long long smem_bytes(int k, int variant, int dtype) {
  const int nb = tile_of<T>(variant, k);
  if (nb < 0) return -1;
  if (variant == RESIDENT) return (long long)k * (k | 1) * sizeof(T);
  if (variant == BLOCKED)
    return (3 * NB * NB_LD + 2 * NB) * sizeof(T) + 2 * NB * sizeof(typename Scalar<T>::real);
  return chol_inv_tiled_smem(dtype, nb);
}

template <typename T>
long long launches(int k, int variant, int dtype) {
  const int nb = tile_of<T>(variant, k);
  if (nb <= 0) return nb < 0 ? -1 : 1;
  if (variant == BLOCKED) return (k + nb - 1) / nb;
  return chol_inv_tiled_launches(k, dtype, nb);
}

template <typename T>
long long scratch_elems(int k, int variant) {
  const int nb = tile_of<T>(variant, k);
  if (nb <= 0) return nb;
  return variant == BLOCKED ? 2LL * k * k : (long long)nb * k + nb * nb + 2 * nb;
}

template <typename T>
int launch_chol_inv(const void* g, void* scratch, void* l, void* w, int k, int batch,
                    int dtype, int variant, double tiny, cudaStream_t stream) {
  using R = typename Scalar<T>::real;
  const long long smem = smem_bytes<T>(k, variant, dtype);
  if (smem < 0 || smem > KPBP_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if ((variant & 0xff) == TILED)
    return chol_inv_tiled(g, scratch, l, w, k, batch, dtype, tile_of<T>(variant, k), tiny, stream);
  const T* gt = static_cast<const T*>(g);
  T* lt = static_cast<T*>(l);
  T* wt = static_cast<T*>(w);
  cudaError_t err;
  if (variant == RESIDENT) {
    if (smem > 48 * 1024 && (err = kpbp_allow_smem(chol_inv_resident<T>)) != cudaSuccess)
      return (int)err;
    chol_inv_resident<T><<<batch, resident_threads(k), smem, stream>>>(gt, lt, wt, k, (R)tiny);
    return (int)cudaGetLastError();
  }
  if (variant != BLOCKED || batch > 65535) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && (err = kpbp_allow_smem(chol_inv_blocked_step<T>)) != cudaSuccess)
    return (int)err;
  T* s = static_cast<T*>(scratch);
  T* x = s + (long long)batch * k * k;
  const int nt = (k + NB - 1) / NB;
  for (int j = 0; j < nt; ++j) {
    const int below = nt - j - 1;
    const dim3 grid(below * (below + 1) / 2 + below * (j + 1) + nt, batch);
    chol_inv_blocked_step<T><<<grid, BLOCKED_THREADS, smem, stream>>>(gt, s, x, lt, wt, k, nt, j,
                                                                      (R)tiny);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// g: contiguous [batch, k, k] Hermitian PSD (lower triangle read); l, w:
// contiguous [batch, k, k] of the same dtype, written. variant 0 (resident)
// needs no scratch; variant 1 (blocked) needs 2·batch·k² elements of it and
// batch ≤ 65535; variant 2 (tiled) batch·(NB·k + NB² + 2·NB) and batch ≤
// 65535, with the tile width NB in bits 8 and up of `variant` (2 | 128 << 8
// is tiled at NB=128; 0 there: chol_inv_tiled_default_nb). Enqueues every launch on
// `stream` and returns the first nonzero cudaGetLastError() (or
// cudaErrorInvalidValue for arguments no variant takes), else 0.
extern "C" int kpbp_chol_inv(const void* g, void* scratch, void* l, void* w, int k, int batch,
                             int dtype, int variant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const double tiny = (dtype == KPBP_F64 || dtype == KPBP_C128) ? 1e-300 : 1e-30;
#define KPBP_LAUNCH(T) return launch_chol_inv<T>(g, scratch, l, w, k, batch, dtype, variant, tiny, s)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The most dynamic shared memory one block of `variant` takes at size k,
// the launches one call enqueues and its scratch elements per matrix (the
// plan in ops/kernels.py computes the same; the card tests compare them);
// -1 for a variant code none takes.
extern "C" long long kpbp_chol_inv_smem(int k, int dtype, int variant) {
#define KPBP_LAUNCH(T) return smem_bytes<T>(k, variant, dtype)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return -1;
}

extern "C" long long kpbp_chol_inv_launches(int k, int dtype, int variant) {
#define KPBP_LAUNCH(T) return launches<T>(k, variant, dtype)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return -1;
}

extern "C" long long kpbp_chol_inv_scratch(int k, int dtype, int variant) {
#define KPBP_LAUNCH(T) return scratch_elems<T>(k, variant)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return -1;
}
