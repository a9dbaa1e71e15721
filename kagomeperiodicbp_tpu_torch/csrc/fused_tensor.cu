// K1 · fused_tensor: the double-layer (ket ⊗ bra) tensors of a unit cell,
// and the operator sandwiches of one site.
//
// Replaces: kagomeperiodicbp_tpu/ops/pallas_kernels.py · fused_tensor_pallas
// (kernel _fused_kernel_real), the Pallas twin of networks/unit_cell.fused_tensor.
//
//   out_f[(aA),(bB),(cC),(eE)] = Σ_s K_f[s,a,b,c,e] · conj(B_f[s,A,B,C,E])
//
// for up to three ket tensors K_f [d, D,D,D,D] and as many bra tensors B_f
// of the same shape, each pair giving out_f [D²,D²,D²,D²] with
// (aA) = a·D + A; the outputs lie one after another in one buffer. The
// double-layer tensor of a cell takes B_f = K_f, the cell's flavours A, B
// and C (the bra pointer is the ket pointer). The operator sandwich of one
// site, ⟨ψ| op |ψ⟩ (networks/unit_cell.fused_tensor_with_operator, plain
// jnp in the JAX package), takes K_f = op_f·T and B_f = T: one launch makes
// the sandwiches of three operators at one site.
//
// What bounds it on this card: device-memory writes. Each output has D⁸
// elements (16.8 M at D=8, 268 MB in complex128) and each element costs only
// d (= 2) complex multiply-adds, while the input is d·D⁴ elements. So the
// kernel is a store stream, and what it must keep off the critical path is
// everything else: index arithmetic, operand reads and launches.
//
// What the design does about it:
// * one block per output slab: block (f, aA, bB) writes the D⁴ contiguous
//   elements out_f[aA, bB, :, :], and every one of them is built from the
//   same ket rows K_f[:, a, b, :, :] and bra rows B_f[:, A, B, :, :]. The
//   block stages those 2·d·D² elements into shared memory once, reading K_f
//   and B_f each through its own strides (a permuted cell needs no copy
//   first);
// * within the slab the element (cC, eE) sits at ((c·D + C)·D + e)·D + E,
//   a 32-bit index; D is a template parameter for D = 1…8, so its divisions
//   are multiply-shifts, and the same body with D read at run time (DT = 0)
//   serves larger D;
// * 16-byte vector stores along the slab (four float, two double, two
//   complex64 or one complex128 per store), neighbouring threads on
//   neighbouring addresses; where D⁴ is not a multiple of the vector width
//   (odd D in the narrow types) the slab's ragged ends are stored singly;
// * one launch for all three flavours of a cell (or three operators at one
//   site): the grid is n·D⁴ blocks and the inputs come in one struct of
//   pointers and strides.
#include "common.cuh"

// The inputs of one launch: up to three ket tensors K_f [d, D,D,D,D] and
// as many bra tensors B_f, each with its strides in elements, and the output
// buffer, [n, D²,D²,D²,D²] contiguous.
struct FusedTensorsArgs {
  const void* t[3];
  long long stride[3][5];
  const void* bra[3];
  long long bra_stride[3][5];
  void* out;
};
static_assert(sizeof(FusedTensorsArgs) == 296, "ops/kernels.py _FusedArgs packs 37 fields of 8 bytes");

// The 16-byte vector a store writes, and how many scalars it holds.
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int n = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int n = 2; };
template <> struct Vec16<float2> { using type = float4; static constexpr int n = 2; };
template <> struct Vec16<double2> { using type = double2; static constexpr int n = 1; };

template <typename T, int DT>
__global__ void fused_tensors_kernel(const FusedTensorsArgs args, int d, int D_rt) {
  using S = Scalar<T>;
  using V = typename Vec16<T>::type;
  constexpr int VN = Vec16<T>::n;
  const int D = DT ? DT : D_rt;
  const int D2 = D * D;
  const int n = D2 * D2;  // elements of one slab
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ket = reinterpret_cast<T*>(smem_raw);  // [d][c][e]
  T* bra = ket + d * D2;                    // [d][C][E]

  // block → (f, aA, bB)
  const int f = blockIdx.x / n;
  const int slab = blockIdx.x - f * n;
  const int aA = slab / D2, bB = slab - (slab / D2) * D2;
  const int a = aA / D, A = aA - (aA / D) * D;
  const int b = bB / D, B = bB - (bB / D) * D;

  // pair f's pointers and strides, each picked by value (no indexing into
  // the parameter struct with a runtime f)
  const T* tk = static_cast<const T*>(f == 0 ? args.t[0] : f == 1 ? args.t[1] : args.t[2]);
  const T* tb = static_cast<const T*>(f == 0 ? args.bra[0] : f == 1 ? args.bra[1] : args.bra[2]);
  long long sk[5], sb[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    sk[k] = f == 0 ? args.stride[0][k] : f == 1 ? args.stride[1][k] : args.stride[2][k];
    sb[k] = f == 0 ? args.bra_stride[0][k] : f == 1 ? args.bra_stride[1][k] : args.bra_stride[2][k];
  }
  const T* row_ket = tk + a * sk[1] + b * sk[2];
  const T* row_bra = tb + A * sb[1] + B * sb[2];
  // element (s, c, e) of the ket rows and of the bra rows: one index
  // decode, two independent loads
  for (int i = threadIdx.x; i < d * D2; i += blockDim.x) {
    const int s = i / D2, ce = i - (i / D2) * D2;
    const int c = ce / D, e = ce - (ce / D) * D;
    ket[i] = __ldg(row_ket + s * sk[0] + c * sk[3] + e * sk[4]);
    bra[i] = __ldg(row_bra + s * sb[0] + c * sb[3] + e * sb[4]);
  }
  __syncthreads();

  // the slab's element j = ((c·D + C)·D + e)·D + E
  auto value = [&](int j) {
    const int E = j % D; j /= D;
    const int e = j % D; j /= D;
    const int C = j % D;
    const int c = j / D;
    const T* k = ket + c * D + e;
    const T* w = bra + C * D + E;
    T acc = S::zero();
    for (int s = 0; s < d; ++s) acc = S::mul_add_conj(acc, k[s * D2], w[s * D2]);
    return acc;
  };

  T* out = static_cast<T*>(args.out) + (long long)blockIdx.x * n;
  // elements before the first 16-byte boundary, then whole vectors, then the rest
  const int head = min(n, (int)((VN - ((long long)blockIdx.x * n) % VN) % VN));
  const int nvec = (n - head) / VN;
  const int tail = head + nvec * VN;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int j0 = head + v * VN;
    union { T s[VN]; V v; } pack;
#pragma unroll
    for (int q = 0; q < VN; ++q) pack.s[q] = value(j0 + q);
    *reinterpret_cast<V*>(out + j0) = pack.v;
  }
  if ((int)threadIdx.x < head) out[threadIdx.x] = value(threadIdx.x);
  if (tail + (int)threadIdx.x < n) out[tail + threadIdx.x] = value(tail + threadIdx.x);
}

template <typename T, int DT>
static void launch_fused(const FusedTensorsArgs& args, int nt, int d, int D, cudaStream_t stream) {
  const int n = D * D * D * D;
  const int vecs = (n + Vec16<T>::n - 1) / Vec16<T>::n;
  const int threads = vecs >= 256 ? 256 : ((vecs + 31) / 32) * 32;
  const size_t smem = 2 * (size_t)d * D * D * sizeof(T);
  fused_tensors_kernel<T, DT><<<(unsigned)(nt * n), threads, smem, stream>>>(args, d, D);
}

template <typename T>
static void launch_fused_d(const FusedTensorsArgs& args, int nt, int d, int D, cudaStream_t s) {
  switch (D) {
    case 1: launch_fused<T, 1>(args, nt, d, D, s); break;
    case 2: launch_fused<T, 2>(args, nt, d, D, s); break;
    case 3: launch_fused<T, 3>(args, nt, d, D, s); break;
    case 4: launch_fused<T, 4>(args, nt, d, D, s); break;
    case 5: launch_fused<T, 5>(args, nt, d, D, s); break;
    case 6: launch_fused<T, 6>(args, nt, d, D, s); break;
    case 7: launch_fused<T, 7>(args, nt, d, D, s); break;
    case 8: launch_fused<T, 8>(args, nt, d, D, s); break;
    default: launch_fused<T, 0>(args, nt, d, D, s); break;
  }
}

// nt (1..3) ket tensors [d, D,D,D,D] of `dtype` and as many bra tensors,
// read through args.stride and args.bra_stride; the output args.out is
// [nt, D²,D²,D²,D²], contiguous and 16-byte aligned.
// Returns cudaGetLastError() after the one launch.
extern "C" int kpbp_fused_tensors(FusedTensorsArgs args, int nt, int d, int D, int dtype,
                                  void* stream) {
  if (nt < 1 || nt > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KPBP_LAUNCH(T) launch_fused_d<T>(args, nt, d, D, s)
  KPBP_DISPATCH(dtype, KPBP_LAUNCH)
#undef KPBP_LAUNCH
  return (int)cudaGetLastError();
}
