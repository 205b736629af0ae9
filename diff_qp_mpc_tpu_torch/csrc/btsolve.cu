// K1: batched block-tridiagonal Cholesky factor + solve, H x = b.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/btsolve_pallas.py::
// batched_factor_solve (_factor_solve_kernel). Same function:
//   L₀L₀ᵀ = D₀ + reg·I;  Sₜ = Oₜ₋₁Lₜ₋₁⁻ᵀ;  LₜLₜᵀ = Dₜ − SₜSₜᵀ + reg·I,
// then block forward (L y = b) and backward (Lᵀ x = y) substitution.
//
// Bound on the H100: at the main path's shapes (B = 64 .. 4096, T = 5,
// n = 3) the work is ~500 flops and ~450 bytes per element, so the card's
// bound is the bytes; but B is far below the 132 SMs × 2048 threads the
// card holds, so a launch is latency-bound: one serial O(T n³) chain per
// thread, whose links are the IEEE divisions and square roots of each
// stage and, in a streaming layout, the global loads of each stage.
//
// Three layouts; the wrapper (ops/btsolve_cuda.py) picks one by (dtype, n,
// T):
// - on chip (btsolve_onchip_kernel, one thread per element, n and T
//   template parameters): a block's elements are contiguous in D, O and b,
//   so its threads first copy the block's spans into shared memory together
//   (coalesced; each element's row padded to an odd number of words, so the
//   per-thread reads hit distinct banks in float32 and float64). Each thread
//   then runs its element's sweep from shared memory with every stage
//   unrolled, holds Lₜ, Sₜ and yₜ in registers for the backward sweep (no
//   scratch tensor), writes x over b in shared memory, and the block copies
//   x out coalesced. The arithmetic and its order are the streaming
//   kernel's, so the two layouts' outputs are bit-identical. (One
//   reciprocal per pivot in place of the divisions ran 34% faster at B 64
//   but moved float32 solutions of the AL path's ρ ≥ 1e4 systems past K1's
//   tolerance; see PERF.md.)
// - warp (btsolve_warp_kernel, one warp per element, n a template
//   parameter, T a run-time value; the quadrotor's n 16): an element at n 16
//   is T·16² values of D and as many of O, against a lane's 255 registers,
//   so the streaming kernel's thread spilled 90 KB of local memory. Here the
//   warp copies its element's D, O and b into dynamic shared memory
//   (coalesced, rows padded to n + 1 words so that lanes reading a column
//   hit distinct banks) and factors in place: Lₜ over Dₜ, Sₜ over Oₜ₋₁, y
//   and then x over b; no scratch tensor, no local memory. Each stage's work
//   is spread over the lanes: Sₜ = Oₜ₋₁Lₜ₋₁⁻ᵀ a row a lane, the Schur update
//   a lower entry a lane, the Cholesky column by column with the lanes
//   taking the rows below the pivot (a __syncwarp between columns), the
//   vector substitutions a row a lane with each solved entry broadcast by a
//   shuffle. Every entry is summed in the streaming kernel's order but the
//   backward substitution's (descending k here, ascending there), so the
//   two agree to rounding, not bit for bit. The compute type C is a
//   template parameter (the wrapper's WARP_COMPUTE picks it, by the rule
//   below), the shared memory is sized from (T, C), and a launch whose
//   block asks for more than the device allows is refused. At n 16, T 5 an
//   element is ~10 KB of device memory in float32 against ~5·10⁴ operations,
//   so its bound is the bytes, but at B 64-256 a launch is one warp on each
//   of a few dozen SMs: latency-bound by the 5 × 16 dependent columns (a
//   square root, a shuffle and a division each) and the 2 × 5 × 16
//   dependent divisions of the substitutions.
// - streaming (btsolve_kernel, one thread per element, n a template
//   parameter, T a run-time value): every other shape. The forward
//   substitution runs inside the factor sweep, and the factor's Lₜ and Sₜ go
//   to a batch-minor scratch tensor [2][T][n][n][B] for the backward sweep;
//   y is parked in the output x. float32 at n 16 computes in float64
//   (Compute, below): its scratch holds float64 and a third part [T][n][B]
//   where y is parked.
//
// Why n 16 computes wider, unlike the TPU kernel and the plain version
// (both float32 throughout): the quadrotor's AL Newton systems at its
// checkpoint's ρ 1e4 (reg 1e-7, cond(H) ~1e7) leave float32 arithmetic
// with errors of the order of the solution: against the float64 solution,
// a float32 kernel and the plain float32 version each err by 0.2-0.7 of
// its largest entry at the worst element of a batch, element by element
// as often one as the other (a card probe, PERF.md), so which of the two
// errs more at a batch's worst element is a draw, and the float32 kernel
// drew 3.9 times the plain version's error at B 128. Computing in float64
// leaves the error of rounding the systems to float32 (~0.1 there), at
// 4-6 times the float32 computation's time in the streaming kernel (1.25
// against 0.29 ms at B 64 on an H100 80GB HBM3 at 700 W, PERF.md). The warp
// layout's float32 computation drew the same: 3.89 times the plain
// version's error on one of 48 draws (8 seeds × ρ 1, 1e2, 1e4 × two
// right-hand sides, B 128), so float32 inputs compute in float64 there too,
// at 1.35 times its float32 computation's time (0.052 against 0.039 ms at
// B 64, same card).
#include <cstddef>
#include <type_traits>

#include "bt_common.cuh"

namespace dqmpc {

// the type the streaming kernel's (N, F) instantiation computes in
template <int N, typename F>
struct Compute {
  using type = F;
};
template <>
struct Compute<16, float> {
  using type = double;
};

template <int N, typename F, typename C = typename Compute<N, F>::type>
__global__ void __launch_bounds__(128)
btsolve_kernel(const F* __restrict__ D, const F* __restrict__ O,
               const F* __restrict__ b, F* __restrict__ x,
               C* __restrict__ scratch, int B, int T, C reg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  constexpr int NN = N * N;
  const F* De = D + static_cast<size_t>(e) * T * NN;
  const F* Oe = O + static_cast<size_t>(e) * (T - 1) * NN;
  const F* be = b + static_cast<size_t>(e) * T * N;
  F* xe = x + static_cast<size_t>(e) * T * N;
  // scratch entry (which, t, i, j) of element e; which 0 = L, 1 = S
  auto at = [&](int which, int t, int i, int j) -> C& {
    return scratch[(((static_cast<size_t>(which) * T + t) * N + i) * N + j) *
                       B + e];
  };
  // where y is parked for the backward sweep: the output x, or, computing
  // wider than F, the scratch's third part
  auto park = [&](int t, int i) -> C& {
    if constexpr (std::is_same_v<C, F>) {
      return xe[t * N + i];
    } else {
      return scratch[((static_cast<size_t>(2 * T * N) * N) + t * N + i) * B +
                     e];
    }
  };

  C M[N][N], L[N][N], Lp[N][N], S[N][N], v[N], y[N], yp[N];

  // ---- stage 0: factor, forward solve ----
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) M[i][j] = De[i * N + j];
    M[i][i] = M[i][i] + reg;
  }
  chol<N, C>(M, L);
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = be[i];
  solve_lower_vec<N, C>(L, v, y);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      at(0, 0, i, j) = L[i][j];
      Lp[i][j] = L[i][j];
    }
    park(0, i) = y[i];
    yp[i] = y[i];
  }

  // ---- stages 1..T-1: Sₜ, Schur complement, factor, forward solve ----
  for (int t = 1; t < T; ++t) {
    const F* Ot = Oe + static_cast<size_t>(t - 1) * NN;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) M[i][j] = Ot[i * N + j];
    }
    solve_lower_mat<N, C>(Lp, M, S);
    const F* Dt = De + static_cast<size_t>(t) * NN;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = Dt[i * N + j];
    }
    schur_update<N, C>(M, S, reg);
    chol<N, C>(M, L);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      C s = be[t * N + i];
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[i][k] * yp[k];
      v[i] = s;
    }
    solve_lower_vec<N, C>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) at(1, t, i, j) = S[i][j];
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        at(0, t, i, j) = L[i][j];
        Lp[i][j] = L[i][j];
      }
      park(t, i) = y[i];
      yp[i] = y[i];
    }
  }

  // ---- backward: Lᵀ x = y; Lp, yp hold stage T-1 ----
  C xn[N];
  solve_upper_vec<N, C>(Lp, yp, xn);
#pragma unroll
  for (int i = 0; i < N; ++i) xe[(T - 1) * N + i] = static_cast<F>(xn[i]);
  for (int t = T - 2; t >= 0; --t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) S[i][j] = at(1, t + 1, i, j);
#pragma unroll
      for (int j = 0; j <= i; ++j) L[i][j] = at(0, t, i, j);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      C s = park(t, i);
#pragma unroll
      for (int k = 0; k < N; ++k) s = s - S[k][i] * xn[k];
      v[i] = s;
    }
    solve_upper_vec<N, C>(L, v, y);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xe[t * N + i] = static_cast<F>(y[i]);
      xn[i] = y[i];
    }
  }
}

// threads per block of the on-chip kernel: a block stages 64 elements
constexpr int kOnChipThreads = 64;

// Words of one element in shared memory: D [T][N][N], O [T-1][N][N], b
// [T][N] (then x), rounded up to an odd count.
template <int N, int T>
struct OnChip {
  static constexpr int kD = T * N * N;
  static constexpr int kO = (T - 1) * N * N;
  static constexpr int kB = T * N;
  static constexpr int kStride = (kD + kO + kB) | 1;
};

// Copy the block's nb elements of K contiguous scalars each between global
// memory g and their rows (STRIDE apart, from column OFF) in shared memory,
// neighbouring threads on neighbouring global addresses: into shared
// memory when g points to const, out of it otherwise.
template <int K, int STRIDE, int OFF, typename P, typename F>
__device__ __forceinline__ void stage(P g, F* sm, int nb) {
  auto move = [&](int i) {
    F& s = sm[(i / K) * STRIDE + OFF + i % K];
    if constexpr (std::is_const_v<std::remove_pointer_t<P>>) {
      s = g[i];
    } else {
      g[i] = s;
    }
  };
  if (nb == kOnChipThreads) {
#pragma unroll
    for (int r = 0; r < K; ++r) move(r * kOnChipThreads + threadIdx.x);
  } else {
    for (int i = threadIdx.x; i < nb * K; i += kOnChipThreads) move(i);
  }
}

template <int N, int T, typename F>
__global__ void __launch_bounds__(kOnChipThreads)
btsolve_onchip_kernel(const F* __restrict__ D, const F* __restrict__ O,
                      const F* __restrict__ b, F* __restrict__ x, int B,
                      F reg) {
  using C = OnChip<N, T>;
  constexpr int NN = N * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F* sm = reinterpret_cast<F*>(smem_raw);
  const size_t e0 = static_cast<size_t>(blockIdx.x) * kOnChipThreads;
  const int nb = min(kOnChipThreads, B - static_cast<int>(e0));
  stage<C::kD, C::kStride, 0>(D + e0 * C::kD, sm, nb);
  stage<C::kO, C::kStride, C::kD>(O + e0 * C::kO, sm, nb);
  stage<C::kB, C::kStride, C::kD + C::kO>(b + e0 * C::kB, sm, nb);
  __syncthreads();

  if (threadIdx.x < nb) {
    const F* De = sm + threadIdx.x * C::kStride;
    const F* Oe = De + C::kD;
    F* be = sm + threadIdx.x * C::kStride + C::kD + C::kO;  // b, then x
    F L[T][N][N], S[T][N][N], y[T][N], M[N][N], v[N];

    // ---- stage 0: factor, forward solve ----
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) M[i][j] = De[i * N + j];
      M[i][i] = M[i][i] + reg;
    }
    chol<N, F>(M, L[0]);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = be[i];
    solve_lower_vec<N, F>(L[0], v, y[0]);

    // ---- stages 1..T-1: Sₜ, Schur complement, factor, forward solve ----
#pragma unroll
    for (int t = 1; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) M[i][j] = Oe[(t - 1) * NN + i * N + j];
      }
      solve_lower_mat<N, F>(L[t - 1], M, S[t]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) M[i][j] = De[t * NN + i * N + j];
      }
      schur_update<N, F>(M, S[t], reg);
      chol<N, F>(M, L[t]);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        F s = be[t * N + i];
#pragma unroll
        for (int k = 0; k < N; ++k) s = s - S[t][i][k] * y[t - 1][k];
        v[i] = s;
      }
      solve_lower_vec<N, F>(L[t], v, y[t]);
    }

    // ---- backward: Lᵀ x = y, x over b in shared memory ----
    F xn[N];
    auto bwd = [&](int t, const F (&rhs)[N]) {
      solve_upper_vec<N, F>(L[t], rhs, xn);
#pragma unroll
      for (int i = 0; i < N; ++i) be[t * N + i] = xn[i];
    };
    bwd(T - 1, y[T - 1]);
#pragma unroll
    for (int t = T - 2; t >= 0; --t) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        F s = y[t][i];
#pragma unroll
        for (int k = 0; k < N; ++k) s = s - S[t + 1][k][i] * xn[k];
        v[i] = s;
      }
      bwd(t, v);
    }
  }
  __syncthreads();
  stage<C::kB, C::kStride, C::kD + C::kO>(x + e0 * C::kB, sm, nb);
}

template <int N, int T, typename F>
int launch_onchip(const F* D, const F* O, const F* b, F* x, int B, F reg,
                  cudaStream_t s) {
  constexpr size_t smem =
      sizeof(F) * OnChip<N, T>::kStride * kOnChipThreads;
  auto kernel = btsolve_onchip_kernel<N, T, F>;
  if (smem > 48 * 1024) {  // above the default, as dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return static_cast<int>(err);
    }
  }
  const int blocks = (B + kOnChipThreads - 1) / kOnChipThreads;
  kernel<<<blocks, kOnChipThreads, smem, s>>>(D, O, b, x, B, reg);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_onchip_shape(const void* D, const void* O, const void* b, void* x,
                        int B, int T, int n, double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F* Dp = static_cast<const F*>(D);
  const F* Op = static_cast<const F*>(O);
  const F* bp = static_cast<const F*>(b);
  F* xp = static_cast<F*>(x);
  const F r = static_cast<F>(reg);
#define BT_ONCHIP_CASE(NN_, TT_) \
  if (n == NN_ && T == TT_)      \
    return launch_onchip<NN_, TT_, F>(Dp, Op, bp, xp, B, r, s);
  // the shapes whose element fits in registers without spills (ptxas -v:
  // float32 (3, 5) 96 registers, (3, 10) 242, (5, 5) 246; float64 (3, 5)
  // 214; (5, 10), and float64 beyond (3, 5), spill)
  BT_ONCHIP_CASE(3, 5)
  if constexpr (std::is_same_v<F, float>) {
    BT_ONCHIP_CASE(3, 10)
    BT_ONCHIP_CASE(5, 5)
  }
#undef BT_ONCHIP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- the warp layout ----

// elements (warps) a block of the warp layout
constexpr int kWarpElements = 2;
constexpr unsigned kFullMask = 0xffffffffu;

// Words of the compute type that one element takes in shared memory: D
// [T][N][N+1] (then L), O [T-1][N][N+1] (then S), b [T][N] (then y, then x).
template <int N>
__host__ __device__ constexpr long long warp_words(int T) {
  return (2LL * T - 1) * N * (N + 1) + static_cast<long long>(T) * N;
}

// (i, j), j ≤ i, of the index e of a lower triangle packed by rows
__device__ __forceinline__ void lower_entry(int e, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  if (i * (i + 1) / 2 > e) --i;
  if ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

template <int N, typename F, typename C>
__global__ void __launch_bounds__(32 * kWarpElements)
btsolve_warp_kernel(const F* __restrict__ D, const F* __restrict__ O,
                    const F* __restrict__ b, F* __restrict__ x, int B, int T,
                    C reg) {
  static_assert(N <= 32, "a lane per row");
  constexpr int P = N + 1;   // a padded row
  constexpr int NP = N * P;  // a padded block
  constexpr int NN = N * N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long e = static_cast<long long>(blockIdx.x) * kWarpElements + w;
  if (e >= B) return;  // the whole warp: no shuffle waits on it
  C* Ls = reinterpret_cast<C*>(smem_raw) + w * warp_words<N>(T);  // D, L
  C* Ss = Ls + static_cast<long long>(T) * NP;                     // O, S
  C* ys = Ss + static_cast<long long>(T - 1) * NP;                 // b, y, x

  // ---- load, coalesced: an element's D, O and b are contiguous ----
  const F* De = D + e * T * NN;
  for (int k = lane; k < T * NN; k += 32)
    Ls[(k / N) * P + k % N] = static_cast<C>(De[k]);
  const F* Oe = O + e * (T - 1) * NN;
  for (int k = lane; k < (T - 1) * NN; k += 32)
    Ss[(k / N) * P + k % N] = static_cast<C>(Oe[k]);
  const F* be = b + e * T * N;
  for (int k = lane; k < T * N; k += 32) ys[k] = static_cast<C>(be[k]);
  __syncwarp();

  // ---- per stage: Sₜ, Schur complement, factor, forward solve ----
  for (int t = 0; t < T; ++t) {
    C* L = Ls + t * NP;
    if (t == 0) {
      if (lane < N) L[lane * P + lane] = L[lane * P + lane] + reg;
    } else {
      const C* Lp = L - NP;
      C* S = Ss + (t - 1) * NP;
      if (lane < N) {  // Sₜ Lₜ₋₁ᵀ = Oₜ₋₁ over Oₜ₋₁, a row a lane
        C* Sr = S + lane * P;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          C s = Sr[c];
#pragma unroll
          for (int k = 0; k < c; ++k) s = s - Sr[k] * Lp[c * P + k];
          Sr[c] = s / Lp[c * P + c];
        }
      }
      __syncwarp();
      // Dₜ − SₜSₜᵀ + reg·I on the lower triangle, an entry a lane
      for (int k = lane; k < N * (N + 1) / 2; k += 32) {
        int i, j;
        lower_entry(k, i, j);
        C acc = L[i * P + j];
#pragma unroll
        for (int q = 0; q < N; ++q) acc = acc - S[i * P + q] * S[j * P + q];
        L[i * P + j] = i == j ? acc + reg : acc;
      }
    }
    __syncwarp();
    // Cholesky in place, column by column, a row a lane; the pivot's floor
    // 1e-30 as chol's (bt_common.cuh)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      C sv = C(0);
      if (lane >= j && lane < N) {
        sv = L[lane * P + j];
#pragma unroll
        for (int k = 0; k < j; ++k) sv = sv - L[lane * P + k] * L[j * P + k];
      }
      const C piv = sqrt(max_keep_nan(__shfl_sync(kFullMask, sv, j), C(1e-30)));
      if (lane > j && lane < N) L[lane * P + j] = sv / piv;
      if (lane == j) L[j * P + j] = piv;
      __syncwarp();
    }
    // yₜ = Lₜ⁻¹ (bₜ − Sₜ yₜ₋₁), a row a lane, over bₜ
    C v = C(0);
    if (lane < N) {
      v = ys[t * N + lane];
      if (t > 0) {
        const C* Sr = Ss + (t - 1) * NP + lane * P;
        const C* yp = ys + (t - 1) * N;
#pragma unroll
        for (int k = 0; k < N; ++k) v = v - Sr[k] * yp[k];
      }
    }
    C y = C(0);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const C yi =
          __shfl_sync(kFullMask, lane == i ? v / L[i * P + i] : C(0), i);
      if (lane == i) y = yi;
      if (lane > i && lane < N) v = v - L[lane * P + i] * yi;
    }
    if (lane < N) ys[t * N + lane] = y;
    __syncwarp();
  }

  // ---- backward: xₜ = Lₜ⁻ᵀ (yₜ − Sₜ₊₁ᵀ xₜ₊₁), a row a lane, over yₜ ----
  for (int t = T - 1; t >= 0; --t) {
    const C* L = Ls + t * NP;
    C v = C(0);
    if (lane < N) {
      v = ys[t * N + lane];
      if (t < T - 1) {
        const C* S = Ss + t * NP;  // Sₜ₊₁
        const C* xn = ys + (t + 1) * N;
#pragma unroll
        for (int k = 0; k < N; ++k) v = v - S[k * P + lane] * xn[k];
      }
    }
    C xv = C(0);
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      const C xi =
          __shfl_sync(kFullMask, lane == i ? v / L[i * P + i] : C(0), i);
      if (lane == i) xv = xi;
      if (lane < i) v = v - L[i * P + lane] * xi;
    }
    if (lane < N) ys[t * N + lane] = xv;
    __syncwarp();
  }
  F* xe = x + e * T * N;
  for (int k = lane; k < T * N; k += 32) xe[k] = static_cast<F>(ys[k]);
}

// Shared memory of the warp layout at (N, C, T): bytes an element and a
// block, and the most a block may ask of the current device.
template <int N, typename C>
int warp_smem(int T, long long* per_element, long long* per_block,
              int* device_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *per_element = warp_words<N>(T) * static_cast<long long>(sizeof(C));
  *per_block = *per_element * kWarpElements;
  return static_cast<int>(err);
}

template <int N, typename F, typename C>
int launch_warp(const void* D, const void* O, const void* b, void* x, int B,
                int T, double reg, cudaStream_t s) {
  long long per_element = 0, per_block = 0;
  int device_max = 0;
  cudaError_t err = static_cast<cudaError_t>(
      warp_smem<N, C>(T, &per_element, &per_block, &device_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_block > device_max)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  auto kernel = btsolve_warp_kernel<N, F, C>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(per_block));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kWarpElements - 1) / kWarpElements;
  kernel<<<blocks, 32 * kWarpElements, per_block, s>>>(
      static_cast<const F*>(D), static_cast<const F*>(O),
      static_cast<const F*>(b), static_cast<F*>(x), B, T,
      static_cast<C>(static_cast<F>(reg)));
  return static_cast<int>(cudaGetLastError());
}

// the warp layout's block sizes: n 16 (the quadrotor)
template <typename F, typename C>
int launch_warp_n(const void* D, const void* O, const void* b, void* x, int B,
                  int T, int n, double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 16) return launch_warp<16, F, C>(D, O, b, x, B, T, reg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int N, typename F>
void launch_stream(const void* D, const void* O, const void* b, void* x,
                   void* scratch, int B, int T, double reg,
                   cudaStream_t s) {
  using C = typename Compute<N, F>::type;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  btsolve_kernel<N, F><<<blocks, threads, 0, s>>>(
      static_cast<const F*>(D), static_cast<const F*>(O),
      static_cast<const F*>(b), static_cast<F*>(x), static_cast<C*>(scratch),
      B, T, static_cast<C>(static_cast<F>(reg)));
}

// Bytes of the streaming kernel's scratch at (N, F): L and S, and where C
// is wider than F the parked y.
template <int N, typename F>
long long stream_scratch_bytes(int B, int T) {
  using C = typename Compute<N, F>::type;
  const long long parked = std::is_same_v<C, F> ? 0 : T * N;
  return (2LL * T * N * N + parked) * B * static_cast<long long>(sizeof(C));
}

template <typename F>
int launch(const void* D, const void* O, const void* b, void* x,
           void* scratch, int B, int T, int n, double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 3:
      launch_stream<3, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 4:
      launch_stream<4, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 5:
      launch_stream<5, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 6:
      launch_stream<6, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 7:
      launch_stream<7, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    case 16:
      launch_stream<16, F>(D, O, b, x, scratch, B, T, reg, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
long long scratch_bytes(int B, int T, int n) {
  switch (n) {
    case 3: return stream_scratch_bytes<3, F>(B, T);
    case 4: return stream_scratch_bytes<4, F>(B, T);
    case 5: return stream_scratch_bytes<5, F>(B, T);
    case 6: return stream_scratch_bytes<6, F>(B, T);
    case 7: return stream_scratch_bytes<7, F>(B, T);
    case 16: return stream_scratch_bytes<16, F>(B, T);
    default: return -1;
  }
}

}  // namespace dqmpc

// D [B,T,n,n], O [B,T-1,n,n], b [B,T,n] -> x [B,T,n], all contiguous.
// Streaming layout: scratch holds btsolve_scratch_bytes_<dtype>(B, T, n)
// bytes. Returns a cudaError_t code.
extern "C" int btsolve_f32(const void* D, const void* O, const void* b,
                           void* x, void* scratch, int B, int T, int n,
                           double reg, void* stream) {
  return dqmpc::launch<float>(D, O, b, x, scratch, B, T, n, reg, stream);
}

extern "C" int btsolve_f64(const void* D, const void* O, const void* b,
                           void* x, void* scratch, int B, int T, int n,
                           double reg, void* stream) {
  return dqmpc::launch<double>(D, O, b, x, scratch, B, T, n, reg, stream);
}

// Bytes of the streaming layout's scratch; -1 for an unbuilt n.
extern "C" long long btsolve_scratch_bytes_f32(int B, int T, int n) {
  return dqmpc::scratch_bytes<float>(B, T, n);
}

extern "C" long long btsolve_scratch_bytes_f64(int B, int T, int n) {
  return dqmpc::scratch_bytes<double>(B, T, n);
}

// On-chip layout, no scratch. cudaErrorInvalidValue for an (n, T) without
// an instantiation.
extern "C" int btsolve_onchip_f32(const void* D, const void* O,
                                  const void* b, void* x, int B, int T, int n,
                                  double reg, void* stream) {
  return dqmpc::launch_onchip_shape<float>(D, O, b, x, B, T, n, reg, stream);
}

extern "C" int btsolve_onchip_f64(const void* D, const void* O,
                                  const void* b, void* x, int B, int T, int n,
                                  double reg, void* stream) {
  return dqmpc::launch_onchip_shape<double>(D, O, b, x, B, T, n, reg, stream);
}

// Warp layout, no scratch; compute_bits names the type it computes in (32:
// float, only for float32 inputs; 64: double). cudaErrorInvalidValue for
// an n without an instantiation or another compute type,
// cudaErrorInvalidConfiguration where a block's shared memory exceeds the
// device's.
extern "C" int btsolve_warp_f32(const void* D, const void* O, const void* b,
                                void* x, int B, int T, int n, double reg,
                                int compute_bits, void* stream) {
  if (compute_bits == 32)
    return dqmpc::launch_warp_n<float, float>(D, O, b, x, B, T, n, reg,
                                              stream);
  if (compute_bits == 64)
    return dqmpc::launch_warp_n<float, double>(D, O, b, x, B, T, n, reg,
                                               stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int btsolve_warp_f64(const void* D, const void* O, const void* b,
                                void* x, int B, int T, int n, double reg,
                                int compute_bits, void* stream) {
  if (compute_bits != 64) return static_cast<int>(cudaErrorInvalidValue);
  return dqmpc::launch_warp_n<double, double>(D, O, b, x, B, T, n, reg,
                                              stream);
}

// The warp layout's shared memory at (T, n, compute_bits): bytes an element
// and a block, and the device's most a block may ask. cudaErrorInvalidValue
// for an n without an instantiation.
extern "C" int btsolve_warp_smem(int T, int n, int compute_bits,
                                 long long* per_element, long long* per_block,
                                 int* device_max) {
  if (n != 16 || (compute_bits != 32 && compute_bits != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  return compute_bits == 32
             ? dqmpc::warp_smem<16, float>(T, per_element, per_block,
                                           device_max)
             : dqmpc::warp_smem<16, double>(T, per_element, per_block,
                                            device_max);
}
