// K2 with W warps per batch element and the element's blocks in shared
// memory: the whole augmented-Lagrangian MPC solve of the quadrotor (n =
// NX + NU = 16) and of the cartpoles (n 5 and 7).
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/al_fused_pallas.py::
// fused_al_solve (_al_kernel) for a model whose element does not fit one
// lane: al_fused_common.cuh's kernel keeps the element in one lane's
// registers, about 4,600 values at nx 12, nu 4, T 5 against a lane's 255
// registers (the TPU kernel met the same wall in VMEM and built each stage's
// D/O blocks lazily inside the factor sweep, al_fused_pallas.py:157-199).
// Here each element's trajectory, cost, multipliers, Jacobians [A B], the
// factor L (packed lower, one 16×16 block a stage), the Schur blocks S and
// the line search's steps live in dynamic shared memory (WarpElement: 18.2
// KB in float32, 36.5 KB in float64 at the quadrotor's shape).
//
// W, the warps an element takes, is a template parameter: at W 1 two
// elements share a block of two warps; at W 2 and 4 an element has a block
// of W·32 threads to itself, so a launch of B elements spreads over B SMs
// (up to 132). The sources build W 4, the fastest of the three at B 64-256
// on every model, horizon and dtype on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md). Beyond one wave of W 4 blocks (B 256 on the quadrotor, whose
// 168 registers a thread let an SM hold three 128-thread blocks; B 512 on
// the cartpoles) one warp per element was faster, by up to 2.7× at B 4096;
// no path's default batch is that large. The element's threads share its
// work:
//   - the Jacobian: (T − 1)·n forward-mode columns of the RK4 step and the
//     T − 1 steps, one a thread (the step and one column are the called
//     device functions rk4_value / rk4_column of al_fused_common.cuh);
//   - D_t for every stage (the 136 entries of each stage's lower triangle,
//     GᵀG by 12-term dots) and the merit gradient, then at each stage the
//     Schur update D_t − S_t S_tᵀ, an entry a thread;
//   - the line search's steps: the RK4 step of w + a·d at stage t for
//     candidate k, one (k, t) pair a thread, into shared memory; then lane k
//     of warp 0 sums candidate k's merit terms in the one-lane order (t,
//     then i, then the bound terms) and line_search_pick's (merit, k)
//     butterfly reproduces the serial first-minimum rule exactly.
// Warp 0 runs the chains that do not split: at each stage it factors D_t −
// S_t S_tᵀ and forms S_{t+1} = O_t L_t⁻ᵀ in one column sweep ("panel"),
// lane i holding row i of L_t and lane n + r row r of S_{t+1} in
// registers, each column k a shuffle of the pivot, a square root, a
// division and the lanes' updates of their later entries by L_jk
// (right-looking, so an entry takes its products in the order k = 0, 1, …
// of the one-lane dot); and in the triangular solves every lane holds the
// stage's right-hand side and solves it whole, so a row is a multiply-add
// and a division with no shuffle between rows. A phase ends at a barrier
// of the element's threads (__syncwarp at W 1, __syncthreads above).
//
// Semantics are al_fused_common.cuh's (its header lists them): x₀ pinned,
// the candidate cost as q0 + a·q1 + a²·q2, the strict-< first minimum over
// a = 2⁻ᵏ from float32's max, the incumbent kept bit-exact when no
// candidate beats it, λ_hi/λ_lo clamped at 0, ρ ← min(ρ·factor, rho_max),
// the same residual norm; the merit's dynamics term rounded before it is
// summed (kRoundedMerit). Every entry keeps its expression and its order of
// summation at every W, so the W instantiations give the same bits. Sums
// over the warp (q0, q1, q2, the current merit's cost) and the upper
// triangular solves run in another order than the one-lane kernel's, so the
// two agree to rounding, not bit for bit.
//
// The cartpoles' elements fit a lane's registers only with spills of 0.9-12
// KB a thread (al_fused_common.cuh's group layout, which they ran on before,
// 2.3-7.2× slower at B 64-4096); here they take 3.8-13.3 KB of shared
// memory an element in float32.
//
// Bound on the H100: 2.5·10⁶ operations and 2 KB of device memory an element
// in float32 at the quadrotor checkpoint's budget (benchmarks/flops.py), so
// the operations. At the main path's B 64-128 a launch occupies a few warps
// on each of 32-128 SMs, and each element is a chain of dependent phases,
// so it is latency-bound: the stages' column sweeps (16 columns of a pivot
// and a division each at the quadrotor) and their triangular solves (16
// rows of a division each), in order on warp 0, were 72% of the quadrotor's
// element at W 4 (clock64() counters, PERF.md): each column and row waits
// on an IEEE square root and division, whose slow-path branches keep the
// compiler from overlapping them with the column's other updates; then the
// Jacobian's dual RK4 columns and the candidates' RK4 steps.
#pragma once

#include "al_fused_common.cuh"

namespace dqmpc {

constexpr unsigned kFullWarp = 0xffffffffu;
// candidates whose steps are in shared memory at once: one a lane of warp 0
constexpr int kLsChunk = 32;

// elements a block: two one-warp elements, or one element of W > 1 warps
template <int W>
__host__ __device__ constexpr int elements_per_block() {
  return W == 1 ? 2 : 1;
}

template <int W>
__host__ __device__ constexpr int log2_warps() {
  return W == 1 ? 0 : W == 2 ? 1 : W == 4 ? 2 : -1;
}

template <int NX, int NU, int T, typename F>
struct WarpElement {
  static constexpr int N = NX + NU;
  static constexpr int NP = N * (N + 1) / 2;
  F Cd[T][N], cv[T][N], w[T][N], grad[T][N];
  // the forward solve's y, then the Newton direction d
  F d[T][N];
  F x0[NX];
  F lamd[T - 1][NX], lamh[T][NU], laml[T][NU];
  F G[T - 1][NX][N];  // [A_t B_t], the step's Jacobian at stage t
  F f[T - 1][NX];     // the step at stage t of w
  F L[T][NP];         // D_t, then the factor of stage t, lower by rows
  F S[T - 1][N][N];   // S[t − 1] = S_t = O_{t-1} L_{t-1}⁻ᵀ, t ≥ 1
  // the step at stage t of w + a_k·d, candidate k of the current chunk
  F fls[kLsChunk][T - 1][NX];
  F pick_m;  // the line search's pick, for every warp of the element
  int pick_k;
};

// index of (i, j), j ≤ i, in a lower triangle packed by rows
__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// (i, j) of the packed index e
__device__ __forceinline__ void untri(int e, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  if (tri(i, 0) > e) --i;
  if (tri(i + 1, 0) <= e) ++i;
  j = e - tri(i, 0);
}

// the sum over the warp, the same bits on every lane
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = v + __shfl_xor_sync(kFullWarp, v, s);
  return v;
}

// a barrier of the element's threads
template <int W>
__device__ __forceinline__ void element_sync() {
  if constexpr (W == 1)
    __syncwarp();
  else
    __syncthreads();
}

// stage t of w + a·d (or of w), x₀ pinned, as the step's argument
template <class Sys, int T, typename F>
__device__ __forceinline__ Vec<F, Sys::NX + Sys::NU> stage(
    const WarpElement<Sys::NX, Sys::NU, T, F>& s, int t, F a, bool along) {
  constexpr int NX = Sys::NX, N = Sys::NX + Sys::NU;
  Vec<F, N> xu;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const F v = along ? s.w[t][i] + a * s.d[t][i] : s.w[t][i];
    xu.v[i] = (t == 0 && i < NX) ? s.x0[i] : v;
  }
  return xu;
}

// The merit's dynamics and bound terms (merit_constraints of
// al_fused_common.cuh, kRoundedMerit) of w + a·d (along) or of w, given
// the step at each stage of it (f), one thread.
template <class Sys, int T, typename F>
__device__ F merit_constraints_of(
    const WarpElement<Sys::NX, Sys::NU, T, F>& s, const F (*f)[Sys::NX], F a,
    bool along, F rho, const Box<F, Sys::NU>& box) {
  constexpr int NX = Sys::NX, NU = Sys::NU;
  F m = F(0);
#pragma unroll 1
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const F wn = along ? s.w[t + 1][i] + a * s.d[t + 1][i] : s.w[t + 1][i];
      const F r = wn - f[t][i];
      m = m + mul_rn(s.lamd[t][i], r) + mul_rn(mul_rn(F(0.5) * rho, r), r);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const F u = along ? s.w[t][NX + i] + a * s.d[t][NX + i] : s.w[t][NX + i];
      const F rh = u - box.hi[i];
      const F rl = box.lo[i] - u;
      const F ch = max_keep_nan(rh, F(0));
      const F cl = max_keep_nan(rl, F(0));
      m = m + s.lamh[t][i] * rh + s.laml[t][i] * rl +
          F(0.5) * rho * (ch * ch + cl * cl);
    }
  }
  return m;
}

// the step at every stage of w into s.f, threads take stages
template <class Sys, int T, typename F>
__device__ __forceinline__ void element_steps(
    const typename Sys::template Params<F>& p,
    WarpElement<Sys::NX, Sys::NU, T, F>& s, int tid, int threads) {
  for (int t = tid; t < T - 1; t += threads) {
    const Vec<F, Sys::NX> f =
        rk4_value<Sys, F>(p, stage<Sys, T, F>(s, t, F(0), false));
#pragma unroll
    for (int i = 0; i < Sys::NX; ++i) s.f[t][i] = f.v[i];
  }
}

// Stage t's column sweep on one warp: the factor L_t of s.L[t] (D_t − S_t
// S_tᵀ + reg·I by rows) in place and, for t < T − 1, S_{t+1} = O_t L_t⁻ᵀ
// into s.S[t] (O_t = −ρ [A_t B_t; 0 0], x₀'s columns pinned at t = 0).
// Lane i < n holds row i of L_t, lane n + r row r of S_{t+1}, in registers.
// Column k: the pivot sqrt(max(a_kk, 1e-30)) from lane k (chol's floor,
// bt_common.cuh), each later row's entry divided by it, then each lane's
// later entries j less its column-k entry times L_jk (a shuffle from lane
// j): an entry takes its products in the order k = 0, 1, … of the one-lane
// dot, so every entry has that dot's expression and order.
template <class Sys, int T, typename F>
__device__ __forceinline__ void panel(WarpElement<Sys::NX, Sys::NU, T, F>& s,
                                      int t, F rho, int lane) {
  constexpr int NX = Sys::NX, N = NX + Sys::NU;
  static_assert(2 * N <= 32, "a row of L_t and of S_{t+1} a lane");
  const bool lrow = lane < N;
  const bool srow = !lrow && lane < 2 * N && t < T - 1;
  const int i = lrow ? lane : lane - N;  // the row
  F a[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    F v = F(0);
    if (lrow) {
      if (j <= i) v = s.L[t][tri(i, j)];
    } else if (srow) {
      v = (i < NX && !(t == 0 && j < NX)) ? -rho * s.G[t][i][j] : F(0);
    }
    a[j] = v;
  }
  // Every lane runs every step and keeps what its row takes by a select,
  // so the column's shuffles go out back to back, not one a branch.
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const F piv =
        sqrt(max_keep_nan(__shfl_sync(kFullWarp, a[k], k), F(1e-30)));
    const F q = a[k] / piv;
    a[k] = (lrow && i > k) || srow ? q : (lrow && i == k) ? piv : a[k];
    F l[N];  // L_jk of the later rows j
#pragma unroll
    for (int j = k + 1; j < N; ++j) l[j] = __shfl_sync(kFullWarp, a[k], j);
#pragma unroll
    for (int j = k + 1; j < N; ++j) {
      const F v = a[j] - a[k] * l[j];
      a[j] = (lrow && j <= i) || srow ? v : a[j];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (lrow && j <= i) s.L[t][tri(i, j)] = a[j];
    if (srow) s.S[t][i][j] = a[j];
  }
  __syncwarp();
}

// The block-tridiagonal solve of the Newton system on one warp: forward y_t
// = L_t⁻¹ (grad_t − S_t y_{t−1}), backward d_t = L_t⁻ᵀ (y_t − S_{t+1}ᵀ
// d_{t+1}), and d ← −d into s.d. Lane i forms row i of a stage's
// right-hand side; then every lane holds all of it and solves the stage's
// triangle whole (y_i = v_i / L_ii, then v_k −= L_ki·y_i for the later
// rows, as the column-by-column solve orders them), so the previous
// stage's solution stays in registers for the next stage's product.
template <class Sys, int T, typename F>
__device__ __forceinline__ void solve(WarpElement<Sys::NX, Sys::NU, T, F>& s,
                                      int lane) {
  constexpr int N = Sys::NX + Sys::NU;
  F x[N];  // y_{t−1} going forward, d_{t+1} going back
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = F(0);
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const F* Lt = s.L[t];
    F v = F(0);
    if (lane < N) {
      v = s.grad[t][lane];
      if (t > 0) {
#pragma unroll
        for (int k = 0; k < N; ++k) v = v - s.S[t - 1][lane][k] * x[k];
      }
    }
    F r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __shfl_sync(kFullWarp, v, i);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[i] = r[i] / Lt[tri(i, i)];
#pragma unroll
      for (int k = i + 1; k < N; ++k) r[k] = r[k] - Lt[tri(k, i)] * x[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (lane == i) s.d[t][i] = x[i];
  }
  __syncwarp();
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const F* Lt = s.L[t];
    F v = F(0);
    if (lane < N) {
      v = s.d[t][lane];
      if (t < T - 1) {
#pragma unroll
        for (int k = 0; k < N; ++k) v = v - s.S[t][k][lane] * x[k];
      }
    }
    F r[N];
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __shfl_sync(kFullWarp, v, i);
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      x[i] = r[i] / Lt[tri(i, i)];
#pragma unroll
      for (int k = 0; k < i; ++k) r[k] = r[k] - Lt[tri(i, k)] * x[i];
    }
    __syncwarp();  // every lane has read y_t before it becomes −d_t
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (lane == i) s.d[t][i] = -x[i];
  }
}

template <class Sys, int T, typename F, int W>
__global__ void __launch_bounds__(32 * W * elements_per_block<W>())
al_warp_kernel(typename Sys::template Params<F> p, const F* __restrict__ Cd_g,
               const F* __restrict__ c_g, const F* __restrict__ x0_g,
               const F* __restrict__ xi_g, const F* __restrict__ ui_g,
               const F* __restrict__ lamd_g, const F* __restrict__ lamh_g,
               const F* __restrict__ laml_g, const F* __restrict__ rho_g,
               F* __restrict__ w_out, F* __restrict__ lamd_out,
               F* __restrict__ lamh_out, F* __restrict__ laml_out,
               F* __restrict__ res_out, int B, int al_iter, int n_newton,
               int n_ls, F rho_factor, F rho_max, F reg,
               Box<F, Sys::NU> box) {
  constexpr int NX = Sys::NX, NU = Sys::NU, N = NX + NU;
  constexpr int NT = 32 * W;  // the element's threads
  using E = WarpElement<NX, NU, T, F>;
  constexpr int NP = E::NP;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x % NT;
  const int lane = tid & 31;
  const bool lead = tid < 32;  // warp 0 of the element
  const int e = blockIdx.x * elements_per_block<W>() + threadIdx.x / NT;
  if (e >= B) return;  // the element's threads alike: no barrier waits
  E& s = reinterpret_cast<E*>(smem)[threadIdx.x / NT];
  const size_t eT = static_cast<size_t>(e) * T;

  // ---- load, x₀ pinned, the step at each stage ----
  for (int k = tid; k < T * N; k += NT) {
    const int t = k / N, i = k % N;
    s.Cd[t][i] = Cd_g[eT * N + k];
    s.cv[t][i] = c_g[eT * N + k];
    s.w[t][i] = i < NX ? xi_g[(eT + t) * NX + i] : ui_g[(eT + t) * NU + i - NX];
  }
  for (int k = tid; k < T * NU; k += NT) {
    s.lamh[k / NU][k % NU] = lamh_g[eT * NU + k];
    s.laml[k / NU][k % NU] = laml_g[eT * NU + k];
  }
  for (int k = tid; k < (T - 1) * NX; k += NT)
    s.lamd[k / NX][k % NX] = lamd_g[static_cast<size_t>(e) * (T - 1) * NX + k];
  if (tid < NX) s.x0[tid] = x0_g[static_cast<size_t>(e) * NX + tid];
  element_sync<W>();
  if (tid < NX) s.w[0][tid] = s.x0[tid];
  F rho = rho_g[e];
  element_sync<W>();
  element_steps<Sys, T, F>(p, s, tid, NT);
  element_sync<W>();

  for (int it = 0; it < al_iter; ++it) {
    // the current merit from the steps of w (s.f), on every thread
    F merit_cur = merit_constraints_of<Sys, T, F>(s, s.f, F(0), false, rho,
                                                  box);
    {
      F cost = F(0);
      for (int k = lane; k < T * N; k += 32) {
        const int t = k / N, i = k % N;
        cost = cost + F(0.5) * s.Cd[t][i] * s.w[t][i] * s.w[t][i] +
               s.cv[t][i] * s.w[t][i];
      }
      merit_cur = merit_cur + warp_sum(cost);
    }
    element_sync<W>();  // every thread has read s.f before it changes

    for (int nt = 0; nt < n_newton; ++nt) {
      // ---- the Jacobian columns and the steps at every stage ----
      for (int k = tid; k < (T - 1) * (N + 1); k += NT) {
        if (k < (T - 1) * N) {
          const int t = k / N, j = k % N;
          const Vec<F, NX> col =
              rk4_column<Sys, F>(p, stage<Sys, T, F>(s, t, F(0), false), j);
#pragma unroll
          for (int i = 0; i < NX; ++i) s.G[t][i][j] = col.v[i];
        } else {
          const int t = k - (T - 1) * N;
          const Vec<F, NX> f =
              rk4_value<Sys, F>(p, stage<Sys, T, F>(s, t, F(0), false));
#pragma unroll
          for (int i = 0; i < NX; ++i) s.f[t][i] = f.v[i];
        }
      }
      element_sync<W>();
      // ---- D_t of every stage, and the merit gradient ----
      // D_t = diag(Cd_t) + ρ (GᵀG [t<T-1] + [I 0; 0 mask_t]), pinned x₀
      // rows/columns at t = 0 (into s.L[t]); the gradient cost' + Jᵀ(λ +
      // ρ r) with v_t = λ_t + ρ (x_{t+1} − f_t), x₀ pinned
      for (int k = tid; k < T * NP + T * N; k += NT) {
        if (k < T * NP) {
          const int t = k / NP;
          int i, j;
          untri(k % NP, i, j);
          F v = F(0);
          if (i == j) {
            F mask = F(0);
            if (i >= NX) {
              const F rh = s.w[t][i] - box.hi[i - NX];
              const F rl = box.lo[i - NX] - s.w[t][i];
              mask = F(rh > F(0) ? 1 : 0) + F(rl > F(0) ? 1 : 0);
            }
            v = s.Cd[t][i] + (i < NX ? rho : rho * mask);
          }
          if (t < T - 1) {
            F acc = F(0);
#pragma unroll
            for (int q = 0; q < NX; ++q)
              acc = acc + s.G[t][q][i] * s.G[t][q][j];
            v = v + rho * acc;
          }
          if (t == 0 && j < NX) v = i == j ? F(1) : F(0);
          s.L[t][k % NP] = v;
        } else {
          const int t = (k - T * NP) / N, i = (k - T * NP) % N;
          F g = s.Cd[t][i] * s.w[t][i] + s.cv[t][i];
          if (i < NX && t > 0)
            g = g + (s.lamd[t - 1][i] + rho * (s.w[t][i] - s.f[t - 1][i]));
          if (t < T - 1) {
#pragma unroll
            for (int q = 0; q < NX; ++q)
              g = g - s.G[t][q][i] *
                          (s.lamd[t][q] + rho * (s.w[t + 1][q] - s.f[t][q]));
          }
          if (i >= NX) {
            const int c = i - NX;
            const F rh = s.w[t][i] - box.hi[c];
            const F rl = box.lo[c] - s.w[t][i];
            g = g + s.lamh[t][c] + rho * max_keep_nan(rh, F(0)) -
                s.laml[t][c] - rho * max_keep_nan(rl, F(0));
          }
          s.grad[t][i] = (t == 0 && i < NX) ? F(0) : g;
        }
      }
      element_sync<W>();

      // ---- Newton direction: block Cholesky, stage by stage ----
#pragma unroll 1
      for (int t = 0; t < T; ++t) {
        for (int k = tid; k < NP; k += NT) {  // D_t − S_t S_tᵀ + reg·I
          int i, j;
          untri(k, i, j);
          F acc = s.L[t][k];
          if (t > 0) {
#pragma unroll
            for (int q = 0; q < N; ++q)
              acc = acc - s.S[t - 1][i][q] * s.S[t - 1][j][q];
          }
          s.L[t][k] = i == j ? acc + reg : acc;
        }
        element_sync<W>();
        if (lead) panel<Sys, T, F>(s, t, rho, lane);
        element_sync<W>();
      }
      if (lead) solve<Sys, T, F>(s, lane);
      element_sync<W>();

      // ---- line search over a = 2⁻ᵏ, cost term as a polynomial in a ----
      F q0 = F(0), q1 = F(0), q2 = F(0);
      F best_m = F(FLT_MAX);
      int best_k = n_ls;
      if (lead) {
        for (int k = lane; k < T * N; k += 32) {
          const int t = k / N, i = k % N;
          const F wv = s.w[t][i], dv = s.d[t][i], cd = s.Cd[t][i];
          q0 = q0 + F(0.5) * cd * wv * wv + s.cv[t][i] * wv;
          q1 = q1 + (cd * wv + s.cv[t][i]) * dv;
          q2 = q2 + F(0.5) * cd * dv * dv;
        }
        q0 = warp_sum(q0);
        q1 = warp_sum(q1);
        q2 = warp_sum(q2);
      }
      for (int k0 = 0; k0 < n_ls; k0 += kLsChunk) {
        const int nk = min(kLsChunk, n_ls - k0);
        for (int q = tid; q < nk * (T - 1); q += NT) {
          const int kk = q / (T - 1), t = q % (T - 1);
          const F a = F(ldexpf(1.0f, -(k0 + kk)));  // float32 step
          const Vec<F, NX> f =
              rk4_value<Sys, F>(p, stage<Sys, T, F>(s, t, a, true));
#pragma unroll
          for (int i = 0; i < NX; ++i) s.fls[kk][t][i] = f.v[i];
        }
        element_sync<W>();
        if (lead && lane < nk) {
          const int k = k0 + lane;
          const F a = F(ldexpf(1.0f, -k));
          const F mk = q0 + a * q1 + (a * a) * q2 +
                       merit_constraints_of<Sys, T, F>(s, s.fls[lane], a,
                                                       true, rho, box);
          if (mk < best_m) {
            best_m = mk;
            best_k = k;
          }
        }
        element_sync<W>();
      }
      if (lead) {
        line_search_pick<32, F>(kFullWarp, best_m, best_k);
        if (lane == 0) {
          s.pick_m = best_m;
          s.pick_k = best_k;
        }
      }
      element_sync<W>();
      best_m = s.pick_m;
      best_k = s.pick_k;
      if (best_m < merit_cur) {  // the same on every thread
        const F a = best_k < n_ls ? F(ldexpf(1.0f, -best_k)) : F(0);
        for (int k = tid; k < T * N; k += NT) {
          const int t = k / N, i = k % N;
          if (!(t == 0 && i < NX)) s.w[t][i] = s.w[t][i] + a * s.d[t][i];
        }
        merit_cur = best_m;
      }
      element_sync<W>();
    }

    // ---- AL outer update ----
    element_steps<Sys, T, F>(p, s, tid, NT);
    element_sync<W>();
    for (int k = tid; k < (T - 1) * NX; k += NT) {
      const int t = k / NX, i = k % NX;
      s.lamd[t][i] = s.lamd[t][i] + rho * (s.w[t + 1][i] - s.f[t][i]);
    }
    for (int k = tid; k < T * NU; k += NT) {
      const int t = k / NU, i = k % NU;
      const F rh = s.w[t][NX + i] - box.hi[i];
      const F rl = box.lo[i] - s.w[t][NX + i];
      s.lamh[t][i] = max_keep_nan(s.lamh[t][i] + rho * rh, F(0));
      s.laml[t][i] = max_keep_nan(s.laml[t][i] + rho * rl, F(0));
    }
    const F rho_next = rho * rho_factor;
    rho = rho_next < rho_max ? rho_next : rho_max;
    element_sync<W>();
  }

  // ---- outputs (s.f holds the step at each stage of w) ----
  if (tid == 0) {  // the residual norm in the one-lane kernel's order
    F res2 = F(0);
#pragma unroll
    for (int t = 0; t < T - 1; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const F r = s.w[t + 1][i] - s.f[t][i];
        res2 = res2 + r * r;
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const F ch = max_keep_nan(s.w[t][NX + i] - box.hi[i], F(0));
        const F cl = max_keep_nan(box.lo[i] - s.w[t][NX + i], F(0));
        res2 = res2 + ch * ch + cl * cl;
      }
    }
    res_out[e] = sqrt(res2);
  }
  for (int k = tid; k < T * N; k += NT) w_out[eT * N + k] = s.w[k / N][k % N];
  for (int k = tid; k < T * NU; k += NT) {
    lamh_out[eT * NU + k] = s.lamh[k / NU][k % NU];
    laml_out[eT * NU + k] = s.laml[k / NU][k % NU];
  }
  for (int k = tid; k < (T - 1) * NX; k += NT)
    lamd_out[static_cast<size_t>(e) * (T - 1) * NX + k] = s.lamd[k / NX][k % NX];
}

// Shared memory of the (Sys, T, F, W) instantiation: bytes an element and a
// block, and the most a block may ask of the current device.
template <class Sys, int T, typename F, int W>
int warp_smem(int* per_element, int* per_block, int* device_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *per_element = static_cast<int>(sizeof(WarpElement<Sys::NX, Sys::NU, T, F>));
  *per_block = *per_element * elements_per_block<W>();
  return static_cast<int>(err);
}

// One launch of the (Sys, T, F, W) instantiation; params are Sys's
// host-folded double constants (Sys::load).
template <class Sys, int T, typename F, int W>
int launch_warp(const Args& a, int B, int al_iter, int n_newton, int n_ls,
                double rho_factor, double rho_max, double reg,
                const double* params, const double* u_lo, const double* u_hi,
                cudaStream_t s) {
  static_assert(log2_warps<W>() >= 0, "W is 1, 2 or 4");
  Box<F, Sys::NU> box;
  for (int i = 0; i < Sys::NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
  }
  int per_element = 0, per_block = 0, device_max = 0;
  cudaError_t err = static_cast<cudaError_t>(
      warp_smem<Sys, T, F, W>(&per_element, &per_block, &device_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_block > device_max)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(al_warp_kernel<Sys, T, F, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int EPB = elements_per_block<W>();
  const int blocks = (B + EPB - 1) / EPB;
  al_warp_kernel<Sys, T, F, W><<<blocks, 32 * W * EPB, per_block, s>>>(
      Sys::template load<F>(params), static_cast<const F*>(a.Cd),
      static_cast<const F*>(a.c), static_cast<const F*>(a.x0),
      static_cast<const F*>(a.xi), static_cast<const F*>(a.ui),
      static_cast<const F*>(a.lamd), static_cast<const F*>(a.lamh),
      static_cast<const F*>(a.laml), static_cast<const F*>(a.rho),
      static_cast<F*>(a.w), static_cast<F*>(a.lamd_o),
      static_cast<F*>(a.lamh_o), static_cast<F*>(a.laml_o),
      static_cast<F*>(a.res), B, al_iter, n_newton, n_ls,
      static_cast<F>(rho_factor), static_cast<F>(rho_max),
      static_cast<F>(reg), box);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dqmpc

// The AL solve of one model on the warp layout, with AL_FUSED_ENTRY's
// arguments; log2G is log₂ of the element's threads, 5 + log₂W. Returns a
// cudaError_t code: cudaErrorInvalidValue for an unbuilt (T, W),
// cudaErrorInvalidConfiguration when a block's shared memory exceeds what
// the device allows. The cases name the built (T, W): AL_WARP_CASE(T, Sys,
// F, W).
#define AL_WARP_ENTRY(NAME, F, ...)                                           \
  extern "C" int NAME(                                                        \
      const void* Cd, const void* c, const void* x0, const void* xi,          \
      const void* ui, const void* lamd, const void* lamh, const void* laml,   \
      const void* rho, void* w, void* lamd_o, void* lamh_o, void* laml_o,     \
      void* res, int B, int log2G, int T, int al_iter, int n_newton,          \
      int n_ls, double rho_factor, double rho_max, double reg,                \
      const double* params, const double* u_lo, const double* u_hi,           \
      void* stream) {                                                         \
    dqmpc::Args a{Cd, c, x0, xi, ui, lamd, lamh, laml, rho,                   \
                  w, lamd_o, lamh_o, laml_o, res};                            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    __VA_ARGS__                                                               \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

#define AL_WARP_CASE(TT, Sys, F, W)                                           \
  if (T == TT && log2G == 5 + dqmpc::log2_warps<W>())                         \
    return dqmpc::launch_warp<Sys, TT, F, W>(a, B, al_iter, n_newton, n_ls,   \
                                             rho_factor, rho_max, reg,        \
                                             params, u_lo, u_hi, s);

// Shared memory of the (T, W, dtype) instantiation (see dqmpc::warp_smem);
// log2G as the launch's.
#define AL_WARP_SMEM_ENTRY(NAME, ...)                                         \
  extern "C" int NAME(int T, int log2G, int* per_element, int* per_block,     \
                      int* device_max) {                                      \
    __VA_ARGS__                                                               \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }
#define AL_WARP_SMEM_CASE(TT, Sys, F, W)                      \
  if (T == TT && log2G == 5 + dqmpc::log2_warps<W>())         \
    return dqmpc::warp_smem<Sys, TT, F, W>(per_element, per_block, \
                                           device_max);
