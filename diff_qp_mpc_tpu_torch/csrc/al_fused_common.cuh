// K2: the whole augmented-Lagrangian MPC solve, a group of G lanes per batch
// element (G = 1, 2, 4, ..., 32, a template parameter chosen per launch).
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/al_fused_pallas.py::
// fused_al_solve (_al_kernel). Per element, with its state in registers:
// al_iter outer iterations of { n_newton damped Newton steps on the AL merit
// (rollout and exact Jacobians from the model functor, merit gradient,
// Gauss-Newton blocks built lazily inside the block-tridiagonal Cholesky
// sweep, x₀ pinned, an n_ls-candidate 2⁻ᵏ line search), then the λ/ρ
// updates }. Returns the trajectory, the multipliers and the residual norm.
//
// Semantics kept from the Pallas kernel (line numbers in al_fused_pallas.py):
// x₀ pinned in w, the gradient and the D/O blocks (:61-62, :179-199); the
// candidate cost as the polynomial q0 + a·q1 + a²·q2, exact because d[0][:nx]
// = 0 (:205-221); a strict `<` running minimum over k = 0..n_ls-1, first
// minimum wins, started at float32's max (ls_body, :223-233, and :235); a
// step accepted only if it beats the current merit, the incumbent kept
// bit-exact otherwise (:250-263); λ_hi/λ_lo clamped at 0 and ρ ← min(ρ·factor,
// rho_max) (:298-308); res = ‖[r_dyn; max(r_hi,0); max(r_lo,0)]‖ (:317-327).
// The TPU's batch padding (:393-404) is not needed: the batch edge is masked.
//
// Templates: the model functor (NX, NU, kRoundedMerit, step and its
// exact Jacobian as device functions), the horizon T, the scalar type and
// the group width G (as log₂G). Budgets, rho_factor, rho_max, reg, the box
// bounds and the model's constants are run-time arguments. Each model has a translation
// unit of its own that includes this header and instantiates its (T, dtype,
// G): al_fused.cu (the pendulum), al_fused_integrator.cu,
// al_fused_cartpole1l.cu and al_fused_cartpole2l.cu, so nvcc builds them in
// parallel.
//
// Bound on the H100: ~2·10⁴ flops and ~0.5 KB per element at the main
// path's budget (T 5, al_iter 2, n_newton 4, n_ls 20), so the card's bound
// is the operations. At B = 64..4096 a launch fills few of the 132 SMs and
// each element is one long serial chain, so it is latency-bound; the
// longest independent part of that chain is the line search's n_ls
// candidates (57% of the time on a filled card). So each element runs on a
// group of G lanes of one warp: every lane runs the whole Newton chain in its
// own registers (no shuffles, no shared memory, so no lane waits on
// another), lane ℓ evaluates the candidates k ≡ ℓ (mod G), and a butterfly
// over the group picks the line search's result (see line_search_pick). The
// arithmetic per candidate is the same source at every G, and the outputs at
// every G are bit-identical to G = 1, which compiles to the
// one-thread-per-element kernel (no group index, no shuffle). The wrapper
// picks G from B and the card's resident threads at each G's register count
// (ops/al_fused_cuda.py); a filled card takes G = 1, where replicating the
// Newton chain would cost G× the thread slots.
#pragma once

#include <cfloat>
#include <cmath>
#include <cstddef>

#include "bt_common.cuh"

namespace dqmpc {

template <typename F, int NU>
struct Box {
  F lo[NU];
  F hi[NU];
};

// A product that nvcc never contracts into a multiply-add with the sum it
// feeds.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// AL dynamics and bound terms of the merit (everything but the quadratic
// cost): Σ λ_d r_d + ρ/2 r_d² + Σ λ_h r_h + λ_l r_l + ρ/2 (max(r_h,0)² +
// max(r_l,0)²). Where the model functor sets kRoundedMerit, the dynamics
// term's products are rounded before they are summed, as the plain
// version's are: with nvcc's default contraction of that term into
// multiply-adds, the cp1 checkpoint's float32 closed loop on the fused path
// lost a fifth of its episodes (PERF.md PR 7). The pendulum's functor
// leaves it unset and keeps its contracted, PR 6 rounding.
template <class M, int T, typename F>
__device__ __forceinline__ F merit_constraints(
    const M& model, const F (&w)[T][M::NX + M::NU],
    const F (&lam_d)[T - 1][M::NX], const F (&lam_h)[T][M::NU],
    const F (&lam_l)[T][M::NU], F rho, const Box<F, M::NU>& box) {
  constexpr int NX = M::NX, NU = M::NU;
  F m = F(0);
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
    F f[NX];
    model.step(w[t], w[t] + NX, f);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const F r = w[t + 1][i] - f[i];
      if constexpr (M::kRoundedMerit)
        m = m + mul_rn(lam_d[t][i], r) + mul_rn(mul_rn(F(0.5) * rho, r), r);
      else
        m = m + lam_d[t][i] * r + F(0.5) * rho * r * r;
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const F rh = w[t][NX + i] - box.hi[i];
      const F rl = box.lo[i] - w[t][NX + i];
      const F ch = max_keep_nan(rh, F(0));
      const F cl = max_keep_nan(rl, F(0));
      m = m + lam_h[t][i] * rh + lam_l[t][i] * rl +
          F(0.5) * rho * (ch * ch + cl * cl);
    }
  }
  return m;
}

// The line search's pick over a group of G lanes. The serial rule (ls_body,
// al_fused_pallas.py:223-233, started at :235) scans k = 0..n_ls-1 with
// best_m = float32's max, best_a = 0 and keeps candidate k when
// m_k < best_m: the first k of least merit among the m_k below float32's
// max, NaN never kept (NaN < x is false), and a = 0 when none is. Here each
// lane has scanned its own k ≡ ℓ (mod G) in ascending order by that rule,
// holding (best_m, best_k) with best_k = n_ls for "none"; a recorded m is
// below float32's max and never NaN, so (m, k) is totally ordered, and the
// butterfly below leaves every lane of the group with the least (m, k) in
// lexicographic order. That is the serial rule's pick: its least merit, and
// among equal merits (−0 == +0 included) its first k. mask names the
// group's lanes only.
template <int G, typename F>
__device__ __forceinline__ void line_search_pick(unsigned mask, F& best_m,
                                                 int& best_k) {
#pragma unroll
  for (int s = 1; s < G; s <<= 1) {
    const F om = __shfl_xor_sync(mask, best_m, s);
    const int ok = __shfl_xor_sync(mask, best_k, s);
    if (om < best_m || (om == best_m && ok < best_k)) {
      best_m = om;
      best_k = ok;
    }
  }
}

// threads per block; a multiple of 32, so every group lies within a warp
constexpr int kThreads = 64;

template <class M, int T, typename F, int LOG2G>
__global__ void __launch_bounds__(kThreads)
al_fused_kernel(M model, const F* __restrict__ Cd_g, const F* __restrict__ c_g,
                const F* __restrict__ x0_g, const F* __restrict__ xi_g,
                const F* __restrict__ ui_g, const F* __restrict__ lamd_g,
                const F* __restrict__ lamh_g, const F* __restrict__ laml_g,
                const F* __restrict__ rho_g, F* __restrict__ w_out,
                F* __restrict__ lamd_out, F* __restrict__ lamh_out,
                F* __restrict__ laml_out, F* __restrict__ res_out, int B,
                int al_iter, int n_newton, int n_ls, F rho_factor, F rho_max,
                F reg, Box<F, M::NU> box) {
  constexpr int NX = M::NX, NU = M::NU, N = NX + NU;
  // G = 2^LOG2G lanes per element, G | 32 and blocks of 64 threads, so a
  // group lies within one warp. Every lane of a group has the same e, so
  // the groups past the batch edge exit whole and no shuffle waits on them.
  constexpr int G = 1 << LOG2G;
  static_assert(LOG2G >= 0 && LOG2G <= 5, "a group lies within one warp");
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int e = tid >> LOG2G;
  const int lane = tid & (G - 1);
  if (e >= B) return;
  constexpr unsigned kGroupBits =
      G == 32 ? 0xffffffffu : (1u << (G & 31)) - 1u;
  const unsigned group_mask = kGroupBits << ((threadIdx.x & 31) & ~(G - 1));
  const size_t eTN = static_cast<size_t>(e) * T * N;

  F x0[NX], w[T][N], Cd[T][N], cv[T][N];
  F lam_d[T - 1][NX], lam_h[T][NU], lam_l[T][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x0[i] = x0_g[static_cast<size_t>(e) * NX + i];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Cd[t][i] = Cd_g[eTN + t * N + i];
      cv[t][i] = c_g[eTN + t * N + i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
      w[t][i] = xi_g[(static_cast<size_t>(e) * T + t) * NX + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      w[t][NX + i] = ui_g[(static_cast<size_t>(e) * T + t) * NU + i];
      lam_h[t][i] = lamh_g[(static_cast<size_t>(e) * T + t) * NU + i];
      lam_l[t][i] = laml_g[(static_cast<size_t>(e) * T + t) * NU + i];
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      lam_d[t][i] = lamd_g[(static_cast<size_t>(e) * (T - 1) + t) * NX + i];
  }
  F rho = rho_g[e];
#pragma unroll
  for (int i = 0; i < NX; ++i) w[0][i] = x0[i];  // pin x₀

  for (int it = 0; it < al_iter; ++it) {
    F merit_cur = merit_constraints<M, T, F>(model, w, lam_d, lam_h, lam_l,
                                             rho, box);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        merit_cur = merit_cur + F(0.5) * Cd[t][i] * w[t][i] * w[t][i] +
                    cv[t][i] * w[t][i];
    }

    for (int nt = 0; nt < n_newton; ++nt) {
      // ---- dynamics, Jacobians, residuals ----
      F A[T - 1][NX][NX], Bj[T - 1][NX][NU], vd[T - 1][NX];
      F mask[T][NU];  // m_hi + m_lo: 1 where a bound is active
      F grad[T][N];
#pragma unroll
      for (int t = 0; t < T - 1; ++t) {
        F f[NX];
        model.step(w[t], w[t] + NX, f);
        model.jac(w[t], w[t] + NX, A[t], Bj[t]);
#pragma unroll
        for (int i = 0; i < NX; ++i)
          vd[t][i] = lam_d[t][i] + rho * (w[t + 1][i] - f[i]);
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i) grad[t][i] = Cd[t][i] * w[t][i] + cv[t][i];
      }
      // ---- merit gradient: cost' + Jᵀ(λ + ρ r_clamped) ----
#pragma unroll
      for (int t = 0; t < T - 1; ++t) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          F acc = grad[t][i];
#pragma unroll
          for (int k = 0; k < NX; ++k) acc = acc - A[t][k][i] * vd[t][k];
          grad[t][i] = acc;
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          F acc = grad[t][NX + i];
#pragma unroll
          for (int k = 0; k < NX; ++k) acc = acc - Bj[t][k][i] * vd[t][k];
          grad[t][NX + i] = acc;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) grad[t + 1][i] = grad[t + 1][i] + vd[t][i];
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          const F rh = w[t][NX + i] - box.hi[i];
          const F rl = box.lo[i] - w[t][NX + i];
          mask[t][i] = F(rh > F(0) ? 1 : 0) + F(rl > F(0) ? 1 : 0);
          const F ch = max_keep_nan(rh, F(0));
          const F cl = max_keep_nan(rl, F(0));
          grad[t][NX + i] = grad[t][NX + i] + lam_h[t][i] + rho * ch -
                            lam_l[t][i] - rho * cl;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) grad[0][i] = F(0);  // pin x₀

      // ---- Newton direction: block Cholesky with D/O built per stage ----
      // D_t = diag(Cd_t) + ρ (GᵀG [t<T-1] + [I 0; 0 mask_t]); O_t = -ρ [A B; 0 0]
      auto build_D = [&](int t, F (&Dt)[N][N]) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = 0; j < N; ++j) Dt[i][j] = F(0);
          Dt[i][i] = Cd[t][i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) Dt[i][i] = Dt[i][i] + rho;
#pragma unroll
        for (int i = 0; i < NU; ++i)
          Dt[NX + i][NX + i] = Dt[NX + i][NX + i] + rho * mask[t][i];
        if (t < T - 1) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
#pragma unroll
            for (int j = 0; j <= i; ++j) {
              F acc = F(0);
#pragma unroll
              for (int k = 0; k < NX; ++k) {
                const F gi = i < NX ? A[t][k][i] : Bj[t][k][i - NX];
                const F gj = j < NX ? A[t][k][j] : Bj[t][k][j - NX];
                acc = acc + gi * gj;
              }
              Dt[i][j] = Dt[i][j] + rho * acc;
              if (i != j) Dt[j][i] = Dt[j][i] + rho * acc;
            }
          }
        }
        if (t == 0) {  // pinned x₀ rows/columns, identity diagonal
#pragma unroll
          for (int i = 0; i < NX; ++i) {
#pragma unroll
            for (int j = 0; j < N; ++j) {
              Dt[i][j] = F(0);
              Dt[j][i] = F(0);
            }
            Dt[i][i] = F(1);
          }
        }
      };
      auto build_O = [&](int t, F (&Ot)[N][N]) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            F g = F(0);
            if (i < NX && !(t == 0 && j < NX))
              g = -rho * (j < NX ? A[t][i][j] : Bj[t][i][j - NX]);
            Ot[i][j] = g;
          }
        }
      };

      F L[T][N][N], S[T][N][N], Mt[N][N], y[T][N], v[N];
      build_D(0, Mt);
#pragma unroll
      for (int i = 0; i < N; ++i) Mt[i][i] = Mt[i][i] + reg;
      chol<N, F>(Mt, L[0]);
#pragma unroll
      for (int t = 1; t < T; ++t) {
        F Ot[N][N];
        build_O(t - 1, Ot);
        solve_lower_mat<N, F>(L[t - 1], Ot, S[t]);
        build_D(t, Mt);
        schur_update<N, F>(Mt, S[t], reg);
        chol<N, F>(Mt, L[t]);
      }
      solve_lower_vec<N, F>(L[0], grad[0], y[0]);
#pragma unroll
      for (int t = 1; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          F s = grad[t][i];
#pragma unroll
          for (int k = 0; k < N; ++k) s = s - S[t][i][k] * y[t - 1][k];
          v[i] = s;
        }
        solve_lower_vec<N, F>(L[t], v, y[t]);
      }
      F d[T][N];
      solve_upper_vec<N, F>(L[T - 1], y[T - 1], d[T - 1]);
#pragma unroll
      for (int t = T - 2; t >= 0; --t) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          F s = y[t][i];
#pragma unroll
          for (int k = 0; k < N; ++k) s = s - S[t + 1][k][i] * d[t + 1][k];
          v[i] = s;
        }
        solve_upper_vec<N, F>(L[t], v, d[t]);
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i) d[t][i] = -d[t][i];
      }

      // ---- line search over a = 2⁻ᵏ, cost term as a polynomial in a ----
      F q0 = F(0), q1 = F(0), q2 = F(0);
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          q0 = q0 + F(0.5) * Cd[t][i] * w[t][i] * w[t][i] + cv[t][i] * w[t][i];
          q1 = q1 + (Cd[t][i] * w[t][i] + cv[t][i]) * d[t][i];
          q2 = q2 + F(0.5) * Cd[t][i] * d[t][i] * d[t][i];
        }
      }
      // this lane's candidates k ≡ lane (mod G), then the group's pick; at
      // G = 1 the lane keeps best_a itself, as the serial rule does
      F best_m = F(FLT_MAX), best_a = F(0);
      int best_k = n_ls;
      for (int k = lane; k < n_ls; k += G) {
        const F a = F(ldexpf(1.0f, -k));  // float32 step, as the reference
        F wk[T][N];
#pragma unroll
        for (int t = 0; t < T; ++t) {
#pragma unroll
          for (int i = 0; i < N; ++i) wk[t][i] = w[t][i] + a * d[t][i];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) wk[0][i] = x0[i];
        const F mk = q0 + a * q1 + (a * a) * q2 +
                     merit_constraints<M, T, F>(model, wk, lam_d, lam_h, lam_l,
                                                rho, box);
        if (mk < best_m) {
          best_m = mk;
          if constexpr (G == 1)
            best_a = a;
          else
            best_k = k;
        }
      }
      if constexpr (G > 1) {
        line_search_pick<G, F>(group_mask, best_m, best_k);
        best_a = best_k < n_ls ? F(ldexpf(1.0f, -best_k)) : F(0);
      }
      const bool better = best_m < merit_cur;
      const F a_sel = better ? best_a : F(0);
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if (better && !(t == 0 && i < NX)) w[t][i] = w[t][i] + a_sel * d[t][i];
        }
      }
      merit_cur = better ? best_m : merit_cur;
    }

    // ---- AL outer update ----
#pragma unroll
    for (int t = 0; t < T - 1; ++t) {
      F f[NX];
      model.step(w[t], w[t] + NX, f);
#pragma unroll
      for (int i = 0; i < NX; ++i)
        lam_d[t][i] = lam_d[t][i] + rho * (w[t + 1][i] - f[i]);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const F rh = w[t][NX + i] - box.hi[i];
        const F rl = box.lo[i] - w[t][NX + i];
        lam_h[t][i] = max_keep_nan(lam_h[t][i] + rho * rh, F(0));
        lam_l[t][i] = max_keep_nan(lam_l[t][i] + rho * rl, F(0));
      }
    }
    const F rho_next = rho * rho_factor;
    rho = rho_next < rho_max ? rho_next : rho_max;
  }

  // ---- outputs, from lane 0 of the group (no shuffle follows) ----
  if (lane != 0) return;
  F res2 = F(0);
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
    F f[NX];
    model.step(w[t], w[t] + NX, f);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const F r = w[t + 1][i] - f[i];
      res2 = res2 + r * r;
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const F ch = max_keep_nan(w[t][NX + i] - box.hi[i], F(0));
      const F cl = max_keep_nan(box.lo[i] - w[t][NX + i], F(0));
      res2 = res2 + ch * ch + cl * cl;
    }
  }
  res_out[e] = sqrt(res2);
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < N; ++i) w_out[eTN + t * N + i] = w[t][i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lamh_out[(static_cast<size_t>(e) * T + t) * NU + i] = lam_h[t][i];
      laml_out[(static_cast<size_t>(e) * T + t) * NU + i] = lam_l[t][i];
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i)
      lamd_out[(static_cast<size_t>(e) * (T - 1) + t) * NX + i] = lam_d[t][i];
  }
}

struct Args {
  const void *Cd, *c, *x0, *xi, *ui, *lamd, *lamh, *laml, *rho;
  void *w, *lamd_o, *lamh_o, *laml_o, *res;
};

// One launch of the (MT<F>, T, G = 2^LOG2G) instantiation; MT<F>::make
// builds the model functor from its host-folded double constants.
template <template <typename> class MT, int T, typename F, int LOG2G>
int launch(const Args& a, int B, int al_iter, int n_newton, int n_ls,
           double rho_factor, double rho_max, double reg,
           const double* params, const double* u_lo, const double* u_hi,
           cudaStream_t s) {
  using M = MT<F>;
  const M model = M::make(params);
  Box<F, M::NU> box;
  for (int i = 0; i < M::NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
  }
  const long long threads_total = static_cast<long long>(B) << LOG2G;
  const int blocks =
      static_cast<int>((threads_total + kThreads - 1) / kThreads);
  al_fused_kernel<M, T, F, LOG2G><<<blocks, kThreads, 0, s>>>(
      model, static_cast<const F*>(a.Cd), static_cast<const F*>(a.c),
      static_cast<const F*>(a.x0), static_cast<const F*>(a.xi),
      static_cast<const F*>(a.ui), static_cast<const F*>(a.lamd),
      static_cast<const F*>(a.lamh), static_cast<const F*>(a.laml),
      static_cast<const F*>(a.rho), static_cast<F*>(a.w),
      static_cast<F*>(a.lamd_o), static_cast<F*>(a.lamh_o),
      static_cast<F*>(a.laml_o), static_cast<F*>(a.res), B, al_iter, n_newton,
      n_ls, static_cast<F>(rho_factor), static_cast<F>(rho_max),
      static_cast<F>(reg), box);
  return static_cast<int>(cudaGetLastError());
}

// Threads of this instantiation the current device holds resident at once:
// blocks per SM at its register count × kThreads × SMs.
template <template <typename> class MT, int T, typename F, int LOG2G>
int resident_threads(int* out) {
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, al_fused_kernel<MT<F>, T, F, LOG2G>, kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = blocks * kThreads * sms;
  return static_cast<int>(err);
}

// The instantiation for a run-time log2G (0..5): launch or
// resident_threads at G = 2^log2G, cudaErrorInvalidValue outside 0..5.
template <template <typename> class MT, int T, typename F, typename... A>
int launch_group(int log2G, A... args) {
  switch (log2G) {
    case 0: return launch<MT, T, F, 0>(args...);
    case 1: return launch<MT, T, F, 1>(args...);
    case 2: return launch<MT, T, F, 2>(args...);
    case 3: return launch<MT, T, F, 3>(args...);
    case 4: return launch<MT, T, F, 4>(args...);
    case 5: return launch<MT, T, F, 5>(args...);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <template <typename> class MT, int T, typename F>
int resident_group(int log2G, int* out) {
  switch (log2G) {
    case 0: return resident_threads<MT, T, F, 0>(out);
    case 1: return resident_threads<MT, T, F, 1>(out);
    case 2: return resident_threads<MT, T, F, 2>(out);
    case 3: return resident_threads<MT, T, F, 3>(out);
    case 4: return resident_threads<MT, T, F, 4>(out);
    case 5: return resident_threads<MT, T, F, 5>(out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---- forward-mode numbers and RK4 model functors ----
//
// CUDA has no tracer, so a model whose step is a closed form gets its exact
// Jacobian by forward-mode differentiation: Dual<F> carries a value and one
// tangent, and the model's ODE is a template on its scalar S (F or
// Dual<F>). Rk4Dyn<Sys, F>::jac runs the step once per input column with a
// unit seed, as the TPU kernel's jax.jvp per column does
// (al_fused_pallas.py:104-120). Each operation mirrors models/dual.py's
// Dual (the plain version), so both do the same arithmetic. A constant
// operand (F) has no tangent and costs no operation on it.
template <typename F>
struct Dual {
  F v, d;
};

template <typename F>
__device__ __forceinline__ Dual<F> operator+(Dual<F> a, Dual<F> b) {
  return {a.v + b.v, a.d + b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator+(Dual<F> a, F b) {
  return {a.v + b, a.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator+(F a, Dual<F> b) {
  return {a + b.v, b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator-(Dual<F> a, Dual<F> b) {
  return {a.v - b.v, a.d - b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator-(Dual<F> a, F b) {
  return {a.v - b, a.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator-(F a, Dual<F> b) {
  return {a - b.v, -b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator-(Dual<F> a) {
  return {-a.v, -a.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator*(Dual<F> a, Dual<F> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator*(Dual<F> a, F b) {
  return {a.v * b, a.d * b};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator*(F a, Dual<F> b) {
  return {a * b.v, a * b.d};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator/(Dual<F> a, Dual<F> b) {
  const F v = a.v / b.v;
  return {v, (a.d - v * b.d) / b.v};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator/(Dual<F> a, F b) {
  return {a.v / b, a.d / b};
}
template <typename F>
__device__ __forceinline__ Dual<F> operator/(F a, Dual<F> b) {
  const F v = a / b.v;
  return {v, -(v * b.d) / b.v};
}

// sin and cos of a scalar or a dual
template <typename F>
__device__ __forceinline__ F sin_of(F a) {
  return sin(a);
}
template <typename F>
__device__ __forceinline__ Dual<F> sin_of(Dual<F> a) {
  return {sin(a.v), cos(a.v) * a.d};
}
template <typename F>
__device__ __forceinline__ F cos_of(F a) {
  return cos(a);
}
template <typename F>
__device__ __forceinline__ Dual<F> cos_of(Dual<F> a) {
  return {cos(a.v), -(sin(a.v) * a.d)};
}

template <typename F, int N>
struct Vec {
  F v[N];
};

// One RK4 step of Sys's ODE: Sys provides NX, NU, Params<F> (its constants,
// with dt, h = dt/2 and dt6 = dt/6) and ode<S>(p, x, u, ẋ). The order is
// models/cartpole.py's rk4_parts.
template <class Sys, typename S, typename F>
__device__ __forceinline__ void rk4(const typename Sys::template Params<F>& p,
                                    const S* x, const S* u, S* xn) {
  constexpr int NX = Sys::NX;
  S k1[NX], k2[NX], k3[NX], k4[NX], xt[NX];
  Sys::ode(p, x, u, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + p.h * k1[i];
  Sys::ode(p, xt, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + p.h * k2[i];
  Sys::ode(p, xt, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) xt[i] = x[i] + p.dt * k3[i];
  Sys::ode(p, xt, u, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    xn[i] = x[i] + p.dt6 * (k1[i] + F(2) * k2[i] + F(2) * k3[i] + k4[i]);
}

// The step and one Jacobian column are device functions that are called,
// not inlined: a kernel calls them at every stage of every loop, and
// inlined RK4 bodies at every call site (7 columns × 4 ODE evaluations at
// each of T − 1 stages, and the merit's steps) made each instantiation too
// large to compile in reasonable time. One copy per (Sys, F) serves every
// (T, G) instantiation of a translation unit.
template <class Sys, typename F>
__device__ __noinline__ Vec<F, Sys::NX> rk4_value(
    typename Sys::template Params<F> p, Vec<F, Sys::NX + Sys::NU> xu) {
  Vec<F, Sys::NX> out;
  rk4<Sys, F, F>(p, xu.v, xu.v + Sys::NX, out.v);
  return out;
}

// ∂ step / ∂ (x, u)_j: the step on duals seeded with the unit vector e_j.
template <class Sys, typename F>
__device__ __noinline__ Vec<F, Sys::NX> rk4_column(
    typename Sys::template Params<F> p, Vec<F, Sys::NX + Sys::NU> xu,
    int j) {
  constexpr int NX = Sys::NX, NU = Sys::NU;
  Dual<F> x[NX], u[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = {xu.v[i], F(i == j ? 1 : 0)};
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = {xu.v[NX + i], F(NX + i == j ? 1 : 0)};
  rk4<Sys, Dual<F>, F>(p, x, u, xn);
  Vec<F, NX> out;
#pragma unroll
  for (int i = 0; i < NX; ++i) out.v[i] = xn[i].d;
  return out;
}

// K2's model functor for an RK4 system (see PendulumDyn in al_fused.cu for
// the interface): make() casts the host-folded double constants to F.
template <class Sys, typename F>
struct Rk4Dyn {
  static constexpr int NX = Sys::NX;
  static constexpr int NU = Sys::NU;
  static constexpr bool kRoundedMerit = true;
  typename Sys::template Params<F> p;

  static Rk4Dyn make(const double* params) {
    return {Sys::template load<F>(params)};
  }

  __device__ __forceinline__ void step(const F* x, const F* u, F* xn) const {
    Vec<F, NX + NU> xu;
#pragma unroll
    for (int i = 0; i < NX; ++i) xu.v[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) xu.v[NX + i] = u[i];
    const Vec<F, NX> r = rk4_value<Sys, F>(p, xu);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = r.v[i];
  }

  // One call site for all columns: the loop over j stays rolled, and
  // column j is written by a select in every (unrolled) column slot, so A
  // and B stay in registers.
  __device__ __forceinline__ void jac(const F* x, const F* u, F (&A)[NX][NX],
                                      F (&B)[NX][NU]) const {
    Vec<F, NX + NU> xu;
#pragma unroll
    for (int i = 0; i < NX; ++i) xu.v[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) xu.v[NX + i] = u[i];
#pragma unroll 1
    for (int j = 0; j < NX + NU; ++j) {
      const Vec<F, NX> col = rk4_column<Sys, F>(p, xu, j);
#pragma unroll
      for (int k = 0; k < NX + NU; ++k) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          if (k < NX)
            A[i][k] = k == j ? col.v[i] : A[i][k];
          else
            B[i][k - NX] = k == j ? col.v[i] : B[i][k - NX];
        }
      }
    }
  }
};

}  // namespace dqmpc

// The AL solve of one model. Inputs (contiguous, batch-major, n = NX + NU):
// Cd, c [B,T,n], x0 [B,NX], x_init [B,T,NX], u_init [B,T,NU], lam_dyn
// [B,T-1,NX], lam_hi, lam_lo [B,T,NU], rho0 [B]; outputs w [B,T,n],
// lam_dyn, lam_hi, lam_lo, res [B]. 2^log2G lanes per element (log2G 0..5);
// params are the model's host-folded constants (its functor's make());
// u_lo/u_hi hold NU host values. Returns a cudaError_t code;
// cudaErrorInvalidValue for an unbuilt T or a log2G outside 0..5. The
// cases name the built horizons: AL_FUSED_CASE(T, MT, F).
#define AL_FUSED_ENTRY(NAME, F, ...)                                          \
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
    switch (T) { __VA_ARGS__ }                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

#define AL_FUSED_CASE(TT, MT, F)                                              \
  case TT:                                                                    \
    return dqmpc::launch_group<MT, TT, F>(log2G, a, B, al_iter, n_newton,     \
                                          n_ls, rho_factor, rho_max, reg,     \
                                          params, u_lo, u_hi, s);

// A case of the one-lane kernel at G 1 only, for the host build of a source
// whose card kernel is the warp layout (utils/k2_host.py defines K2_HOST):
// the same functor, to bisect its and the merit's rounding off the card.
#define AL_HOST_CASE(TT, MT, F)                                               \
  case TT:                                                                    \
    return log2G == 0 ? dqmpc::launch<MT, TT, F, 0>(                          \
                            a, B, al_iter, n_newton, n_ls, rho_factor,        \
                            rho_max, reg, params, u_lo, u_hi, s)              \
                      : static_cast<int>(cudaErrorInvalidValue);

// Resident threads of the (T, dtype, 2^log2G) instantiation on the current
// device (see dqmpc::resident_threads), into *out. Returns a cudaError_t
// code.
#define AL_RESIDENT_ENTRY(NAME, ...)                                          \
  extern "C" int NAME(int T, int log2G, int* out) {                           \
    switch (T) { __VA_ARGS__ }                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }
#define AL_RESIDENT_CASE(TT, MT, F) \
  case TT:                          \
    return dqmpc::resident_group<MT, TT, F>(log2G, out);

