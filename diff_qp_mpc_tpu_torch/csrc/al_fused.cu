// K2: the whole augmented-Lagrangian MPC solve, one thread per batch element.
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
// minimum wins, started at float32's max (:223-235); a step accepted only if
// it beats the current merit, the incumbent kept bit-exact otherwise
// (:250-263); λ_hi/λ_lo clamped at 0 and ρ ← min(ρ·factor, rho_max)
// (:298-308); res = ‖[r_dyn; max(r_hi,0); max(r_lo,0)]‖ (:317-327). The
// TPU's batch padding (:393-404) is not needed: the batch edge is masked.
//
// Templates: the model functor (step and its exact Jacobian as device
// functions; the pendulum here, other models join as functors), the horizon
// T and the scalar type. Budgets, rho_factor, rho_max, reg and the box
// bounds are run-time arguments.
//
// Bound on the H100: ~2·10⁴ flops and ~0.5 KB per element at the main
// path's budget (T 5, al_iter 2, n_newton 4, n_ls 20), so the card's bound
// is the operations; at B = 64..256 elements the launch fills two SMs at
// most and each thread runs one long serial chain, so it is latency-bound.
// Spreading an element over a warp (candidates in parallel) is later work.
#include <cfloat>
#include <cmath>
#include <cstddef>

#include "bt_common.cuh"

namespace dqmpc {

// Pendulum (diff_qp_mpc_tpu/models/pendulum.py), semi-implicit Euler:
// θ̈ = (τ + m g l sin θ)/(m l²). mgl = m·g·l and ml2 = m·l² are folded on the
// host in double precision, as the reference's Python constants are.
template <typename F>
struct PendulumDyn {
  static constexpr int NX = 2;
  static constexpr int NU = 1;
  F dt, mgl, ml2;

  __device__ __forceinline__ void step(const F* x, const F* u, F* xn) const {
    const F thddot = (u[0] + mgl * sin(x[0])) / ml2;
    const F new_thdot = x[1] + thddot * dt;
    xn[0] = x[0] + new_thdot * dt;
    xn[1] = new_thdot;
  }

  // A = ∂f/∂x, B = ∂f/∂u, in the order forward-mode differentiation of
  // step() evaluates them.
  __device__ __forceinline__ void jac(const F* x, const F* /*u*/,
                                      F (&A)[NX][NX], F (&B)[NX][NU]) const {
    const F d_thdot = mgl * cos(x[0]) / ml2 * dt;
    A[0][0] = F(1) + d_thdot * dt;
    A[0][1] = dt;
    A[1][0] = d_thdot;
    A[1][1] = F(1);
    const F b1 = F(1) / ml2 * dt;
    B[0][0] = b1 * dt;
    B[1][0] = b1;
  }
};

template <typename F, int NU>
struct Box {
  F lo[NU];
  F hi[NU];
};

// AL dynamics and bound terms of the merit (everything but the quadratic
// cost): Σ λ_d r_d + ρ/2 r_d² + Σ λ_h r_h + λ_l r_l + ρ/2 (max(r_h,0)² +
// max(r_l,0)²).
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

template <class M, int T, typename F>
__global__ void __launch_bounds__(64)
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
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
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
      F best_m = F(FLT_MAX), best_a = F(0);
      for (int k = 0; k < n_ls; ++k) {
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
          best_a = a;
        }
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

  // ---- outputs ----
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

template <int T, typename F>
int launch_pendulum(const Args& a, int B, int al_iter, int n_newton, int n_ls,
                    double rho_factor, double rho_max, double reg,
                    const double* params, const double* u_lo,
                    const double* u_hi, cudaStream_t s) {
  using M = PendulumDyn<F>;
  M model{static_cast<F>(params[0]), static_cast<F>(params[1]),
          static_cast<F>(params[2])};
  Box<F, M::NU> box;
  for (int i = 0; i < M::NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
  }
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  al_fused_kernel<M, T, F><<<blocks, threads, 0, s>>>(
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

}  // namespace dqmpc

// Pendulum AL solve. Inputs (contiguous, batch-major): Cd, c [B,T,3],
// x0 [B,2], x_init [B,T,2], u_init [B,T,1], lam_dyn [B,T-1,2], lam_hi,
// lam_lo [B,T,1], rho0 [B]; outputs w [B,T,3], lam_dyn, lam_hi, lam_lo,
// res [B]. params = (dt, m·g·l, m·l²); u_lo/u_hi hold nu = 1 host values.
// Returns a cudaError_t code; cudaErrorInvalidValue for an unbuilt T.
#define AL_FUSED_ENTRY(NAME, F, ...)                                          \
  extern "C" int NAME(                                                        \
      const void* Cd, const void* c, const void* x0, const void* xi,          \
      const void* ui, const void* lamd, const void* lamh, const void* laml,   \
      const void* rho, void* w, void* lamd_o, void* lamh_o, void* laml_o,     \
      void* res, int B, int T, int al_iter, int n_newton, int n_ls,           \
      double rho_factor, double rho_max, double reg, const double* params,    \
      const double* u_lo, const double* u_hi, void* stream) {                 \
    dqmpc::Args a{Cd, c, x0, xi, ui, lamd, lamh, laml, rho,                   \
                  w, lamd_o, lamh_o, laml_o, res};                            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    switch (T) { __VA_ARGS__ }                                                \
    return static_cast<int>(cudaErrorInvalidValue);                          \
  }

#define AL_FUSED_CASE(TT, F)                                                  \
  case TT:                                                                    \
    return dqmpc::launch_pendulum<TT, F>(a, B, al_iter, n_newton, n_ls,       \
                                         rho_factor, rho_max, reg, params,    \
                                         u_lo, u_hi, s);

AL_FUSED_ENTRY(al_fused_pendulum_f32, float,
               AL_FUSED_CASE(5, float) AL_FUSED_CASE(10, float))
AL_FUSED_ENTRY(al_fused_pendulum_f64, double, AL_FUSED_CASE(5, double))
