// K4: the whole interior-point solve of the box-constrained trajectory QP,
// one thread per batch element.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/trajqp_fused_pallas.py::
// fused_trajqp_solve (_trajqp_kernel) at the shapes whose element fits a
// thread, (T, nx, nu) = (5, 2, 1), (5, 3, 1), (5, 3, 2) and (5, 4, 1); the
// larger ones run on trajqp_fused_warp.cu. Per element, with its state in
// registers, max_iter Mehrotra predictor-corrector iterations of
//   min Σₜ ½ wₜᵀCₜwₜ + cₜᵀwₜ  s.t.  x_{t+1} = Aₜxₜ + Bₜuₜ + fₜ, x₀ = x0,
//                                   u_lo ≤ u ≤ u_hi:
// the KKT residuals; the box block eliminated analytically (Cuu_eff = Cuu +
// diag(z_hi/s_hi + z_lo/s_lo), gu gains the (z r_p − r_s)/s terms); the
// predictor and the centering-corrector Riccati solves (riccati_solve of
// riccati_common.cuh, K3's recursion); fraction-to-boundary steps with 0.99
// damping and the min_slack clamps; best-iterate tracking, and the final
// comparison after the loop. Returns x, u, λ, z_hi, z_lo, s_hi, s_lo and the
// best residual total.
//
// Semantics kept from the Pallas kernel (line numbers in
// trajqp_fused_pallas.py), which differ from the scan IPM of
// solvers/trajqp.py: u clipped to [u_lo + 1e-3, u_hi − 1e-3] again inside
// (:64), the clip constants folded in double precision as the reference's
// Python floats are; `big` = float32's max in every dtype (:60), also the
// initial best total (:270); σ's denominator floored at 1e-30 (:233); the
// best total replaced with a select, not a minimum (:213), the output total
// a NaN-propagating minimum (:281). min and max keep NaNs as jnp's do.
//
// Templates: T, NX, NU and the scalar type; max_iter, reg, min_slack and
// the box are run-time arguments. The TPU's batch padding (identity cost on
// padded elements, :323-331) is not needed: the batch edge is masked.
//
// Bound on the H100: ~2.2·10⁴ flops and ~0.6 KB (float32) per element at the
// ip path's budget (T 5, nx 2, nu 1, max_iter 12), so the card's bound is
// the operations; at 64 elements a launch occupies one SM and each thread
// runs one long serial chain, so it is latency-bound. The state and the
// stage blocks exceed the 255 registers a thread may hold, so part of them
// lives in local memory (L1). Serving an element with a group of lanes, its
// state in shared memory, removes the spills but was measured slower at every
// batch timed: three quarters of this kernel's time is the chain of IEEE
// divisions and square roots, which the lanes do not shorten (PERF.md,
// Findings).
#include <cfloat>
#include <cmath>
#include <cstddef>

#include "riccati_common.cuh"

namespace dqmpc {

// min(a, b) that keeps a NaN, as jnp.minimum does.
template <typename F>
__device__ __forceinline__ F min_keep_nan(F a, F b) {
  return (a != a || a < b) ? a : b;
}

template <typename F, int NU>
struct IPBox {
  F lo[NU], hi[NU];            // the box
  F lo_clip[NU], hi_clip[NU];  // u_lo + 1e-3, u_hi − 1e-3
};

template <int T, int NX, int NU, typename F>
struct IPState {
  F x[T][NX], u[T][NU], lam[T][NX];
  F zh[T][NU], zl[T][NU], sh[T][NU], sl[T][NU];
};

template <int T, int NX, int NU, typename F>
struct IPResiduals {
  F rx[T][NX], ru[T][NU], rdyn[T - 1][NX], rinit[NX];
  F rph[T][NU], rpl[T][NU], rsh[T][NU], rsl[T][NU];
};

template <int T, int NX, int NU, typename F>
struct IPStep {
  F dx[T][NX], du[T][NU], dl[T][NX];
  F dsh[T][NU], dsl[T][NU], dzh[T][NU], dzl[T][NU];
};

// The QP's data: stage blocks, gradients, offsets, x0.
template <int T, int NX, int NU, typename F>
struct IPProblem {
  LQRProblem<T, NX, NU, F> lqr;
  F Cuu[T][NU][NU], cx[T][NX], cu[T][NU], f[T - 1][NX], x0[NX];
};

template <int T, int NX, int NU, typename F>
__device__ __forceinline__ void residuals(
    const IPProblem<T, NX, NU, F>& P, const IPBox<F, NU>& box,
    const IPState<T, NX, NU, F>& s, IPResiduals<T, NX, NU, F>& r) {
  const auto& Q = P.lqr;
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      F acc = P.cx[t][i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc + Q.Cxx[t][i][k] * s.x[t][k];
#pragma unroll
      for (int k = 0; k < NU; ++k) acc = acc + Q.Cxu[t][i][k] * s.u[t][k];
      r.rx[t][i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      F acc = P.cu[t][i] + s.zh[t][i] - s.zl[t][i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc + Q.Cxu[t][k][i] * s.x[t][k];
#pragma unroll
      for (int k = 0; k < NU; ++k) acc = acc + P.Cuu[t][i][k] * s.u[t][k];
      r.ru[t][i] = acc;
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
    const F(&nu_d)[NX] = s.lam[t + 1];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      F acc = r.rx[t][i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc - Q.A[t][k][i] * nu_d[k];
      r.rx[t][i] = acc;
      r.rx[t + 1][i] = r.rx[t + 1][i] + nu_d[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      F acc = r.ru[t][i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc - Q.B[t][k][i] * nu_d[k];
      r.ru[t][i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) r.rx[0][i] = r.rx[0][i] + s.lam[0][i];
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      F acc = s.x[t + 1][i] - P.f[t][i];
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc - Q.A[t][i][k] * s.x[t][k];
#pragma unroll
      for (int k = 0; k < NU; ++k) acc = acc - Q.B[t][i][k] * s.u[t][k];
      r.rdyn[t][i] = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) r.rinit[i] = s.x[0][i] - P.x0[i];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      r.rph[t][i] = s.u[t][i] - box.hi[i] + s.sh[t][i];
      r.rpl[t][i] = box.lo[i] - s.u[t][i] + s.sl[t][i];
      r.rsh[t][i] = s.sh[t][i] * s.zh[t][i];
      r.rsl[t][i] = s.sl[t][i] * s.zl[t][i];
    }
  }
}

template <int R, int C, typename F>
__device__ __forceinline__ F sq_sum(const F (&a)[R][C]) {
  F s = F(0);
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) s = s + a[i][j] * a[i][j];
  }
  return s;
}

// (total, mu): ‖r_dyn‖ + ‖r_init‖ + ‖r_p_hi‖ + ‖r_p_lo‖ + ‖r_x‖ + ‖r_u‖
// + n_comp·|mu|, mu the mean complementarity.
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ F resid_norm(const IPResiduals<T, NX, NU, F>& r,
                                        F& mu) {
  const F n_comp = F(2 * T * NU);
  F m = F(0);
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) m = m + r.rsh[t][i] + r.rsl[t][i];
  }
  mu = m / n_comp;
  F init2 = F(0);
#pragma unroll
  for (int i = 0; i < NX; ++i) init2 = init2 + r.rinit[i] * r.rinit[i];
  const F pri = sqrt(sq_sum(r.rdyn)) + sqrt(init2) + sqrt(sq_sum(r.rph)) +
                sqrt(sq_sum(r.rpl));
  const F dual = sqrt(sq_sum(r.rx)) + sqrt(sq_sum(r.ru));
  return pri + dual + n_comp * fabs(mu);
}

// Eliminate the box rows, solve the Riccati KKT system, recover (ds, dz).
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ void kkt_step(
    const IPProblem<T, NX, NU, F>& P, const IPState<T, NX, NU, F>& s,
    const IPResiduals<T, NX, NU, F>& r, F reg, IPStep<T, NX, NU, F>& d) {
  F Cuu_eff[T][NU][NU], gu[T][NU], neg_rdyn[T - 1][NX], neg_rinit[NX];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) Cuu_eff[t][i][j] = P.Cuu[t][i][j];
      const F dd = s.zh[t][i] / s.sh[t][i] + s.zl[t][i] / s.sl[t][i];
      Cuu_eff[t][i][i] = Cuu_eff[t][i][i] + dd;
      const F extra =
          (s.zh[t][i] * r.rph[t][i] - r.rsh[t][i]) / s.sh[t][i] -
          (s.zl[t][i] * r.rpl[t][i] - r.rsl[t][i]) / s.sl[t][i];
      gu[t][i] = r.ru[t][i] + extra;
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) neg_rdyn[t][i] = -r.rdyn[t][i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) neg_rinit[i] = -r.rinit[i];
  riccati_solve<T, NX, NU, F>(P.lqr, Cuu_eff, r.rx, gu, neg_rdyn, neg_rinit,
                              reg, d.dx, d.du, d.dl);
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      d.dsh[t][i] = -r.rph[t][i] - d.du[t][i];
      d.dsl[t][i] = -r.rpl[t][i] + d.du[t][i];
      d.dzh[t][i] = -(r.rsh[t][i] + s.zh[t][i] * d.dsh[t][i]) / s.sh[t][i];
      d.dzl[t][i] = -(r.rsl[t][i] + s.zl[t][i] * d.dsl[t][i]) / s.sl[t][i];
    }
  }
}

// Largest step in (0, 1] keeping v + a·dv ≥ 0, over s_hi, s_lo, z_hi, z_lo.
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ F max_step(const IPState<T, NX, NU, F>& s,
                                      const IPStep<T, NX, NU, F>& d) {
  const F big = F(FLT_MAX);
  F a = F(1);
  auto pair = [&](const F (&v)[T][NU], const F (&dv)[T][NU]) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const F step = dv[t][i] < F(0) ? -v[t][i] / dv[t][i] : big;
        a = min_keep_nan(a, step);
      }
    }
  };
  pair(s.sh, d.dsh);
  pair(s.sl, d.dsl);
  pair(s.zh, d.dzh);
  pair(s.zl, d.dzl);
  return a;
}

template <int T, int NX, int NU, typename F>
__global__ void __launch_bounds__(64)
trajqp_fused_kernel(const F* __restrict__ C_g, const F* __restrict__ c_g,
                    const F* __restrict__ A_g, const F* __restrict__ B_g,
                    const F* __restrict__ f_g, const F* __restrict__ x0_g,
                    const F* __restrict__ xi_g, const F* __restrict__ ui_g,
                    F* __restrict__ x_out, F* __restrict__ u_out,
                    F* __restrict__ lam_out, F* __restrict__ zh_out,
                    F* __restrict__ zl_out, F* __restrict__ sh_out,
                    F* __restrict__ sl_out, F* __restrict__ res_out, int Bsz,
                    int max_iter, F reg, F min_slack, IPBox<F, NU> box) {
  constexpr int N = NX + NU;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Bsz) return;
  const size_t E = static_cast<size_t>(e);

  // ---- load the QP ----
  IPProblem<T, NX, NU, F> P;
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const F* Ct = C_g + (E * T + t) * N * N;
    const F* ct = c_g + (E * T + t) * N;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      P.cx[t][i] = ct[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) P.lqr.Cxx[t][i][j] = Ct[i * N + j];
#pragma unroll
      for (int j = 0; j < NU; ++j) P.lqr.Cxu[t][i][j] = Ct[i * N + NX + j];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      P.cu[t][i] = ct[NX + i];
#pragma unroll
      for (int j = 0; j < NU; ++j) P.Cuu[t][i][j] = Ct[(NX + i) * N + NX + j];
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      P.f[t][i] = f_g[(E * (T - 1) + t) * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        P.lqr.A[t][i][j] = A_g[((E * (T - 1) + t) * NX + i) * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        P.lqr.B[t][i][j] = B_g[((E * (T - 1) + t) * NX + i) * NU + j];
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) P.x0[i] = x0_g[E * NX + i];

  // ---- initialization: interior (s, z) > 0, u clipped into the box ----
  IPState<T, NX, NU, F> s;
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      s.x[t][i] = xi_g[(E * T + t) * NX + i];
      s.lam[t][i] = F(0);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const F ui = ui_g[(E * T + t) * NU + i];
      s.u[t][i] = min_keep_nan(max_keep_nan(ui, box.lo_clip[i]),
                               box.hi_clip[i]);
      s.sh[t][i] = max_keep_nan(box.hi[i] - s.u[t][i], F(0.1));
      s.sl[t][i] = max_keep_nan(s.u[t][i] - box.lo[i], F(0.1));
      s.zh[t][i] = F(1);
      s.zl[t][i] = F(1);
    }
  }
  IPState<T, NX, NU, F> best = s;
  F b_tot = F(FLT_MAX);
  const F n_comp = F(2 * T * NU);

  for (int it = 0; it < max_iter; ++it) {
    IPResiduals<T, NX, NU, F> r;
    residuals(P, box, s, r);
    F mu;
    const F total = resid_norm(r, mu);
    const bool better = total < b_tot;
    if (better) best = s;
    b_tot = better ? total : b_tot;

    // ---- affine (predictor) ----
    IPStep<T, NX, NU, F> da;
    kkt_step(P, s, r, reg, da);
    const F a_aff = max_step(s, da);
    F mu_aff = F(0);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i)
        mu_aff = mu_aff +
                 (s.sh[t][i] + a_aff * da.dsh[t][i]) *
                     (s.zh[t][i] + a_aff * da.dzh[t][i]) +
                 (s.sl[t][i] + a_aff * da.dsl[t][i]) *
                     (s.zl[t][i] + a_aff * da.dzl[t][i]);
    }
    mu_aff = mu_aff / n_comp;
    const F ratio = mu_aff / max_keep_nan(mu, F(1e-30));
    const F smu = ratio * ratio * ratio * mu;

    // ---- centering-corrector: zero residuals but complementarity ----
    IPResiduals<T, NX, NU, F> rc;
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) rc.rx[t][i] = F(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        rc.ru[t][i] = F(0);
        rc.rph[t][i] = F(0);
        rc.rpl[t][i] = F(0);
        rc.rsh[t][i] = da.dsh[t][i] * da.dzh[t][i] - smu;
        rc.rsl[t][i] = da.dsl[t][i] * da.dzl[t][i] - smu;
      }
    }
#pragma unroll
    for (int t = 0; t < T - 1; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) rc.rdyn[t][i] = F(0);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) rc.rinit[i] = F(0);
    IPStep<T, NX, NU, F> d;
    kkt_step(P, s, rc, reg, d);

    // ---- combined step ----
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        d.dx[t][i] = da.dx[t][i] + d.dx[t][i];
        d.dl[t][i] = da.dl[t][i] + d.dl[t][i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        d.du[t][i] = da.du[t][i] + d.du[t][i];
        d.dsh[t][i] = da.dsh[t][i] + d.dsh[t][i];
        d.dsl[t][i] = da.dsl[t][i] + d.dsl[t][i];
        d.dzh[t][i] = da.dzh[t][i] + d.dzh[t][i];
        d.dzl[t][i] = da.dzl[t][i] + d.dzl[t][i];
      }
    }
    const F alpha = F(0.99) * max_step(s, d);
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        s.x[t][i] = s.x[t][i] + alpha * d.dx[t][i];
        s.lam[t][i] = s.lam[t][i] + alpha * d.dl[t][i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        s.u[t][i] = s.u[t][i] + alpha * d.du[t][i];
        s.zh[t][i] = max_keep_nan(s.zh[t][i] + alpha * d.dzh[t][i], min_slack);
        s.zl[t][i] = max_keep_nan(s.zl[t][i] + alpha * d.dzl[t][i], min_slack);
        s.sh[t][i] = max_keep_nan(s.sh[t][i] + alpha * d.dsh[t][i], min_slack);
        s.sl[t][i] = max_keep_nan(s.sl[t][i] + alpha * d.dsl[t][i], min_slack);
      }
    }
  }

  // ---- final best-iterate comparison ----
  IPResiduals<T, NX, NU, F> r;
  residuals(P, box, s, r);
  F mu;
  const F total = resid_norm(r, mu);
  const bool better = total < b_tot;
  const IPState<T, NX, NU, F>& o = better ? s : best;
  res_out[e] = min_keep_nan(total, b_tot);
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x_out[(E * T + t) * NX + i] = o.x[t][i];
      lam_out[(E * T + t) * NX + i] = o.lam[t][i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const size_t k = (E * T + t) * NU + i;
      u_out[k] = o.u[t][i];
      zh_out[k] = o.zh[t][i];
      zl_out[k] = o.zl[t][i];
      sh_out[k] = o.sh[t][i];
      sl_out[k] = o.sl[t][i];
    }
  }
}

struct TrajQPArgs {
  const void *C, *c, *A, *B, *f, *x0, *xi, *ui;
  void *x, *u, *lam, *zh, *zl, *sh, *sl, *res;
};

template <int T, int NX, int NU, typename F>
int launch(const TrajQPArgs& a, int Bsz, int max_iter, double reg,
           double min_slack, const double* u_lo, const double* u_hi,
           cudaStream_t s) {
  IPBox<F, NU> box;
  for (int i = 0; i < NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
    box.lo_clip[i] = static_cast<F>(u_lo[i] + 1e-3);
    box.hi_clip[i] = static_cast<F>(u_hi[i] - 1e-3);
  }
  const int threads = 64;
  const int blocks = (Bsz + threads - 1) / threads;
  trajqp_fused_kernel<T, NX, NU, F><<<blocks, threads, 0, s>>>(
      static_cast<const F*>(a.C), static_cast<const F*>(a.c),
      static_cast<const F*>(a.A), static_cast<const F*>(a.B),
      static_cast<const F*>(a.f), static_cast<const F*>(a.x0),
      static_cast<const F*>(a.xi), static_cast<const F*>(a.ui),
      static_cast<F*>(a.x), static_cast<F*>(a.u), static_cast<F*>(a.lam),
      static_cast<F*>(a.zh), static_cast<F*>(a.zl), static_cast<F*>(a.sh),
      static_cast<F*>(a.sl), static_cast<F*>(a.res), Bsz, max_iter,
      static_cast<F>(reg), static_cast<F>(min_slack), box);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(const TrajQPArgs& a, int Bsz, int T, int nx, int nu,
             int max_iter, double reg, double min_slack, const double* u_lo,
             const double* u_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 5 && nx == 2 && nu == 1)
    return launch<5, 2, 1, F>(a, Bsz, max_iter, reg, min_slack, u_lo, u_hi,
                              s);
  if (T == 5 && nx == 3 && nu == 1)
    return launch<5, 3, 1, F>(a, Bsz, max_iter, reg, min_slack, u_lo, u_hi,
                              s);
  if (T == 5 && nx == 3 && nu == 2)
    return launch<5, 3, 2, F>(a, Bsz, max_iter, reg, min_slack, u_lo, u_hi,
                              s);
  if (T == 5 && nx == 4 && nu == 1)
    return launch<5, 4, 1, F>(a, Bsz, max_iter, reg, min_slack, u_lo, u_hi,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dqmpc

// Inputs (contiguous, batch-major): C [B,T,n,n], c [B,T,n], A [B,T-1,nx,nx],
// B [B,T-1,nx,nu], f [B,T-1,nx], x0 [B,nx], x_init [B,T,nx], u_init
// [B,T,nu]; outputs x [B,T,nx], u [B,T,nu], lam [B,T,nx], z_hi, z_lo, s_hi,
// s_lo [B,T,nu], res [B]. u_lo/u_hi hold nu host values. Built for
// (T, nx, nu) = (5, 2, 1), (5, 3, 1), (5, 3, 2) and (5, 4, 1);
// cudaErrorInvalidValue otherwise (the cartpoles' (5, 5, 1)-(5, 7, 1) and
// the quadrotor's shapes run on trajqp_fused_warp.cu).
// Returns a cudaError_t code.
#define TRAJQP_ENTRY(NAME, F)                                                 \
  extern "C" int NAME(                                                        \
      const void* C, const void* c, const void* A, const void* B,             \
      const void* f, const void* x0, const void* xi, const void* ui, void* x, \
      void* u, void* lam, void* zh, void* zl, void* sh, void* sl, void* res,  \
      int Bsz, int T, int nx, int nu, int max_iter, double reg,               \
      double min_slack, const double* u_lo, const double* u_hi,               \
      void* stream) {                                                         \
    dqmpc::TrajQPArgs a{C, c, A, B, f, x0, xi, ui,                            \
                        x, u, lam, zh, zl, sh, sl, res};                      \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, max_iter, reg, min_slack,    \
                              u_lo, u_hi, stream);                            \
  }

TRAJQP_ENTRY(trajqp_fused_f32, float)
TRAJQP_ENTRY(trajqp_fused_f64, double)
