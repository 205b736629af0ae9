// K4 on the warp layout: the whole interior-point solve of the
// box-constrained trajectory QP with one warp per batch element and the
// element's blocks in shared memory.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/trajqp_fused_pallas.py::
// fused_trajqp_solve (_trajqp_kernel) at the shapes whose element does not
// fit one lane: the cartpoles' (T, nx, nu) = (5, 5, 1) (cp1's slew shape,
// CartpoleCosSin's ip path), (5, 6, 1) (cp2's ip path) and (5, 7, 1) (cp2's
// slew shape), the quadrotor's ip path (5, 12, 4) and its slew-augmented
// shape (5, 16, 4). trajqp_fused.cu keeps an element in one lane's
// registers, which at (5, 5, 1)-(5, 7, 1) spilled 4-121 KB a thread and ran
// 1.1-14× slower than this layout at B 64, 256 and 4096 in both dtypes on
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; those instantiations were
// then deleted); at nx 12, nu 4
// an element holds about 3,000 values (C's 5 × 16² blocks, A and B, the
// Riccati pass's P, K and k of every stage), at (5, 16, 4) about 5,000.
// Here the element lives in dynamic shared memory (WarpQP below: 5,364 B in
// float32 at (5, 6, 1), 20,304 B at (5, 12, 4), 30,048 B at (5, 16, 4),
// twice that in float64), kWarpsPerBlock elements a block, and the warp's
// lanes share its work:
//   - the residuals, a row a lane (each row's sum in the one-lane kernel's
//     order);
//   - each stage's Riccati work: the entries of P·A, P·B and P·r, then of
//     Q = Aᵀ(PA) + Cxx, Aᵀ(PB) + Cxu, Bᵀ(PB) + Cuu and q, then of the
//     symmetrized P update and p (up to 336 entries a stage over 32 lanes);
//     every lane factors the nu × nu Quu in registers and lane c solves K's
//     column c (lane nx solves k);
//   - the forward rollout, a row a lane, and the T·nu box terms;
//   - warp reductions (__shfl_xor_sync butterflies) for the residual norms,
//     μ, the fraction-to-boundary minimum and σ, which leave every lane
//     the same bits, so every lane takes the same branches.
// A __syncwarp separates each phase from the next that reads it.
//
// Semantics are trajqp_fused.cu's (its header lists the Pallas kernel's
// corner cases it keeps): u clipped to [u_lo + 1e-3, u_hi − 1e-3] inside,
// float32's max as `big` and as the initial best total in every dtype, σ's
// denominator floored at 1e-30, the best total replaced by a select, the
// output total a NaN-keeping minimum, min and max keeping NaNs. Each entry
// of a product, residual or Riccati block is summed in the one-lane
// kernel's order, but the norms, μ and σ's sums over the warp run in
// another order, so the two layouts agree to rounding, not bit for bit.
//
// Bound on the H100: ~1.4·10⁶ operations and ~10 KB of device memory an
// element in float32 at (5, 12, 4) and the ip budget (max_iter 12;
// benchmarks/flops.py k4_ops, k4_bytes), so the operations. At the ip
// path's B 64-128 a launch occupies one warp on each of a few dozen SMs
// and each element is a chain of some 800 warp-synchronized phases (about
// 30 in each of its 24 Riccati solves), so it is latency-bound.
#include <cfloat>
#include <cmath>
#include <cstddef>

#include "bt_common.cuh"

namespace dqmpc {

constexpr unsigned kFullWarp = 0xffffffffu;
// elements (warps) a block
constexpr int kWarpsPerBlock = 2;

// min(a, b) that keeps a NaN, as jnp.minimum does.
template <typename F>
__device__ __forceinline__ F min_keep_nan(F a, F b) {
  return (a != a || a < b) ? a : b;
}

// the sum over the warp, the same bits on every lane
template <typename F>
__device__ __forceinline__ F warp_sum(F v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = v + __shfl_xor_sync(kFullWarp, v, s);
  return v;
}

// the NaN-keeping minimum over the warp, the same on every lane
template <typename F>
__device__ __forceinline__ F warp_min(F v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    v = min_keep_nan(v, __shfl_xor_sync(kFullWarp, v, s));
  return v;
}

template <typename F, int NU>
struct WarpBox {
  F lo[NU], hi[NU];            // the box
  F lo_clip[NU], hi_clip[NU];  // u_lo + 1e-3, u_hi − 1e-3
};

template <int T, int NX, int NU, typename F>
struct WarpIterate {
  F x[T][NX], u[T][NU], lam[T][NX];
  F zh[T][NU], zl[T][NU], sh[T][NU], sl[T][NU];
};

template <int T, int NX, int NU, typename F>
struct WarpResiduals {
  F rx[T][NX], ru[T][NU], rdyn[T - 1][NX], rinit[NX];
  F rph[T][NU], rpl[T][NU], rsh[T][NU], rsl[T][NU];
};

template <int T, int NX, int NU, typename F>
struct WarpStep {
  F dx[T][NX], du[T][NU], dl[T][NX];
  F dsh[T][NU], dsl[T][NU], dzh[T][NU], dzl[T][NU];
};

// One element: the QP, the iterate and the best one, the residuals (the
// corrector's too), the affine and the combined step, and the Riccati
// solve's blocks (Cuu_eff and gu of the solve, every stage's K, k, P and p,
// and one stage's temporaries).
template <int T, int NX, int NU, typename F>
struct WarpQP {
  static constexpr int N = NX + NU;
  F C[T][N][N], c[T][N], A[T - 1][NX][NX], B[T - 1][NX][NU], f[T - 1][NX];
  F x0[NX];
  WarpIterate<T, NX, NU, F> s, best;
  WarpResiduals<T, NX, NU, F> r, rc;
  WarpStep<T, NX, NU, F> da, d;
  F Cuu[T][NU][NU], gu[T][NU];
  F K[T][NU][NX], k[T][NU], P[T][NX][NX], p[T][NX];
  F PA[NX][NX], PB[NX][NU], m[NX];
  F Qxx[NX][NX], Qxu[NX][NU], Quu[NU][NU], qx[NX], qu[NU];
};

// r = the KKT residuals of the iterate s, a row a lane.
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ void warp_residuals(
    WarpQP<T, NX, NU, F>& q, const WarpBox<F, NU>& box,
    const WarpIterate<T, NX, NU, F>& s, WarpResiduals<T, NX, NU, F>& r,
    int lane) {
  for (int e = lane; e < T * NX; e += 32) {
    const int t = e / NX, i = e % NX;
    F acc = q.c[t][i];
#pragma unroll
    for (int k = 0; k < NX; ++k) acc = acc + q.C[t][i][k] * s.x[t][k];
#pragma unroll
    for (int k = 0; k < NU; ++k) acc = acc + q.C[t][i][NX + k] * s.u[t][k];
    if (t >= 1) acc = acc + s.lam[t][i];
    if (t < T - 1) {
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc - q.A[t][k][i] * s.lam[t + 1][k];
    }
    if (t == 0) acc = acc + s.lam[0][i];
    r.rx[t][i] = acc;
  }
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    F acc = q.c[t][NX + i] + s.zh[t][i] - s.zl[t][i];
#pragma unroll
    for (int k = 0; k < NX; ++k) acc = acc + q.C[t][k][NX + i] * s.x[t][k];
#pragma unroll
    for (int k = 0; k < NU; ++k) acc = acc + q.C[t][NX + i][NX + k] * s.u[t][k];
    if (t < T - 1) {
#pragma unroll
      for (int k = 0; k < NX; ++k) acc = acc - q.B[t][k][i] * s.lam[t + 1][k];
    }
    r.ru[t][i] = acc;
    r.rph[t][i] = s.u[t][i] - box.hi[i] + s.sh[t][i];
    r.rpl[t][i] = box.lo[i] - s.u[t][i] + s.sl[t][i];
    r.rsh[t][i] = s.sh[t][i] * s.zh[t][i];
    r.rsl[t][i] = s.sl[t][i] * s.zl[t][i];
  }
  for (int e = lane; e < (T - 1) * NX; e += 32) {
    const int t = e / NX, i = e % NX;
    F acc = s.x[t + 1][i] - q.f[t][i];
#pragma unroll
    for (int k = 0; k < NX; ++k) acc = acc - q.A[t][i][k] * s.x[t][k];
#pragma unroll
    for (int k = 0; k < NU; ++k) acc = acc - q.B[t][i][k] * s.u[t][k];
    r.rdyn[t][i] = acc;
  }
  if (lane < NX) r.rinit[lane] = s.x[0][lane] - q.x0[lane];
  __syncwarp();
}

// (total, mu): ‖r_dyn‖ + ‖r_init‖ + ‖r_p_hi‖ + ‖r_p_lo‖ + ‖r_x‖ + ‖r_u‖
// + n_comp·|mu|, mu the mean complementarity; the same on every lane.
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ F warp_resid_norm(
    const WarpResiduals<T, NX, NU, F>& r, F& mu, int lane) {
  const F n_comp = F(2 * T * NU);
  F sx = F(0), sdyn = F(0), sinit = F(0);
  F su = F(0), sph = F(0), spl = F(0), sm = F(0);
  for (int e = lane; e < T * NX; e += 32) {
    const F v = r.rx[e / NX][e % NX];
    sx = sx + v * v;
  }
  for (int e = lane; e < (T - 1) * NX; e += 32) {
    const F v = r.rdyn[e / NX][e % NX];
    sdyn = sdyn + v * v;
  }
  if (lane < NX) sinit = r.rinit[lane] * r.rinit[lane];
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    su = su + r.ru[t][i] * r.ru[t][i];
    sph = sph + r.rph[t][i] * r.rph[t][i];
    spl = spl + r.rpl[t][i] * r.rpl[t][i];
    sm = sm + r.rsh[t][i] + r.rsl[t][i];
  }
  mu = warp_sum(sm) / n_comp;
  const F pri = sqrt(warp_sum(sdyn)) + sqrt(warp_sum(sinit)) +
                sqrt(warp_sum(sph)) + sqrt(warp_sum(spl));
  const F dual = sqrt(warp_sum(sx)) + sqrt(warp_sum(su));
  return pri + dual + n_comp * fabs(mu);
}

// Eliminate the box rows of the residuals r, solve the Riccati KKT system
// (riccati_common.cuh's riccati_solve, its arithmetic per entry), recover
// (ds, dz) into d.
template <int T, int NX, int NU, typename F>
__device__ void warp_kkt_step(WarpQP<T, NX, NU, F>& q,
                              const WarpResiduals<T, NX, NU, F>& r, F reg,
                              WarpStep<T, NX, NU, F>& d, int lane) {
  const WarpIterate<T, NX, NU, F>& s = q.s;
  for (int e = lane; e < T * NU * NU; e += 32) {
    const int t = e / (NU * NU), i = (e / NU) % NU, j = e % NU;
    F v = q.C[t][NX + i][NX + j];
    if (i == j) v = v + (s.zh[t][i] / s.sh[t][i] + s.zl[t][i] / s.sl[t][i]);
    q.Cuu[t][i][j] = v;
  }
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    const F extra = (s.zh[t][i] * r.rph[t][i] - r.rsh[t][i]) / s.sh[t][i] -
                    (s.zl[t][i] * r.rpl[t][i] - r.rsl[t][i]) / s.sl[t][i];
    q.gu[t][i] = r.ru[t][i] + extra;
  }
  __syncwarp();

  // ---- backward recursion, r_t = −r_dyn_t ----
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) {
      const F(&P)[NX][NX] = q.P[t + 1];
      for (int e = lane; e < NX * NX + NX * NU + NX; e += 32) {
        if (e < NX * NX) {  // PA = P·A
          const int i = e / NX, j = e % NX;
          F acc = P[i][0] * q.A[t][0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + P[i][k] * q.A[t][k][j];
          q.PA[i][j] = acc;
        } else if (e < NX * NX + NX * NU) {  // PB = P·B
          const int i = (e - NX * NX) / NU, j = (e - NX * NX) % NU;
          F acc = P[i][0] * q.B[t][0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + P[i][k] * q.B[t][k][j];
          q.PB[i][j] = acc;
        } else {  // m = P·r + p
          const int i = e - NX * NX - NX * NU;
          F acc = P[i][0] * -r.rdyn[t][0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + P[i][k] * -r.rdyn[t][k];
          q.m[i] = acc + q.p[t + 1][i];
        }
      }
      __syncwarp();
    }
    // Q blocks and q, reg on Quu's diagonal
    for (int e = lane; e < NX * NX + NX * NU + NU * NU + NX + NU; e += 32) {
      const bool last = t == T - 1;
      if (e < NX * NX) {
        const int i = e / NX, j = e % NX;
        F v = q.C[t][i][j];
        if (!last) {
          F acc = q.A[t][0][i] * q.PA[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + q.A[t][k][i] * q.PA[k][j];
          v = acc + v;
        }
        q.Qxx[i][j] = v;
      } else if (e < NX * NX + NX * NU) {
        const int i = (e - NX * NX) / NU, j = (e - NX * NX) % NU;
        F v = q.C[t][i][NX + j];
        if (!last) {
          F acc = q.A[t][0][i] * q.PB[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + q.A[t][k][i] * q.PB[k][j];
          v = acc + v;
        }
        q.Qxu[i][j] = v;
      } else if (e < NX * NX + NX * NU + NU * NU) {
        const int o = e - NX * NX - NX * NU;
        const int i = o / NU, j = o % NU;
        F v = q.Cuu[t][i][j];
        if (!last) {
          F acc = q.B[t][0][i] * q.PB[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + q.B[t][k][i] * q.PB[k][j];
          v = acc + v;
        }
        q.Quu[i][j] = i == j ? v + reg : v;
      } else if (e < NX * NX + NX * NU + NU * NU + NX) {
        const int i = e - NX * NX - NX * NU - NU * NU;
        F v = r.rx[t][i];
        if (!last) {
          F acc = q.A[t][0][i] * q.m[0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + q.A[t][k][i] * q.m[k];
          v = v + acc;
        }
        q.qx[i] = v;
      } else {
        const int i = e - NX * NX - NX * NU - NU * NU - NX;
        F v = q.gu[t][i];
        if (!last) {
          F acc = q.B[t][0][i] * q.m[0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + q.B[t][k][i] * q.m[k];
          v = v + acc;
        }
        q.qu[i] = v;
      }
    }
    __syncwarp();
    // K = −Quu⁻¹ Qxuᵀ, column c on lane c; k = −Quu⁻¹ qu on lane NX. Every
    // lane factors Quu (nu × nu) in its registers.
    if (lane <= NX) {
      F Quu[NU][NU], Lc[NU][NU], col[NU], y[NU], sol[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = q.Quu[i][j];
      }
      chol<NU, F>(Quu, Lc);
#pragma unroll
      for (int i = 0; i < NU; ++i)
        col[i] = lane < NX ? q.Qxu[lane][i] : q.qu[i];
      solve_lower_vec<NU, F>(Lc, col, y);
      solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (lane < NX)
          q.K[t][i][lane] = -sol[i];
        else
          q.k[t][i] = -sol[i];
      }
    }
    __syncwarp();
    // P = Qxx + Qxu K, symmetrized as the one-lane kernel's (each pair
    // from its lower entry); p = qx + Qxu k
    for (int e = lane; e < NX * NX + NX; e += 32) {
      if (e < NX * NX) {
        const int i = e / NX, j = e % NX;
        const int hi = i > j ? i : j, lo = i > j ? j : i;
        auto entry = [&](int a, int b) {
          F acc = q.Qxu[a][0] * q.K[t][0][b];
#pragma unroll
          for (int k = 1; k < NU; ++k) acc = acc + q.Qxu[a][k] * q.K[t][k][b];
          return q.Qxx[a][b] + acc;
        };
        q.P[t][i][j] = i == j ? entry(i, i)
                              : F(0.5) * (entry(hi, lo) + entry(lo, hi));
      } else {
        const int i = e - NX * NX;
        F acc = q.Qxu[i][0] * q.k[t][0];
#pragma unroll
        for (int k = 1; k < NU; ++k) acc = acc + q.Qxu[i][k] * q.k[t][k];
        q.p[t][i] = q.qx[i] + acc;
      }
    }
    __syncwarp();
  }

  // ---- forward rollout from dx₀ = −r_init ----
  if (lane < NX) d.dx[0][lane] = -r.rinit[lane];
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const F(&dv)[NX] = d.dx[t];
    if (lane < NX) {  // λ_t = −(P_t d + p_t)
      F acc = q.P[t][lane][0] * dv[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) acc = acc + q.P[t][lane][k] * dv[k];
      d.dl[t][lane] = -(acc + q.p[t][lane]);
    } else if (lane >= 16 && lane - 16 < NU) {  // du_t = K_t d + k_t
      const int i = lane - 16;
      F acc = q.K[t][i][0] * dv[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) acc = acc + q.K[t][i][k] * dv[k];
      d.du[t][i] = acc + q.k[t][i];
    }
    __syncwarp();
    if (t < T - 1) {
      if (lane < NX) {  // d_{t+1} = A d + B du + r
        F ad = q.A[t][lane][0] * dv[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) ad = ad + q.A[t][lane][k] * dv[k];
        F bd = q.B[t][lane][0] * d.du[t][0];
#pragma unroll
        for (int k = 1; k < NU; ++k) bd = bd + q.B[t][lane][k] * d.du[t][k];
        d.dx[t + 1][lane] = ad + bd + -r.rdyn[t][lane];
      }
      __syncwarp();
    }
  }

  // ---- the box rows ----
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    const F dsh = -r.rph[t][i] - d.du[t][i];
    const F dsl = -r.rpl[t][i] + d.du[t][i];
    d.dsh[t][i] = dsh;
    d.dsl[t][i] = dsl;
    d.dzh[t][i] = -(r.rsh[t][i] + s.zh[t][i] * dsh) / s.sh[t][i];
    d.dzl[t][i] = -(r.rsl[t][i] + s.zl[t][i] * dsl) / s.sl[t][i];
  }
  __syncwarp();
}

// Largest step in (0, 1] keeping v + a·dv ≥ 0, over s_hi, s_lo, z_hi,
// z_lo; the same on every lane.
template <int T, int NX, int NU, typename F>
__device__ __forceinline__ F warp_max_step(
    const WarpIterate<T, NX, NU, F>& s, const WarpStep<T, NX, NU, F>& d,
    int lane) {
  const F big = F(FLT_MAX);
  F a = F(1);
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    const F v[4] = {s.sh[t][i], s.sl[t][i], s.zh[t][i], s.zl[t][i]};
    const F dv[4] = {d.dsh[t][i], d.dsl[t][i], d.dzh[t][i], d.dzl[t][i]};
#pragma unroll
    for (int w = 0; w < 4; ++w)
      a = min_keep_nan(a, dv[w] < F(0) ? -v[w] / dv[w] : big);
  }
  return warp_min(a);
}

template <int T, int NX, int NU, typename F>
__device__ __forceinline__ void copy_iterate(
    const WarpIterate<T, NX, NU, F>& from, WarpIterate<T, NX, NU, F>& to,
    int lane) {
  for (int e = lane; e < T * NX; e += 32) {
    const int t = e / NX, i = e % NX;
    to.x[t][i] = from.x[t][i];
    to.lam[t][i] = from.lam[t][i];
  }
  for (int e = lane; e < T * NU; e += 32) {
    const int t = e / NU, i = e % NU;
    to.u[t][i] = from.u[t][i];
    to.zh[t][i] = from.zh[t][i];
    to.zl[t][i] = from.zl[t][i];
    to.sh[t][i] = from.sh[t][i];
    to.sl[t][i] = from.sl[t][i];
  }
}

template <int T, int NX, int NU, typename F>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
trajqp_warp_kernel(const F* __restrict__ C_g, const F* __restrict__ c_g,
                   const F* __restrict__ A_g, const F* __restrict__ B_g,
                   const F* __restrict__ f_g, const F* __restrict__ x0_g,
                   const F* __restrict__ xi_g, const F* __restrict__ ui_g,
                   F* __restrict__ x_out, F* __restrict__ u_out,
                   F* __restrict__ lam_out, F* __restrict__ zh_out,
                   F* __restrict__ zl_out, F* __restrict__ sh_out,
                   F* __restrict__ sl_out, F* __restrict__ res_out, int Bsz,
                   int max_iter, F reg, F min_slack, WarpBox<F, NU> box) {
  constexpr int N = NX + NU;
  using E = WarpQP<T, NX, NU, F>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (e >= Bsz) return;  // the whole warp: no shuffle waits on it
  E& q = reinterpret_cast<E*>(smem)[threadIdx.x >> 5];
  const size_t eT = static_cast<size_t>(e) * T;
  const size_t eT1 = static_cast<size_t>(e) * (T - 1);

  // ---- load the QP; the interior start, u clipped into the box ----
  for (int k = lane; k < T * N * N; k += 32)
    (&q.C[0][0][0])[k] = C_g[eT * N * N + k];
  for (int k = lane; k < T * N; k += 32) (&q.c[0][0])[k] = c_g[eT * N + k];
  for (int k = lane; k < (T - 1) * NX * NX; k += 32)
    (&q.A[0][0][0])[k] = A_g[eT1 * NX * NX + k];
  for (int k = lane; k < (T - 1) * NX * NU; k += 32)
    (&q.B[0][0][0])[k] = B_g[eT1 * NX * NU + k];
  for (int k = lane; k < (T - 1) * NX; k += 32)
    (&q.f[0][0])[k] = f_g[eT1 * NX + k];
  if (lane < NX) q.x0[lane] = x0_g[static_cast<size_t>(e) * NX + lane];
  for (int k = lane; k < T * NX; k += 32) {
    const int t = k / NX, i = k % NX;
    q.s.x[t][i] = xi_g[eT * NX + k];
    q.s.lam[t][i] = F(0);
  }
  for (int k = lane; k < T * NU; k += 32) {
    const int t = k / NU, i = k % NU;
    const F ui = min_keep_nan(max_keep_nan(ui_g[eT * NU + k], box.lo_clip[i]),
                              box.hi_clip[i]);
    q.s.u[t][i] = ui;
    q.s.sh[t][i] = max_keep_nan(box.hi[i] - ui, F(0.1));
    q.s.sl[t][i] = max_keep_nan(ui - box.lo[i], F(0.1));
    q.s.zh[t][i] = F(1);
    q.s.zl[t][i] = F(1);
  }
  // the corrector's residuals are zero but for complementarity
  for (int k = lane; k < T * NX; k += 32) (&q.rc.rx[0][0])[k] = F(0);
  for (int k = lane; k < (T - 1) * NX; k += 32) (&q.rc.rdyn[0][0])[k] = F(0);
  if (lane < NX) q.rc.rinit[lane] = F(0);
  for (int k = lane; k < T * NU; k += 32) {
    (&q.rc.ru[0][0])[k] = F(0);
    (&q.rc.rph[0][0])[k] = F(0);
    (&q.rc.rpl[0][0])[k] = F(0);
  }
  __syncwarp();
  copy_iterate(q.s, q.best, lane);
  F b_tot = F(FLT_MAX);
  const F n_comp = F(2 * T * NU);

  for (int it = 0; it < max_iter; ++it) {
    warp_residuals(q, box, q.s, q.r, lane);
    F mu;
    const F total = warp_resid_norm(q.r, mu, lane);
    const bool better = total < b_tot;  // the same on every lane
    if (better) copy_iterate(q.s, q.best, lane);
    b_tot = better ? total : b_tot;

    // ---- affine (predictor) ----
    warp_kkt_step(q, q.r, reg, q.da, lane);
    const F a_aff = warp_max_step(q.s, q.da, lane);
    F mu_aff = F(0);
    for (int k = lane; k < T * NU; k += 32) {
      const int t = k / NU, i = k % NU;
      mu_aff = mu_aff + (q.s.sh[t][i] + a_aff * q.da.dsh[t][i]) *
                            (q.s.zh[t][i] + a_aff * q.da.dzh[t][i]) +
               (q.s.sl[t][i] + a_aff * q.da.dsl[t][i]) *
                   (q.s.zl[t][i] + a_aff * q.da.dzl[t][i]);
    }
    mu_aff = warp_sum(mu_aff) / n_comp;
    const F ratio = mu_aff / max_keep_nan(mu, F(1e-30));
    const F smu = ratio * ratio * ratio * mu;

    // ---- centering-corrector: zero residuals but complementarity ----
    for (int k = lane; k < T * NU; k += 32) {
      const int t = k / NU, i = k % NU;
      q.rc.rsh[t][i] = q.da.dsh[t][i] * q.da.dzh[t][i] - smu;
      q.rc.rsl[t][i] = q.da.dsl[t][i] * q.da.dzl[t][i] - smu;
    }
    __syncwarp();
    warp_kkt_step(q, q.rc, reg, q.d, lane);

    // ---- combined step ----
    for (int k = lane; k < T * NX; k += 32) {
      const int t = k / NX, i = k % NX;
      q.d.dx[t][i] = q.da.dx[t][i] + q.d.dx[t][i];
      q.d.dl[t][i] = q.da.dl[t][i] + q.d.dl[t][i];
    }
    for (int k = lane; k < T * NU; k += 32) {
      const int t = k / NU, i = k % NU;
      q.d.du[t][i] = q.da.du[t][i] + q.d.du[t][i];
      q.d.dsh[t][i] = q.da.dsh[t][i] + q.d.dsh[t][i];
      q.d.dsl[t][i] = q.da.dsl[t][i] + q.d.dsl[t][i];
      q.d.dzh[t][i] = q.da.dzh[t][i] + q.d.dzh[t][i];
      q.d.dzl[t][i] = q.da.dzl[t][i] + q.d.dzl[t][i];
    }
    __syncwarp();
    const F alpha = F(0.99) * warp_max_step(q.s, q.d, lane);
    for (int k = lane; k < T * NX; k += 32) {
      const int t = k / NX, i = k % NX;
      q.s.x[t][i] = q.s.x[t][i] + alpha * q.d.dx[t][i];
      q.s.lam[t][i] = q.s.lam[t][i] + alpha * q.d.dl[t][i];
    }
    for (int k = lane; k < T * NU; k += 32) {
      const int t = k / NU, i = k % NU;
      q.s.u[t][i] = q.s.u[t][i] + alpha * q.d.du[t][i];
      q.s.zh[t][i] =
          max_keep_nan(q.s.zh[t][i] + alpha * q.d.dzh[t][i], min_slack);
      q.s.zl[t][i] =
          max_keep_nan(q.s.zl[t][i] + alpha * q.d.dzl[t][i], min_slack);
      q.s.sh[t][i] =
          max_keep_nan(q.s.sh[t][i] + alpha * q.d.dsh[t][i], min_slack);
      q.s.sl[t][i] =
          max_keep_nan(q.s.sl[t][i] + alpha * q.d.dsl[t][i], min_slack);
    }
    __syncwarp();
  }

  // ---- final best-iterate comparison ----
  warp_residuals(q, box, q.s, q.r, lane);
  F mu;
  const F total = warp_resid_norm(q.r, mu, lane);
  const WarpIterate<T, NX, NU, F>& o = total < b_tot ? q.s : q.best;
  if (lane == 0) res_out[e] = min_keep_nan(total, b_tot);
  for (int k = lane; k < T * NX; k += 32) {
    const int t = k / NX, i = k % NX;
    x_out[eT * NX + k] = o.x[t][i];
    lam_out[eT * NX + k] = o.lam[t][i];
  }
  for (int k = lane; k < T * NU; k += 32) {
    const int t = k / NU, i = k % NU;
    u_out[eT * NU + k] = o.u[t][i];
    zh_out[eT * NU + k] = o.zh[t][i];
    zl_out[eT * NU + k] = o.zl[t][i];
    sh_out[eT * NU + k] = o.sh[t][i];
    sl_out[eT * NU + k] = o.sl[t][i];
  }
}

struct WarpArgs {
  const void *C, *c, *A, *B, *f, *x0, *xi, *ui;
  void *x, *u, *lam, *zh, *zl, *sh, *sl, *res;
};

// Shared memory of the (T, NX, NU, F) instantiation: bytes an element and
// a block, and the most a block may ask of the current device.
template <int T, int NX, int NU, typename F>
int warp_smem(int* per_element, int* per_block, int* device_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *per_element = static_cast<int>(sizeof(WarpQP<T, NX, NU, F>));
  *per_block = *per_element * kWarpsPerBlock;
  return static_cast<int>(err);
}

template <int T, int NX, int NU, typename F>
int launch(const WarpArgs& a, int Bsz, int max_iter, double reg,
           double min_slack, const double* u_lo, const double* u_hi,
           cudaStream_t s) {
  WarpBox<F, NU> box;
  for (int i = 0; i < NU; ++i) {
    box.lo[i] = static_cast<F>(u_lo[i]);
    box.hi[i] = static_cast<F>(u_hi[i]);
    box.lo_clip[i] = static_cast<F>(u_lo[i] + 1e-3);
    box.hi_clip[i] = static_cast<F>(u_hi[i] - 1e-3);
  }
  int per_element = 0, per_block = 0, device_max = 0;
  cudaError_t err = static_cast<cudaError_t>(
      warp_smem<T, NX, NU, F>(&per_element, &per_block, &device_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_block > device_max)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(trajqp_warp_kernel<T, NX, NU, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Bsz + kWarpsPerBlock - 1) / kWarpsPerBlock;
  trajqp_warp_kernel<T, NX, NU, F><<<blocks, 32 * kWarpsPerBlock, per_block,
                                     s>>>(
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

// The instantiations: the cartpoles' shapes (5, 5, 1), (5, 6, 1) and
// (5, 7, 1), and the quadrotor's ip and slew shapes.
#define TRAJQP_WARP_SHAPES(X) \
  X(5, 5, 1) X(5, 6, 1) X(5, 7, 1) X(5, 12, 4) X(5, 16, 4)

template <typename F>
int dispatch(const WarpArgs& a, int Bsz, int T, int nx, int nu, int max_iter,
             double reg, double min_slack, const double* u_lo,
             const double* u_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRAJQP_WARP_LAUNCH(TT, NXX, NUU)                                 \
  if (T == TT && nx == NXX && nu == NUU)                                 \
    return launch<TT, NXX, NUU, F>(a, Bsz, max_iter, reg, min_slack, u_lo, \
                                   u_hi, s);
  TRAJQP_WARP_SHAPES(TRAJQP_WARP_LAUNCH)
#undef TRAJQP_WARP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int smem(int T, int nx, int nu, int* per_element, int* per_block,
         int* device_max) {
#define TRAJQP_WARP_SMEM(TT, NXX, NUU)                        \
  if (T == TT && nx == NXX && nu == NUU)                      \
    return warp_smem<TT, NXX, NUU, F>(per_element, per_block, \
                                      device_max);
  TRAJQP_WARP_SHAPES(TRAJQP_WARP_SMEM)
#undef TRAJQP_WARP_SMEM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dqmpc

// Inputs and outputs as trajqp_fused.cu's entry points (contiguous,
// batch-major). Built for (T, nx, nu) = (5, 5, 1), (5, 6, 1), (5, 7, 1),
// (5, 12, 4) and (5, 16, 4); cudaErrorInvalidValue otherwise, cudaErrorInvalidConfiguration when a
// block's shared memory exceeds what the device allows. Returns a
// cudaError_t code.
#define TRAJQP_WARP_ENTRY(NAME, F)                                            \
  extern "C" int NAME(                                                        \
      const void* C, const void* c, const void* A, const void* B,             \
      const void* f, const void* x0, const void* xi, const void* ui, void* x, \
      void* u, void* lam, void* zh, void* zl, void* sh, void* sl, void* res,  \
      int Bsz, int T, int nx, int nu, int max_iter, double reg,               \
      double min_slack, const double* u_lo, const double* u_hi,               \
      void* stream) {                                                         \
    dqmpc::WarpArgs a{C, c, A, B, f, x0, xi, ui,                              \
                      x, u, lam, zh, zl, sh, sl, res};                        \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, max_iter, reg, min_slack,    \
                              u_lo, u_hi, stream);                            \
  }

TRAJQP_WARP_ENTRY(trajqp_fused_warp_f32, float)
TRAJQP_WARP_ENTRY(trajqp_fused_warp_f64, double)

// Shared memory of the (T, nx, nu, dtype) instantiation (see
// dqmpc::warp_smem). Returns a cudaError_t code.
extern "C" int trajqp_fused_warp_smem_f32(int T, int nx, int nu,
                                          int* per_element, int* per_block,
                                          int* device_max) {
  return dqmpc::smem<float>(T, nx, nu, per_element, per_block, device_max);
}

extern "C" int trajqp_fused_warp_smem_f64(int T, int nx, int nu,
                                          int* per_element, int* per_block,
                                          int* device_max) {
  return dqmpc::smem<double>(T, nx, nu, per_element, per_block, device_max);
}
