// The Riccati LQR-KKT solve of one batch element, held in registers: shared
// by riccati.cu (K3) and trajqp_fused.cu (K4), as the TPU kernels share
// riccati_tiles (diff_qp_mpc_tpu/ops/riccati_pallas.py).
//
// Solves  min Σₜ ½ dwₜᵀ C̃ₜ dwₜ + g̃ₜᵀ dwₜ
//         s.t.  dx_{t+1} = Aₜdxₜ + Bₜduₜ + rₜ,  dx₀ given:
// the backward recursion (Qxx, Qxu, Quu, qx, qu; Cholesky of Quu + reg·I;
// K, k; P symmetrized by averaging (i, j) and (j, i)) keeps
// K, k, P, p of every stage, then the forward rollout gives dx, du and the
// costates λₜ = −(Pₜdxₜ + pₜ). T, NX and NU are template parameters and
// every loop is unrolled, so the per-stage storage, T·(NU·NX + NU + NX² +
// NX) values, can live in registers. The arithmetic and its order follow
// riccati_tiles, so kernel and reference round alike up to FMA contraction.
#pragma once

#include "bt_common.cuh"

namespace dqmpc {

// The blocks an interior-point iteration does not change: Cxx, Cxu, A, B.
template <int T, int NX, int NU, typename F>
struct LQRProblem {
  F Cxx[T][NX][NX];
  F Cxu[T][NX][NU];
  F A[T - 1][NX][NX];
  F B[T - 1][NX][NU];
};

// out = Σₖ a(i, k) b(k, j), first product then multiply-adds, as tile_matmul.
template <int R, int K, int C, typename F, class GA, class GB>
__device__ __forceinline__ void matmul(GA a, GB b, F (&out)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      F s = a(i, 0) * b(0, j);
#pragma unroll
      for (int k = 1; k < K; ++k) s = s + a(i, k) * b(k, j);
      out[i][j] = s;
    }
  }
}

template <int R, int K, typename F, class GA>
__device__ __forceinline__ void matvec(GA a, const F (&v)[K], F (&out)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    F s = a(i, 0) * v[0];
#pragma unroll
    for (int k = 1; k < K; ++k) s = s + a(i, k) * v[k];
    out[i] = s;
  }
}

// dx, du, lam of the LQR-KKT system with stage cost blocks (prob.Cxx,
// prob.Cxu, Cuu), gradients (gx, gu), dynamics (prob.A, prob.B, r) and
// initial value dx0. Cuu is separate from prob because the interior-point
// iteration changes it every solve.
//
// kScalarPivot (NU 1 only): K and k from one correctly rounded reciprocal
// of max(Quu + reg, 1e-30) and multiplies, where the default runs the
// Cholesky's square root and two divisions per column. The results differ
// by rounding only; K4 takes it, K3 keeps the default and its bits.
template <int T, int NX, int NU, typename F, bool kScalarPivot = false>
__device__ __forceinline__ void riccati_solve(
    const LQRProblem<T, NX, NU, F>& prob, const F (&Cuu)[T][NU][NU],
    const F (&gx)[T][NX], const F (&gu)[T][NU], const F (&r)[T - 1][NX],
    const F (&dx0)[NX], F reg, F (&dx)[T][NX], F (&du)[T][NU],
    F (&lam)[T][NX]) {
  F Ks[T][NU][NX], ks[T][NU], Ps[T][NX][NX], ps[T][NX];

  // ---- backward recursion ----
#pragma unroll
  for (int t = T - 1; t >= 0; --t) {
    F Qxx[NX][NX], Qxu[NX][NU], Quu[NU][NU], qx[NX], qu[NU];
    if (t < T - 1) {
      const F(&P)[NX][NX] = Ps[t + 1];
      const F(&p)[NX] = ps[t + 1];
      const F(&At)[NX][NX] = prob.A[t];
      const F(&Bt)[NX][NU] = prob.B[t];
      F PA[NX][NX], PB[NX][NU], m[NX];
      matmul<NX, NX, NX, F>([&](int i, int k) { return P[i][k]; },
                            [&](int k, int j) { return At[k][j]; }, PA);
      matmul<NX, NX, NU, F>([&](int i, int k) { return P[i][k]; },
                            [&](int k, int j) { return Bt[k][j]; }, PB);
      matvec<NX, NX, F>([&](int i, int k) { return P[i][k]; }, r[t], m);
#pragma unroll
      for (int i = 0; i < NX; ++i) m[i] = m[i] + p[i];
      auto AT = [&](int i, int k) { return At[k][i]; };
      auto BT = [&](int i, int k) { return Bt[k][i]; };
      matmul<NX, NX, NX, F>(AT, [&](int k, int j) { return PA[k][j]; }, Qxx);
      matmul<NX, NX, NU, F>(AT, [&](int k, int j) { return PB[k][j]; }, Qxu);
      matmul<NU, NX, NU, F>(BT, [&](int k, int j) { return PB[k][j]; }, Quu);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Qxx[i][j] = Qxx[i][j] + prob.Cxx[t][i][j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Qxu[i][j] = Qxu[i][j] + prob.Cxu[t][i][j];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = Quu[i][j] + Cuu[t][i][j];
      }
      F Am[NX], Bm[NU];
      matvec<NX, NX, F>(AT, m, Am);
      matvec<NU, NX, F>(BT, m, Bm);
#pragma unroll
      for (int i = 0; i < NX; ++i) qx[i] = gx[t][i] + Am[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) qu[i] = gu[t][i] + Bm[i];
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        qx[i] = gx[t][i];
#pragma unroll
        for (int j = 0; j < NX; ++j) Qxx[i][j] = prob.Cxx[t][i][j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Qxu[i][j] = prob.Cxu[t][i][j];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        qu[i] = gu[t][i];
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = Cuu[t][i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) Quu[i][i] = Quu[i][i] + reg;
    if constexpr (kScalarPivot) {
      static_assert(NU == 1, "the scalar pivot is Quu at one control");
      const F inv = F(1) / max_keep_nan(Quu[0][0], F(1e-30));
#pragma unroll
      for (int c = 0; c < NX; ++c) Ks[t][0][c] = -(Qxu[c][0] * inv);
      ks[t][0] = -(qu[0] * inv);
    } else {
      F Lc[NU][NU];
      chol<NU, F>(Quu, Lc);
      // K = −Quu⁻¹ Qxuᵀ column by column, k = −Quu⁻¹ qu
#pragma unroll
      for (int c = 0; c < NX; ++c) {
        F col[NU], y[NU], sol[NU];
#pragma unroll
        for (int i = 0; i < NU; ++i) col[i] = Qxu[c][i];
        solve_lower_vec<NU, F>(Lc, col, y);
        solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
        for (int i = 0; i < NU; ++i) Ks[t][i][c] = -sol[i];
      }
      F y[NU], sol[NU];
      solve_lower_vec<NU, F>(Lc, qu, y);
      solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
      for (int i = 0; i < NU; ++i) ks[t][i] = -sol[i];
    }
    // P = Qxx + Qxu K, symmetrized; p = qx + Qxu k
    F QK[NX][NX], Qk[NX];
    matmul<NX, NU, NX, F>([&](int i, int k) { return Qxu[i][k]; },
                          [&](int k, int j) { return Ks[t][k][j]; }, QK);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Ps[t][i][j] = Qxx[i][j] + QK[i][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const F sym = F(0.5) * (Ps[t][i][j] + Ps[t][j][i]);
        Ps[t][i][j] = sym;
        Ps[t][j][i] = sym;
      }
    }
    matvec<NX, NU, F>([&](int i, int k) { return Qxu[i][k]; }, ks[t], Qk);
#pragma unroll
    for (int i = 0; i < NX; ++i) ps[t][i] = qx[i] + Qk[i];
  }

  // ---- forward rollout ----
  F d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = dx0[i];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    F Kd[NU], Pd[NX];
    matvec<NU, NX, F>([&](int i, int k) { return Ks[t][i][k]; }, d, Kd);
    matvec<NX, NX, F>([&](int i, int k) { return Ps[t][i][k]; }, d, Pd);
#pragma unroll
    for (int i = 0; i < NU; ++i) du[t][i] = Kd[i] + ks[t][i];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dx[t][i] = d[i];
      lam[t][i] = -(Pd[i] + ps[t][i]);
    }
    if (t < T - 1) {
      F Ad[NX], Bd[NX];
      matvec<NX, NX, F>([&](int i, int k) { return prob.A[t][i][k]; }, d, Ad);
      matvec<NX, NU, F>([&](int i, int k) { return prob.B[t][i][k]; }, du[t],
                        Bd);
#pragma unroll
      for (int i = 0; i < NX; ++i) d[i] = Ad[i] + Bd[i] + r[t][i];
    }
  }
}

}  // namespace dqmpc
