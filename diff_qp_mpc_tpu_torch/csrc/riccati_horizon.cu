// K3 over long horizons: the batched Riccati LQR-KKT solve with T a run-time
// argument, one thread per batch element.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/riccati_pallas.py::
// batched_lqr_kkt_solve (_riccati_kernel) at the horizons of the MPC
// expert's planners (T 10 to 120) whose element fits a thread, and at T 5
// where the unrolled kernel has no instantiation: CartpoleCosSin's (5, 1)
// and the slew-augmented shapes of cp1 and cp2 ((5, 1), (7, 1)). The
// quadrotor's (12, 4) and (16, 4) run on riccati_horizon_warp.cu, one warp
// per element: here a thread held more than 255 registers at those shapes
// and spilled 28-176 KB to local memory (PERF.md). Same function as
// riccati.cu: the backward Riccati recursion over the dense stage blocks,
// reg added to Quu before its Cholesky factorization, then the forward
// rollout from dx0, returning (dx, du, λ); each stage's arithmetic, and its
// order, is riccati_solve's (riccati_common.cuh), so at a shape both
// kernels build the two round alike.
//
// Design: (NX, NU) are template parameters and their loops unroll; the
// stage loops do not (#pragma unroll 1), so the code size and the registers
// do not grow with T. The recursion carries Pₜ and pₜ in registers; each
// stage's blocks are read from global memory where they are used, and the
// stage's K, k, P and p go to a workspace in global memory that the forward
// rollout reads back (λ needs P and p). The workspace is stage-major with
// the batch element fastest, ws[(t·W + j)·B + e] (W values a stage), so
// neighbouring threads touch neighbouring addresses. The inputs keep the
// callers' batch-major layout.
#include <cstddef>

#include "riccati_common.cuh"

namespace dqmpc {

// Values a stage keeps in the workspace: K (NU·NX), k (NU), P (NX·NX), p (NX).
template <int NX, int NU>
struct HorizonLayout {
  static constexpr int kK = 0;
  static constexpr int kk = NU * NX;
  static constexpr int kP = kk + NU;
  static constexpr int kp = kP + NX * NX;
  static constexpr int W = kp + NX;
};

template <int NX, int NU, typename F>
__global__ void __launch_bounds__(128)
riccati_horizon_kernel(const F* __restrict__ Cxx_g,
                       const F* __restrict__ Cxu_g,
                       const F* __restrict__ Cuu_g,
                       const F* __restrict__ gx_g, const F* __restrict__ gu_g,
                       const F* __restrict__ A_g, const F* __restrict__ B_g,
                       const F* __restrict__ r_g, const F* __restrict__ dx0_g,
                       F* __restrict__ dx_g, F* __restrict__ du_g,
                       F* __restrict__ lam_g, F* __restrict__ ws, int Bsz,
                       int T, F reg) {
  using L = HorizonLayout<NX, NU>;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Bsz) return;
  const size_t E = static_cast<size_t>(e);
  const size_t Bs = static_cast<size_t>(Bsz);
  // the workspace slot of value j at stage t for this element
  auto slot = [&](int t, int j) -> F& {
    return ws[(static_cast<size_t>(t) * L::W + j) * Bs + E];
  };

  F P[NX][NX], p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    p[i] = F(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = F(0);
  }

  // ---- backward recursion ----
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const F* Cxx = Cxx_g + (E * T + t) * NX * NX;
    const F* Cxu = Cxu_g + (E * T + t) * NX * NU;
    const F* Cuu = Cuu_g + (E * T + t) * NU * NU;
    const F* gx = gx_g + (E * T + t) * NX;
    const F* gu = gu_g + (E * T + t) * NU;
    F Qxx[NX][NX], Qxu[NX][NU], Quu[NU][NU], qx[NX], qu[NU];
    if (t < T - 1) {
      const F* At = A_g + (E * (T - 1) + t) * NX * NX;
      const F* Bt = B_g + (E * (T - 1) + t) * NX * NU;
      const F* rt = r_g + (E * (T - 1) + t) * NX;
      F PA[NX][NX], PB[NX][NU], m[NX], rv[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) rv[i] = rt[i];
      matmul<NX, NX, NX, F>([&](int i, int k) { return P[i][k]; },
                            [&](int k, int j) { return At[k * NX + j]; }, PA);
      matmul<NX, NX, NU, F>([&](int i, int k) { return P[i][k]; },
                            [&](int k, int j) { return Bt[k * NU + j]; }, PB);
      matvec<NX, NX, F>([&](int i, int k) { return P[i][k]; }, rv, m);
#pragma unroll
      for (int i = 0; i < NX; ++i) m[i] = m[i] + p[i];
      auto AT = [&](int i, int k) { return At[k * NX + i]; };
      auto BT = [&](int i, int k) { return Bt[k * NU + i]; };
      matmul<NX, NX, NX, F>(AT, [&](int k, int j) { return PA[k][j]; }, Qxx);
      matmul<NX, NX, NU, F>(AT, [&](int k, int j) { return PB[k][j]; }, Qxu);
      matmul<NU, NX, NU, F>(BT, [&](int k, int j) { return PB[k][j]; }, Quu);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) Qxx[i][j] = Qxx[i][j] + Cxx[i * NX + j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Qxu[i][j] = Qxu[i][j] + Cxu[i * NU + j];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = Quu[i][j] + Cuu[i * NU + j];
      }
      F Am[NX], Bm[NU];
      matvec<NX, NX, F>(AT, m, Am);
      matvec<NU, NX, F>(BT, m, Bm);
#pragma unroll
      for (int i = 0; i < NX; ++i) qx[i] = gx[i] + Am[i];
#pragma unroll
      for (int i = 0; i < NU; ++i) qu[i] = gu[i] + Bm[i];
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        qx[i] = gx[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) Qxx[i][j] = Cxx[i * NX + j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Qxu[i][j] = Cxu[i * NU + j];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        qu[i] = gu[i];
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = Cuu[i * NU + j];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) Quu[i][i] = Quu[i][i] + reg;
    F Lc[NU][NU];
    chol<NU, F>(Quu, Lc);
    // K = −Quu⁻¹ Qxuᵀ column by column, k = −Quu⁻¹ qu
    F K[NU][NX], k[NU];
#pragma unroll
    for (int c = 0; c < NX; ++c) {
      F col[NU], y[NU], sol[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) col[i] = Qxu[c][i];
      solve_lower_vec<NU, F>(Lc, col, y);
      solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
      for (int i = 0; i < NU; ++i) K[i][c] = -sol[i];
    }
    {
      F y[NU], sol[NU];
      solve_lower_vec<NU, F>(Lc, qu, y);
      solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
      for (int i = 0; i < NU; ++i) k[i] = -sol[i];
    }
    // P = Qxx + Qxu K, symmetrized; p = qx + Qxu k
    F QK[NX][NX], Qk[NX];
    matmul<NX, NU, NX, F>([&](int i, int c) { return Qxu[i][c]; },
                          [&](int c, int j) { return K[c][j]; }, QK);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = Qxx[i][j] + QK[i][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < i; ++j) {
        const F sym = F(0.5) * (P[i][j] + P[j][i]);
        P[i][j] = sym;
        P[j][i] = sym;
      }
    }
    matvec<NX, NU, F>([&](int i, int c) { return Qxu[i][c]; }, k, Qk);
#pragma unroll
    for (int i = 0; i < NX; ++i) p[i] = qx[i] + Qk[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      slot(t, L::kk + i) = k[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) slot(t, L::kK + i * NX + j) = K[i][j];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      slot(t, L::kp + i) = p[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) slot(t, L::kP + i * NX + j) = P[i][j];
    }
  }

  // ---- forward rollout ----
  F d[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) d[i] = dx0_g[E * NX + i];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    F Kd[NU], Pd[NX], du[NU];
    matvec<NU, NX, F>([&](int i, int c) { return slot(t, L::kK + i * NX + c); },
                      d, Kd);
    matvec<NX, NX, F>([&](int i, int c) { return slot(t, L::kP + i * NX + c); },
                      d, Pd);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      du[i] = Kd[i] + slot(t, L::kk + i);
      du_g[(E * T + t) * NU + i] = du[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dx_g[(E * T + t) * NX + i] = d[i];
      lam_g[(E * T + t) * NX + i] = -(Pd[i] + slot(t, L::kp + i));
    }
    if (t < T - 1) {
      const F* At = A_g + (E * (T - 1) + t) * NX * NX;
      const F* Bt = B_g + (E * (T - 1) + t) * NX * NU;
      const F* rt = r_g + (E * (T - 1) + t) * NX;
      F Ad[NX], Bd[NX];
      matvec<NX, NX, F>([&](int i, int c) { return At[i * NX + c]; }, d, Ad);
      matvec<NX, NU, F>([&](int i, int c) { return Bt[i * NU + c]; }, du, Bd);
#pragma unroll
      for (int i = 0; i < NX; ++i) d[i] = Ad[i] + Bd[i] + rt[i];
    }
  }
}

struct HorizonArgs {
  const void *Cxx, *Cxu, *Cuu, *gx, *gu, *A, *B, *r, *dx0;
  void *dx, *du, *lam, *ws;
};

template <int NX, int NU, typename F>
int launch(const HorizonArgs& a, int Bsz, int T, double reg,
           cudaStream_t s) {
  const int threads = 128;
  const int blocks = (Bsz + threads - 1) / threads;
  riccati_horizon_kernel<NX, NU, F><<<blocks, threads, 0, s>>>(
      static_cast<const F*>(a.Cxx), static_cast<const F*>(a.Cxu),
      static_cast<const F*>(a.Cuu), static_cast<const F*>(a.gx),
      static_cast<const F*>(a.gu), static_cast<const F*>(a.A),
      static_cast<const F*>(a.B), static_cast<const F*>(a.r),
      static_cast<const F*>(a.dx0), static_cast<F*>(a.dx),
      static_cast<F*>(a.du), static_cast<F*>(a.lam), static_cast<F*>(a.ws),
      Bsz, T, static_cast<F>(reg));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(const HorizonArgs& a, int Bsz, int T, int nx, int nu,
             double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nx == 2 && nu == 1) return launch<2, 1, F>(a, Bsz, T, reg, s);
  if (nx == 4 && nu == 1) return launch<4, 1, F>(a, Bsz, T, reg, s);
  if (nx == 5 && nu == 1) return launch<5, 1, F>(a, Bsz, T, reg, s);
  if (nx == 6 && nu == 1) return launch<6, 1, F>(a, Bsz, T, reg, s);
  if (nx == 7 && nu == 1) return launch<7, 1, F>(a, Bsz, T, reg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int NX, int NU>
int workspace_values() {
  return HorizonLayout<NX, NU>::W;
}

}  // namespace dqmpc

// Values a stage keeps in the workspace per element (K, k, P, p) for
// (nx, nu), or 0 where the kernel is not built for it. The caller passes a
// workspace of T·W·B scalars of the inputs' type.
extern "C" int riccati_horizon_workspace(int nx, int nu) {
  if (nx == 2 && nu == 1) return dqmpc::workspace_values<2, 1>();
  if (nx == 4 && nu == 1) return dqmpc::workspace_values<4, 1>();
  if (nx == 5 && nu == 1) return dqmpc::workspace_values<5, 1>();
  if (nx == 6 && nu == 1) return dqmpc::workspace_values<6, 1>();
  if (nx == 7 && nu == 1) return dqmpc::workspace_values<7, 1>();
  return 0;
}

// Cxx [B,T,nx,nx], Cxu [B,T,nx,nu], Cuu [B,T,nu,nu], gx [B,T,nx],
// gu [B,T,nu], A [B,T-1,nx,nx], B [B,T-1,nx,nu], r [B,T-1,nx], dx0 [B,nx]
// -> dx [B,T,nx], du [B,T,nu], lam [B,T,nx]; all contiguous; ws holds
// T·W·B scalars (riccati_horizon_workspace). Built for (nx, nu) = (2, 1),
// (4, 1), (5, 1), (6, 1) and (7, 1), any T ≥ 1; cudaErrorInvalidValue
// otherwise (the quadrotor's (12, 4) and (16, 4) run on
// riccati_horizon_warp.cu).
// Returns a cudaError_t code.
#define RICCATI_HORIZON_ENTRY(NAME, F)                                       \
  extern "C" int NAME(const void* Cxx, const void* Cxu, const void* Cuu,     \
                      const void* gx, const void* gu, const void* A,         \
                      const void* B, const void* r, const void* dx0,         \
                      void* dx, void* du, void* lam, void* ws, int Bsz,      \
                      int T, int nx, int nu, double reg, void* stream) {     \
    dqmpc::HorizonArgs a{Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0,                \
                         dx, du, lam, ws};                                   \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, reg, stream);               \
  }

RICCATI_HORIZON_ENTRY(riccati_horizon_f32, float)
RICCATI_HORIZON_ENTRY(riccati_horizon_f64, double)
