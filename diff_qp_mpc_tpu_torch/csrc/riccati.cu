// K3: batched Riccati LQR-KKT solve, one thread per batch element.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/riccati_pallas.py::
// batched_lqr_kkt_solve (_riccati_kernel). Same function: the backward
// Riccati recursion over the dense stage blocks and the forward rollout from
// dx0, returning (dx, du, λ); reg is added to Quu before its Cholesky
// factorization. The recursion itself is riccati_solve in riccati_common.cuh,
// shared with K4.
//
// Design: (T, NX, NU) are template parameters, so the stage loops unroll and
// the per-stage K, k, P, p stay in registers; one thread loads its element's
// blocks, solves, and writes dx, du, λ. The TPU's batch padding (identity
// Cuu on padded elements) is not needed: the batch edge is masked.
//
// Bound on the H100: ~480 flops and ~440 bytes (float32) per element at
// the ip path's shape (T 5, nx 2, nu 1), so the card's bound is the bytes;
// at 64 elements (the closed loop's batch) a launch occupies one SM and each
// thread runs one serial chain, so it is latency-bound, a few µs above the
// device's fixed cost per launch. Serving an element with a group of lanes,
// its blocks in shared memory, was measured and lost at the ip path's shape
// at every batch timed (it won only at nx 4, where one thread's state
// outgrows its registers): each sub-step is a few multiply-adds, so lanes
// trade register operands for shared-memory round trips, while the chain of
// IEEE divisions and square roots that sets the time stays as deep
// (PERF.md, Findings).
#include <cstddef>

#include "riccati_common.cuh"

namespace dqmpc {

template <int T, int NX, int NU, typename F>
__global__ void __launch_bounds__(128)
riccati_kernel(const F* __restrict__ Cxx_g, const F* __restrict__ Cxu_g,
               const F* __restrict__ Cuu_g, const F* __restrict__ gx_g,
               const F* __restrict__ gu_g, const F* __restrict__ A_g,
               const F* __restrict__ B_g, const F* __restrict__ r_g,
               const F* __restrict__ dx0_g, F* __restrict__ dx_g,
               F* __restrict__ du_g, F* __restrict__ lam_g, int Bsz, F reg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Bsz) return;
  const size_t E = static_cast<size_t>(e);
  LQRProblem<T, NX, NU, F> prob;
  F Cuu[T][NU][NU], gx[T][NX], gu[T][NU], r[T - 1][NX], dx0[NX];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      gx[t][i] = gx_g[(E * T + t) * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        prob.Cxx[t][i][j] = Cxx_g[((E * T + t) * NX + i) * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        prob.Cxu[t][i][j] = Cxu_g[((E * T + t) * NX + i) * NU + j];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      gu[t][i] = gu_g[(E * T + t) * NU + i];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        Cuu[t][i][j] = Cuu_g[((E * T + t) * NU + i) * NU + j];
    }
  }
#pragma unroll
  for (int t = 0; t < T - 1; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      r[t][i] = r_g[(E * (T - 1) + t) * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        prob.A[t][i][j] = A_g[((E * (T - 1) + t) * NX + i) * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j)
        prob.B[t][i][j] = B_g[((E * (T - 1) + t) * NX + i) * NU + j];
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) dx0[i] = dx0_g[E * NX + i];

  F dx[T][NX], du[T][NU], lam[T][NX];
  riccati_solve<T, NX, NU, F>(prob, Cuu, gx, gu, r, dx0, reg, dx, du, lam);

#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dx_g[(E * T + t) * NX + i] = dx[t][i];
      lam_g[(E * T + t) * NX + i] = lam[t][i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) du_g[(E * T + t) * NU + i] = du[t][i];
  }
}

struct RiccatiArgs {
  const void *Cxx, *Cxu, *Cuu, *gx, *gu, *A, *B, *r, *dx0;
  void *dx, *du, *lam;
};

template <int T, int NX, int NU, typename F>
int launch(const RiccatiArgs& a, int Bsz, double reg, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (Bsz + threads - 1) / threads;
  riccati_kernel<T, NX, NU, F><<<blocks, threads, 0, s>>>(
      static_cast<const F*>(a.Cxx), static_cast<const F*>(a.Cxu),
      static_cast<const F*>(a.Cuu), static_cast<const F*>(a.gx),
      static_cast<const F*>(a.gu), static_cast<const F*>(a.A),
      static_cast<const F*>(a.B), static_cast<const F*>(a.r),
      static_cast<const F*>(a.dx0), static_cast<F*>(a.dx),
      static_cast<F*>(a.du), static_cast<F*>(a.lam), Bsz,
      static_cast<F>(reg));
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int dispatch(const RiccatiArgs& a, int Bsz, int T, int nx, int nu,
             double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T == 5 && nx == 2 && nu == 1) return launch<5, 2, 1, F>(a, Bsz, reg, s);
  if (T == 5 && nx == 3 && nu == 1) return launch<5, 3, 1, F>(a, Bsz, reg, s);
  if (T == 5 && nx == 3 && nu == 2) return launch<5, 3, 2, F>(a, Bsz, reg, s);
  if (T == 5 && nx == 4 && nu == 1) return launch<5, 4, 1, F>(a, Bsz, reg, s);
  if (T == 5 && nx == 6 && nu == 1) return launch<5, 6, 1, F>(a, Bsz, reg, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dqmpc

// Cxx [B,T,nx,nx], Cxu [B,T,nx,nu], Cuu [B,T,nu,nu], gx [B,T,nx],
// gu [B,T,nu], A [B,T-1,nx,nx], B [B,T-1,nx,nu], r [B,T-1,nx], dx0 [B,nx]
// -> dx [B,T,nx], du [B,T,nu], lam [B,T,nx]; all contiguous. Built for
// (T, nx, nu) = (5, 2, 1), (5, 3, 1), (5, 3, 2), (5, 4, 1) and (5, 6, 1);
// cudaErrorInvalidValue otherwise (riccati_horizon_warp.cu takes
// longer horizons).
// Returns a cudaError_t code.
#define RICCATI_ENTRY(NAME, F)                                                \
  extern "C" int NAME(const void* Cxx, const void* Cxu, const void* Cuu,     \
                      const void* gx, const void* gu, const void* A,         \
                      const void* B, const void* r, const void* dx0,         \
                      void* dx, void* du, void* lam, int Bsz, int T, int nx, \
                      int nu, double reg, void* stream) {                    \
    dqmpc::RiccatiArgs a{Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0, dx, du, lam};   \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, reg, stream);               \
  }

RICCATI_ENTRY(riccati_f32, float)
RICCATI_ENTRY(riccati_f64, double)
