// K3 over any horizon on the warp layout: the batched Riccati LQR-KKT solve
// with T a run-time argument, one warp per batch element and the element's
// stage in shared memory.
//
// Replaces the TPU kernel diff_qp_mpc_tpu/ops/riccati_pallas.py::
// batched_lqr_kkt_solve (_riccati_kernel) at every horizon shape that
// csrc/riccati.cu's unrolled T 5 kernel does not serve: the quadrotor's
// (nx, nu) = (12, 4) (its MPC expert's planner, T 20; its ip path's scan
// IPM and every ip backward, T 5) and its slew-augmented (16, 4) (T 5); the
// one-control shapes (4, 1) to (7, 1): cp1's stabilize planner (T 60,
// DAgger's relabeling) and swing-up (T 80), cp2's (T 10 and 120), the
// cartpoles' slew shapes and CartpoleCosSin's ip path (T 5); and (2, 1), the
// pendulum's and the integrator's expert planners (T 20 to 40). A kernel of
// one thread per element reads its stage's blocks from global memory T·nx²
// values apart from its neighbours', a launch of B 64-128 occupies one SM
// of 132, and at (12, 4) and (16, 4) it holds P, PA, Aᵀ(PA), the Q blocks
// and K in more than a lane's 255 registers and spills them to local
// memory. At (2, 1) to (7, 1) most lanes of a phase idle, and the warp
// layout still measured faster than one thread per element at the paths'
// batches (PERF.md). The backward Riccati recursion over the dense stage
// blocks, reg added to Quu's diagonal before its Cholesky factorization, P
// symmetrized, then the forward rollout from dx0, returning
// (dx, du, λ = −(P·dx + p)). Every entry is summed in riccati_common.cuh's
// order (riccati_solve's, which riccati.cu runs too), so the two kernels
// agree to rounding at T 5.
//
// Design: kHorizonWarps elements (warps) a block, so a launch of B elements
// spreads over B / kHorizonWarps blocks. Each warp keeps one stage in
// dynamic shared memory (HorizonWarpStage: 4,320 B an element in float32 at
// (12, 4), 6,976 B at (16, 4), twice that in float64; sized by (nx, nu,
// dtype), not by T), and at each stage t from T − 1 down to 0
//   - copies the stage's blocks (Cxx, Cxu, Cuu, gx, gu, Aₜ, Bₜ, rₜ), each
//     contiguous per element in the callers' batch-major layout, with
//     coalesced loads;
//   - the lanes take the entries of P·A, P·B and P·r + p (P, p of stage
//     t + 1), then of the Q blocks and q, then of the symmetrized new P and
//     p; lanes 0 … nx factor the nu × nu Quu in registers, lane c solves
//     K's column c and lane nx solves k;
//   - the stage's K, k, P and p also go to a workspace in global memory,
//     element-major (ws[(e·T + t)·W + j]), so that a warp's writes and its
//     forward rollout's reads are contiguous.
// A __syncwarp separates each phase from the next one that reads it.
// The forward rollout copies each stage's K, k, P, p, Aₜ, Bₜ and rₜ back
// into shared memory; lanes 0 … nx − 1 take λ and the next state's rows,
// lanes 16 … 16 + nu − 1 the control.
//
// Bound on the H100: k3_ops and k3_bytes (benchmarks/flops.py) count this
// arithmetic; at (20, 12, 4) and B 64 the bytes bound is 6.8e-4 ms. Each
// element is a chain of ~5 warp-synchronized phases a stage with a global
// load at its head, so at the paths' batches (16-300) a launch is
// latency-bound: its time grows with T, not with B, until the SMs fill.
#include <cstddef>

#include "bt_common.cuh"

namespace dqmpc {

// elements (warps) a block
constexpr int kHorizonWarps = 2;

// Values a stage keeps in the workspace: K (NU·NX), k (NU), P (NX·NX), p
// (NX).
template <int NX, int NU>
struct HorizonWarpLayout {
  static constexpr int kK = 0;
  static constexpr int kk = NU * NX;
  static constexpr int kP = kk + NU;
  static constexpr int kp = kP + NX * NX;
  static constexpr int W = kp + NX;
};

// One element's stage: its blocks, P and p (of stage t + 1, then of t), and
// the recursion's and the rollout's temporaries.
template <int NX, int NU, typename F>
struct HorizonWarpStage {
  F Cxx[NX][NX], Cxu[NX][NU], Cuu[NU][NU], gx[NX], gu[NU];
  F A[NX][NX], B[NX][NU], r[NX];
  F P[NX][NX], p[NX];
  F PA[NX][NX], PB[NX][NU], m[NX];
  F Qxx[NX][NX], Qxu[NX][NU], Quu[NU][NU], qx[NX], qu[NU];
  F K[NU][NX], k[NU];
  F d[NX], du[NU];
};

// dst[0 … N) = src[0 … N), a value a lane at a time (coalesced).
template <int N, typename F>
__device__ __forceinline__ void warp_copy(F* dst, const F* src, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 32) {
    const int k = k0 + lane;
    if (k < N) dst[k] = src[k];
  }
}

template <int NX, int NU, typename F>
__global__ void __launch_bounds__(32 * kHorizonWarps)
riccati_horizon_warp_kernel(const F* __restrict__ Cxx_g,
                            const F* __restrict__ Cxu_g,
                            const F* __restrict__ Cuu_g,
                            const F* __restrict__ gx_g,
                            const F* __restrict__ gu_g,
                            const F* __restrict__ A_g,
                            const F* __restrict__ B_g,
                            const F* __restrict__ r_g,
                            const F* __restrict__ dx0_g,
                            F* __restrict__ dx_g, F* __restrict__ du_g,
                            F* __restrict__ lam_g, F* __restrict__ ws,
                            int Bsz, int T, F reg) {
  static_assert(NX <= 16 && NU <= 16, "lambda on lanes 0-15, du on 16-31");
  using L = HorizonWarpLayout<NX, NU>;
  using S = HorizonWarpStage<NX, NU, F>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kHorizonWarps + (threadIdx.x >> 5);
  if (e >= Bsz) return;  // the whole warp
  S& s = reinterpret_cast<S*>(smem)[threadIdx.x >> 5];
  const size_t E = static_cast<size_t>(e);
  F* const wse = ws + E * T * L::W;

  // ---- backward recursion ----
#pragma unroll 1
  for (int t = T - 1; t >= 0; --t) {
    const bool last = t == T - 1;
    const size_t et = E * T + t;
    warp_copy<NX * NX>(&s.Cxx[0][0], Cxx_g + et * NX * NX, lane);
    warp_copy<NX * NU>(&s.Cxu[0][0], Cxu_g + et * NX * NU, lane);
    warp_copy<NU * NU>(&s.Cuu[0][0], Cuu_g + et * NU * NU, lane);
    warp_copy<NX>(s.gx, gx_g + et * NX, lane);
    warp_copy<NU>(s.gu, gu_g + et * NU, lane);
    if (!last) {
      const size_t et1 = E * (T - 1) + t;
      warp_copy<NX * NX>(&s.A[0][0], A_g + et1 * NX * NX, lane);
      warp_copy<NX * NU>(&s.B[0][0], B_g + et1 * NX * NU, lane);
      warp_copy<NX>(s.r, r_g + et1 * NX, lane);
    }
    __syncwarp();
    if (!last) {
      for (int q = lane; q < NX * NX + NX * NU + NX; q += 32) {
        if (q < NX * NX) {  // PA = P·A
          const int i = q / NX, j = q % NX;
          F acc = s.P[i][0] * s.A[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.P[i][k] * s.A[k][j];
          s.PA[i][j] = acc;
        } else if (q < NX * NX + NX * NU) {  // PB = P·B
          const int i = (q - NX * NX) / NU, j = (q - NX * NX) % NU;
          F acc = s.P[i][0] * s.B[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.P[i][k] * s.B[k][j];
          s.PB[i][j] = acc;
        } else {  // m = P·r + p
          const int i = q - NX * NX - NX * NU;
          F acc = s.P[i][0] * s.r[0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.P[i][k] * s.r[k];
          s.m[i] = acc + s.p[i];
        }
      }
      __syncwarp();
    }
    // the Q blocks and q, reg on Quu's diagonal
    for (int q = lane; q < NX * NX + NX * NU + NU * NU + NX + NU; q += 32) {
      if (q < NX * NX) {
        const int i = q / NX, j = q % NX;
        F v = s.Cxx[i][j];
        if (!last) {
          F acc = s.A[0][i] * s.PA[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.A[k][i] * s.PA[k][j];
          v = acc + v;
        }
        s.Qxx[i][j] = v;
      } else if (q < NX * NX + NX * NU) {
        const int i = (q - NX * NX) / NU, j = (q - NX * NX) % NU;
        F v = s.Cxu[i][j];
        if (!last) {
          F acc = s.A[0][i] * s.PB[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.A[k][i] * s.PB[k][j];
          v = acc + v;
        }
        s.Qxu[i][j] = v;
      } else if (q < NX * NX + NX * NU + NU * NU) {
        const int o = q - NX * NX - NX * NU;
        const int i = o / NU, j = o % NU;
        F v = s.Cuu[i][j];
        if (!last) {
          F acc = s.B[0][i] * s.PB[0][j];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.B[k][i] * s.PB[k][j];
          v = acc + v;
        }
        s.Quu[i][j] = i == j ? v + reg : v;
      } else if (q < NX * NX + NX * NU + NU * NU + NX) {
        const int i = q - NX * NX - NX * NU - NU * NU;
        F v = s.gx[i];
        if (!last) {
          F acc = s.A[0][i] * s.m[0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.A[k][i] * s.m[k];
          v = v + acc;
        }
        s.qx[i] = v;
      } else {
        const int i = q - NX * NX - NX * NU - NU * NU - NX;
        F v = s.gu[i];
        if (!last) {
          F acc = s.B[0][i] * s.m[0];
#pragma unroll
          for (int k = 1; k < NX; ++k) acc = acc + s.B[k][i] * s.m[k];
          v = v + acc;
        }
        s.qu[i] = v;
      }
    }
    __syncwarp();
    F* const w = wse + static_cast<size_t>(t) * L::W;
    // K = −Quu⁻¹ Qxuᵀ, column c on lane c; k = −Quu⁻¹ qu on lane NX. Each
    // of these lanes factors Quu (nu × nu) in its registers.
    if (lane <= NX) {
      F Quu[NU][NU], Lc[NU][NU], col[NU], y[NU], sol[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = s.Quu[i][j];
      }
      chol<NU, F>(Quu, Lc);
#pragma unroll
      for (int i = 0; i < NU; ++i)
        col[i] = lane < NX ? s.Qxu[lane][i] : s.qu[i];
      solve_lower_vec<NU, F>(Lc, col, y);
      solve_upper_vec<NU, F>(Lc, y, sol);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (lane < NX) {
          s.K[i][lane] = -sol[i];
          w[L::kK + i * NX + lane] = -sol[i];
        } else {
          s.k[i] = -sol[i];
          w[L::kk + i] = -sol[i];
        }
      }
    }
    __syncwarp();
    // P = Qxx + Qxu K, symmetrized as riccati_solve does (each pair from
    // its lower entry first); p = qx + Qxu k
    for (int q = lane; q < NX * NX + NX; q += 32) {
      if (q < NX * NX) {
        const int i = q / NX, j = q % NX;
        const int hi = i > j ? i : j, lo = i > j ? j : i;
        auto entry = [&](int a, int b) {
          F acc = s.Qxu[a][0] * s.K[0][b];
#pragma unroll
          for (int k = 1; k < NU; ++k) acc = acc + s.Qxu[a][k] * s.K[k][b];
          return s.Qxx[a][b] + acc;
        };
        const F v = i == j ? entry(i, i)
                           : F(0.5) * (entry(hi, lo) + entry(lo, hi));
        s.P[i][j] = v;
        w[L::kP + q] = v;
      } else {
        const int i = q - NX * NX;
        F acc = s.Qxu[i][0] * s.k[0];
#pragma unroll
        for (int k = 1; k < NU; ++k) acc = acc + s.Qxu[i][k] * s.k[k];
        const F v = s.qx[i] + acc;
        s.p[i] = v;
        w[L::kp + i] = v;
      }
    }
    __syncwarp();
  }

  // ---- forward rollout from dx0 ----
  if (lane < NX) s.d[lane] = dx0_g[E * NX + lane];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const F* const w = wse + static_cast<size_t>(t) * L::W;
    warp_copy<NU * NX>(&s.K[0][0], w + L::kK, lane);
    warp_copy<NU>(s.k, w + L::kk, lane);
    warp_copy<NX * NX>(&s.P[0][0], w + L::kP, lane);
    warp_copy<NX>(s.p, w + L::kp, lane);
    if (t < T - 1) {
      const size_t et1 = E * (T - 1) + t;
      warp_copy<NX * NX>(&s.A[0][0], A_g + et1 * NX * NX, lane);
      warp_copy<NX * NU>(&s.B[0][0], B_g + et1 * NX * NU, lane);
      warp_copy<NX>(s.r, r_g + et1 * NX, lane);
    }
    __syncwarp();
    const size_t et = E * T + t;
    if (lane < NX) {  // λₜ = −(Pₜ d + pₜ)
      F acc = s.P[lane][0] * s.d[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) acc = acc + s.P[lane][k] * s.d[k];
      lam_g[et * NX + lane] = -(acc + s.p[lane]);
      dx_g[et * NX + lane] = s.d[lane];
    } else if (lane >= 16 && lane - 16 < NU) {  // duₜ = Kₜ d + kₜ
      const int i = lane - 16;
      F acc = s.K[i][0] * s.d[0];
#pragma unroll
      for (int k = 1; k < NX; ++k) acc = acc + s.K[i][k] * s.d[k];
      const F du = acc + s.k[i];
      s.du[i] = du;
      du_g[et * NU + i] = du;
    }
    __syncwarp();
    if (t < T - 1) {
      F next = F(0);
      if (lane < NX) {  // d_{t+1} = A d + B du + r
        F ad = s.A[lane][0] * s.d[0];
#pragma unroll
        for (int k = 1; k < NX; ++k) ad = ad + s.A[lane][k] * s.d[k];
        F bd = s.B[lane][0] * s.du[0];
#pragma unroll
        for (int k = 1; k < NU; ++k) bd = bd + s.B[lane][k] * s.du[k];
        next = ad + bd + s.r[lane];
      }
      __syncwarp();  // every lane has read d before it changes
      if (lane < NX) s.d[lane] = next;
    }
  }
}

struct HorizonWarpArgs {
  const void *Cxx, *Cxu, *Cuu, *gx, *gu, *A, *B, *r, *dx0;
  void *dx, *du, *lam, *ws;
};

// Shared memory of the (NX, NU, F) instantiation: bytes an element and a
// block, and the most a block may ask of the current device.
template <int NX, int NU, typename F>
int horizon_warp_smem(int* per_element, int* per_block, int* device_max) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(device_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *per_element = static_cast<int>(sizeof(HorizonWarpStage<NX, NU, F>));
  *per_block = *per_element * kHorizonWarps;
  return static_cast<int>(err);
}

template <int NX, int NU, typename F>
int launch(const HorizonWarpArgs& a, int Bsz, int T, double reg,
           cudaStream_t s) {
  int per_element = 0, per_block = 0, device_max = 0;
  cudaError_t err = static_cast<cudaError_t>(
      horizon_warp_smem<NX, NU, F>(&per_element, &per_block, &device_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_block > device_max)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(riccati_horizon_warp_kernel<NX, NU, F>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (Bsz + kHorizonWarps - 1) / kHorizonWarps;
  riccati_horizon_warp_kernel<NX, NU, F><<<blocks, 32 * kHorizonWarps,
                                           per_block, s>>>(
      static_cast<const F*>(a.Cxx), static_cast<const F*>(a.Cxu),
      static_cast<const F*>(a.Cuu), static_cast<const F*>(a.gx),
      static_cast<const F*>(a.gu), static_cast<const F*>(a.A),
      static_cast<const F*>(a.B), static_cast<const F*>(a.r),
      static_cast<const F*>(a.dx0), static_cast<F*>(a.dx),
      static_cast<F*>(a.du), static_cast<F*>(a.lam), static_cast<F*>(a.ws),
      Bsz, T, static_cast<F>(reg));
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: the quadrotor's (nx, nu) and its slew-augmented one,
// the one-control shapes of the cartpoles' expert planners, slew option
// and CartpoleCosSin's ip path, and the pendulum's and the integrator's.
#define RICCATI_HORIZON_WARP_SHAPES(X) \
  X(12, 4) X(16, 4) X(2, 1) X(4, 1) X(5, 1) X(6, 1) X(7, 1)

template <typename F>
int dispatch(const HorizonWarpArgs& a, int Bsz, int T, int nx, int nu,
             double reg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
#define RICCATI_HORIZON_WARP_LAUNCH(NXX, NUU) \
  if (nx == NXX && nu == NUU) return launch<NXX, NUU, F>(a, Bsz, T, reg, s);
  RICCATI_HORIZON_WARP_SHAPES(RICCATI_HORIZON_WARP_LAUNCH)
#undef RICCATI_HORIZON_WARP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int smem(int nx, int nu, int* per_element, int* per_block, int* device_max) {
#define RICCATI_HORIZON_WARP_SMEM(NXX, NUU)                               \
  if (nx == NXX && nu == NUU)                                             \
    return horizon_warp_smem<NXX, NUU, F>(per_element, per_block,         \
                                          device_max);
  RICCATI_HORIZON_WARP_SHAPES(RICCATI_HORIZON_WARP_SMEM)
#undef RICCATI_HORIZON_WARP_SMEM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace dqmpc

// Values a stage keeps in the workspace per element (K, k, P, p) for
// (nx, nu), or 0 where the kernel is not built for it. The caller passes a
// workspace of B·T·W scalars of the inputs' type.
extern "C" int riccati_horizon_warp_workspace(int nx, int nu) {
#define RICCATI_HORIZON_WARP_W(NXX, NUU) \
  if (nx == NXX && nu == NUU) return dqmpc::HorizonWarpLayout<NXX, NUU>::W;
  RICCATI_HORIZON_WARP_SHAPES(RICCATI_HORIZON_WARP_W)
#undef RICCATI_HORIZON_WARP_W
  return 0;
}

// Cxx [B,T,nx,nx], Cxu [B,T,nx,nu], Cuu [B,T,nu,nu], gx [B,T,nx],
// gu [B,T,nu], A [B,T-1,nx,nx], B [B,T-1,nx,nu], r [B,T-1,nx], dx0 [B,nx]
// -> dx [B,T,nx], du [B,T,nu], lam [B,T,nx], all contiguous; ws holds
// B·T·W scalars (riccati_horizon_warp_workspace). Built for (nx, nu) =
// (12, 4), (16, 4), (2, 1), (4, 1), (5, 1), (6, 1) and (7, 1), any T ≥ 1;
// cudaErrorInvalidValue otherwise, cudaErrorInvalidConfiguration when a
// block's shared memory exceeds what the device allows. Returns a
// cudaError_t code.
#define RICCATI_HORIZON_WARP_ENTRY(NAME, F)                                  \
  extern "C" int NAME(const void* Cxx, const void* Cxu, const void* Cuu,     \
                      const void* gx, const void* gu, const void* A,         \
                      const void* B, const void* r, const void* dx0,         \
                      void* dx, void* du, void* lam, void* ws, int Bsz,      \
                      int T, int nx, int nu, double reg, void* stream) {     \
    dqmpc::HorizonWarpArgs a{Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0,            \
                             dx, du, lam, ws};                               \
    return dqmpc::dispatch<F>(a, Bsz, T, nx, nu, reg, stream);               \
  }

RICCATI_HORIZON_WARP_ENTRY(riccati_horizon_warp_f32, float)
RICCATI_HORIZON_WARP_ENTRY(riccati_horizon_warp_f64, double)

// Shared memory of the (nx, nu, dtype) instantiation (see
// dqmpc::horizon_warp_smem). Returns a cudaError_t code.
extern "C" int riccati_horizon_warp_smem_f32(int nx, int nu, int* per_element,
                                             int* per_block,
                                             int* device_max) {
  return dqmpc::smem<float>(nx, nu, per_element, per_block, device_max);
}

extern "C" int riccati_horizon_warp_smem_f64(int nx, int nu, int* per_element,
                                             int* per_block,
                                             int* device_max) {
  return dqmpc::smem<double>(nx, nu, per_element, per_block, device_max);
}
