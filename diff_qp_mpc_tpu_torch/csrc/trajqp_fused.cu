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
// The arithmetic's chain: each IEEE division and square root is a sequence
// with a slow-path branch that the compiler does not schedule other work
// across, and they set this kernel's time (-use_fast_math took it from 0.089
// to 0.021 ms at (5, 2, 1), float32, B 64, on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md, Findings). So the iteration divides as little as its
// results allow (at every shape and dtype but float32 (5, 3, 2), which
// FewDivisions names), each division still correctly rounded: one
// reciprocal of each slack per iteration (s does not change between the
// predictor's and the corrector's KKT step), so the z/s terms, the
// (z r_p − r_s)/s terms and the dz recovery are multiplies; one division
// per ratio test (max_step: the blocking entry chosen by a tree of cross
// products); and at one control the Riccati recursion's scalar pivot
// (riccati_solve's kScalarPivot: one reciprocal of Quu + reg a stage
// instead of a square root and 2·(nx + 1) divisions). The results differ
// from dividing each term by rounding only. In float64 at (5, 3, 1),
// (5, 3, 2) and (5, 4, 1) the element's working state does not fit the
// registers: there it lives in shared memory (SharedWork), which costs
// less time than the spilled copies in local memory did.
//
// Semantics kept from the Pallas kernel (line numbers in
// trajqp_fused_pallas.py), which differ from the scan IPM of
// solvers/trajqp.py: u clipped to [u_lo + 1e-3, u_hi − 1e-3] again inside
// (:64), the clip constants folded in double precision as the reference's
// Python floats are; `big` = float32's max in every dtype (:60: the
// step of an entry with dv ≥ 0, which never blocks), also the initial best
// total (:270); σ's denominator floored at 1e-30 (:233); the
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
// runs one long serial chain, so it is latency-bound. Serving an element
// with a group of lanes, its state in shared memory, was measured slower at
// every batch timed: the lanes do not shorten the chain of divisions and
// square roots (PERF.md, Findings).
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <type_traits>

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

// 1/s_hi and 1/s_lo, correctly rounded: the divisions of an iteration's
// two KKT steps.
template <int T, int NU, typename F>
struct InvSlack {
  F hi[T][NU], lo[T][NU];
};

template <int T, int NX, int NU, typename F>
__device__ __forceinline__ void inv_slack(const IPState<T, NX, NU, F>& s,
                                          InvSlack<T, NU, F>& is) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      is.hi[t][i] = F(1) / s.sh[t][i];
      is.lo[t][i] = F(1) / s.sl[t][i];
    }
  }
}

// Which (shape, dtype) takes the arithmetic with few divisions (R in the
// functions below): every one but float32 (5, 3, 2), which keeps a division
// per term: there the kernel's error against the float64 solution on the
// profiler's random QPs at B 4096 was 2.04 times the plain float32
// version's, past the 2× rule (NVIDIA H100 80GB HBM3 at 700 W; PERF.md,
// Findings).
template <int T, int NX, int NU, typename F>
struct FewDivisions : std::true_type {};
template <>
struct FewDivisions<5, 3, 2, float> : std::false_type {};

// An element's working state: the iterate, the best one, the residuals and
// the steps (the predictor's and the combined one).
template <int T, int NX, int NU, typename F>
struct IPWork {
  IPState<T, NX, NU, F> s, best;
  IPResiduals<T, NX, NU, F> r, rc;
  IPStep<T, NX, NU, F> da, d;
};

// Where the element's IPWork lives: in registers and local memory, or
// (SharedWork) in shared memory, one record a thread kWorkStride scalars
// apart (odd, so that the 32 lanes reading the same entry hit 32 banks),
// in blocks of 32 threads (float64 (5, 3, 2): 120 KB a block). In float64
// at (5, 3, 1), (5, 3, 2) and (5, 4, 1) the registers held too little of
// it: with few divisions a thread spilled 4.7-26.5 KB, and the few-division
// arithmetic lost to the division per term at (5, 3, 1) and (5, 3, 2).
// With the work in shared memory and few divisions, B 64: 0.2250 →
// 0.1714 ms, 0.5919 → 0.4108 and 0.7219 → 0.3607 against the kernel
// before (a division per term at the first two, few divisions in
// registers at (5, 4, 1)) in one call (NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md, Findings).
template <int T, int NX, int NU, typename F>
struct SharedWork : std::false_type {};
template <>
struct SharedWork<5, 3, 1, double> : std::true_type {};
template <>
struct SharedWork<5, 3, 2, double> : std::true_type {};
template <>
struct SharedWork<5, 4, 1, double> : std::true_type {};

template <int T, int NX, int NU, typename F>
constexpr int kWorkStride =
    static_cast<int>(sizeof(IPWork<T, NX, NU, F>) / sizeof(F)) | 1;

template <int T, int NX, int NU, typename F>
constexpr int block_threads() {
  return SharedWork<T, NX, NU, F>::value ? 32 : 64;
}

// Bytes of dynamic shared memory a block takes.
template <int T, int NX, int NU, typename F>
constexpr int work_smem_bytes() {
  return SharedWork<T, NX, NU, F>::value
             ? block_threads<T, NX, NU, F>() * kWorkStride<T, NX, NU, F> *
                   static_cast<int>(sizeof(F))
             : 0;
}

// One part of the work: a local X, or with S the X at p in shared memory.
template <bool S, class X>
struct Home {
  X v;
  __device__ __forceinline__ explicit Home(X*) {}
  __device__ __forceinline__ X& operator*() { return v; }
};
template <class X>
struct Home<true, X> {
  X* p;
  __device__ __forceinline__ explicit Home(X* q) : p(q) {}
  __device__ __forceinline__ X& operator*() { return *p; }
};

// Eliminate the box rows, solve the Riccati KKT system, recover (ds, dz);
// with R, is holds the reciprocals of s's slacks, else each term divides.
template <int T, int NX, int NU, typename F, bool R>
__device__ __forceinline__ void kkt_step(
    const IPProblem<T, NX, NU, F>& P, const IPState<T, NX, NU, F>& s,
    const InvSlack<T, NU, F>& is, const IPResiduals<T, NX, NU, F>& r,
    F reg, IPStep<T, NX, NU, F>& d) {
  F Cuu_eff[T][NU][NU], gu[T][NU], neg_rdyn[T - 1][NX], neg_rinit[NX];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) Cuu_eff[t][i][j] = P.Cuu[t][i][j];
      F dd, extra;
      if constexpr (R) {
        dd = s.zh[t][i] * is.hi[t][i] + s.zl[t][i] * is.lo[t][i];
        extra = (s.zh[t][i] * r.rph[t][i] - r.rsh[t][i]) * is.hi[t][i] -
                (s.zl[t][i] * r.rpl[t][i] - r.rsl[t][i]) * is.lo[t][i];
      } else {
        dd = s.zh[t][i] / s.sh[t][i] + s.zl[t][i] / s.sl[t][i];
        extra = (s.zh[t][i] * r.rph[t][i] - r.rsh[t][i]) / s.sh[t][i] -
                (s.zl[t][i] * r.rpl[t][i] - r.rsl[t][i]) / s.sl[t][i];
      }
      Cuu_eff[t][i][i] = Cuu_eff[t][i][i] + dd;
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
  riccati_solve<T, NX, NU, F, R && NU == 1>(
      P.lqr, Cuu_eff, r.rx, gu, neg_rdyn, neg_rinit, reg, d.dx, d.du, d.dl);
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      d.dsh[t][i] = -r.rph[t][i] - d.du[t][i];
      d.dsl[t][i] = -r.rpl[t][i] + d.du[t][i];
      if constexpr (R) {
        d.dzh[t][i] = -(r.rsh[t][i] + s.zh[t][i] * d.dsh[t][i]) * is.hi[t][i];
        d.dzl[t][i] = -(r.rsl[t][i] + s.zl[t][i] * d.dsl[t][i]) * is.lo[t][i];
      } else {
        d.dzh[t][i] = -(r.rsh[t][i] + s.zh[t][i] * d.dsh[t][i]) / s.sh[t][i];
        d.dzl[t][i] = -(r.rsl[t][i] + s.zl[t][i] * d.dsl[t][i]) / s.sl[t][i];
      }
    }
  }
}

// An entry's ratio v/(−dv), dv < 0, as its two terms.
template <typename F>
struct Ratio {
  F v, dv;
};

// The lesser of two ratios, by cross products (both denominators positive):
// a when a.v·(−b.dv) ≤ b.v·(−a.dv).
template <typename F>
__device__ __forceinline__ Ratio<F> lesser(const Ratio<F>& a,
                                           const Ratio<F>& b) {
  return a.v * (-b.dv) <= b.v * (-a.dv) ? a : b;
}

// Largest step in (0, 1] keeping v + a·dv ≥ 0, over s_hi, s_lo, z_hi, z_lo:
// min(1, the least −v/dv over dv < 0). With R, only an entry with v < −dv
// can block (its ratio is below 1); every other entry stands as the cap,
// 1/(−(−1)). The least ratio is found by a tree of cross-product comparisons
// and divided once. Without R each entry with dv < 0 divides and a
// NaN-keeping minimum takes them in order. Either way a NaN v where dv < 0
// gives NaN, and a NaN dv is skipped.
template <int T, int NX, int NU, typename F, bool R>
__device__ __forceinline__ F max_step(const IPState<T, NX, NU, F>& s,
                                      const IPStep<T, NX, NU, F>& d) {
  if constexpr (!R) {
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
  constexpr int M = 4 * T * NU;
  Ratio<F> r[M];
  bool has_nan = false;
  F nan = F(0);
  auto fill = [&](int base, const F (&v)[T][NU], const F (&dv)[T][NU]) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const F vi = v[t][i], di = dv[t][i];
        const bool blocks = di < F(0) && vi < -di;
        r[base + t * NU + i] =
            blocks ? Ratio<F>{vi, di} : Ratio<F>{F(1), F(-1)};
        if (di < F(0) && vi != vi) {
          has_nan = true;
          nan = vi;
        }
      }
    }
  };
  fill(0, s.sh, d.dsh);
  fill(T * NU, s.sl, d.dsl);
  fill(2 * T * NU, s.zh, d.dzh);
  fill(3 * T * NU, s.zl, d.dzl);
#pragma unroll
  for (int w = 1; w < M; w *= 2) {
#pragma unroll
    for (int k = 0; k + w < M; k += 2 * w) r[k] = lesser(r[k], r[k + w]);
  }
  return has_nan ? nan : -r[0].v / r[0].dv;
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
  constexpr bool R = FewDivisions<T, NX, NU, F>::value;
  constexpr bool S = SharedWork<T, NX, NU, F>::value;
  using W = IPWork<T, NX, NU, F>;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Bsz) return;
  const size_t E = static_cast<size_t>(e);
  W* w = nullptr;  // this thread's record in shared memory, with S
  if constexpr (S) {
    extern __shared__ __align__(16) unsigned char smem[];
    w = reinterpret_cast<W*>(reinterpret_cast<F*>(smem) +
                             threadIdx.x * kWorkStride<T, NX, NU, F>);
  }
  // the record's member m with S, else none (the part is a local)
  auto part = [&](auto W::*m) { return S ? &(w->*m) : nullptr; };

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
  Home<S, IPState<T, NX, NU, F>> s_home(part(&W::s));
  IPState<T, NX, NU, F>& s = *s_home;
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
  Home<S, IPState<T, NX, NU, F>> best_home(part(&W::best));
  IPState<T, NX, NU, F>& best = *best_home;
  best = s;
  F b_tot = F(FLT_MAX);
  const F n_comp = F(2 * T * NU);

  for (int it = 0; it < max_iter; ++it) {
    Home<S, IPResiduals<T, NX, NU, F>> r_home(part(&W::r));
    IPResiduals<T, NX, NU, F>& r = *r_home;
    residuals(P, box, s, r);
    F mu;
    const F total = resid_norm(r, mu);
    const bool better = total < b_tot;
    if (better) best = s;
    b_tot = better ? total : b_tot;

    InvSlack<T, NU, F> is;
    if constexpr (R) inv_slack(s, is);

    // ---- affine (predictor) ----
    Home<S, IPStep<T, NX, NU, F>> da_home(part(&W::da));
    IPStep<T, NX, NU, F>& da = *da_home;
    kkt_step<T, NX, NU, F, R>(P, s, is, r, reg, da);
    const F a_aff = max_step<T, NX, NU, F, R>(s, da);
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
    Home<S, IPResiduals<T, NX, NU, F>> rc_home(part(&W::rc));
    IPResiduals<T, NX, NU, F>& rc = *rc_home;
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
    Home<S, IPStep<T, NX, NU, F>> d_home(part(&W::d));
    IPStep<T, NX, NU, F>& d = *d_home;
    kkt_step<T, NX, NU, F, R>(P, s, is, rc, reg, d);

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
    const F alpha = F(0.99) * max_step<T, NX, NU, F, R>(s, d);
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
  Home<S, IPResiduals<T, NX, NU, F>> r_home(part(&W::r));
  IPResiduals<T, NX, NU, F>& r = *r_home;
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
  constexpr int bytes = work_smem_bytes<T, NX, NU, F>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        trajqp_fused_kernel<T, NX, NU, F>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int threads = block_threads<T, NX, NU, F>();
  const int blocks = (Bsz + threads - 1) / threads;
  trajqp_fused_kernel<T, NX, NU, F><<<blocks, threads, bytes, s>>>(
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
