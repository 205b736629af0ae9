// K2 for the Rex quadrotor (diff_qp_mpc_tpu/models/quadrotor.py,
// RexQuadrotor): its functor and its instantiations, float32 and float64 at
// T 5, on the warp layout of al_fused_warp.cuh (four warps per element, the
// fastest of W 1, 2 and 4 at B 64-256 on the card, PERF.md; its blocks in
// shared memory). Built for the host by utils/k2_host.py
// (K2_HOST defined), the same functor runs al_fused_common.cuh's one-lane
// kernel at G 1 instead, to bisect the functor's and the merit's rounding
// off the card.
#include "al_fused_common.cuh"
#ifndef K2_HOST
#include "al_fused_warp.cuh"
#endif

namespace dqmpc {

// State (r, m, v, ω): position, MRP attitude, body-frame velocity, body
// rates; RK4 with controls scaled by act. With q = quat(m) = (qs, q⃗) =
// ((1 − |m|²), 2m)/(1 + |m|²) and ss = qs² − |q⃗|²:
//   F = (gravity (0, 0, gz) rotated by q's conjugate) − sign(m)·kd·m²
//       + (0, 0, kf Σu + 4bf),
//   τ = (Σ ay_k th_k, −Σ ax_k th_k, km (u₀ − u₁ + u₂ − u₃)), th_k = kf u_k + bf,
//   ṙ = q v q*, ṁ = ¼A(m)ω, v̇ = F/m − ω×v, ω̇ = J⁻¹(τ − ω×Jω),
// the JAX package's _quad_ode_parts (quadrotor.py:115-194) with its products
// by known zeros left out. J⁻¹ is folded on the host in float64. The plain
// version, operation for operation, is models/quadrotor.py's
// RexQuadrotor._ode_parts.
struct QuadrotorSys {
  static constexpr int NX = 12;
  static constexpr int NU = 4;

  // RexQuadrotor.PARAMS, folded in double precision
  template <typename F>
  struct Params {
    F act, kf, bf, bf4, km, mass, gz, kd[3], ax[4], ay[4], J[3][3], Ji[3][3],
        dt, h, dt6;
  };

  template <typename F>
  static Params<F> load(const double* p) {
    Params<F> q;
    q.act = static_cast<F>(p[0]);
    q.kf = static_cast<F>(p[1]);
    q.bf = static_cast<F>(p[2]);
    q.bf4 = static_cast<F>(p[3]);
    q.km = static_cast<F>(p[4]);
    q.mass = static_cast<F>(p[5]);
    q.gz = static_cast<F>(p[6]);
    for (int i = 0; i < 3; ++i) q.kd[i] = static_cast<F>(p[7 + i]);
    for (int k = 0; k < 4; ++k) {
      q.ax[k] = static_cast<F>(p[10 + k]);
      q.ay[k] = static_cast<F>(p[14 + k]);
    }
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        q.J[i][j] = static_cast<F>(p[18 + 3 * i + j]);
        q.Ji[i][j] = static_cast<F>(p[27 + 3 * i + j]);
      }
    q.dt = static_cast<F>(p[36]);
    q.h = static_cast<F>(p[37]);
    q.dt6 = static_cast<F>(p[38]);
    return q;
  }

  // the sign of a scalar or of a dual's value (its derivative is 0)
  template <typename F>
  __device__ __forceinline__ static F sign_of(F a) {
    return F(a > F(0) ? 1 : 0) - F(a < F(0) ? 1 : 0);
  }
  template <typename F>
  __device__ __forceinline__ static F sign_of(Dual<F> a) {
    return sign_of(a.v);
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void cross(const S* a, const S* b, S* c) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void ode(const Params<F>& p, const S* x,
                                             const S* us, S* xd) {
    const S* m = x + 3;
    const S* v = x + 6;
    const S* w = x + 9;
    S u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = p.act * us[k];
    const S sq = m[0] * m[0] + m[1] * m[1] + m[2] * m[2];
    const S inv = F(1) / (F(1) + sq);
    const S qs = (F(1) - sq) * inv;
    S q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) q[i] = F(2) * m[i] * inv;
    const S ss = qs * qs - (q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
    // forces in the body frame
    S qg[3], df[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      qg[i] = q[i] * p.gz;
      df[i] = -(sign_of(m[i]) * p.kd[i]) * m[i] * m[i];
    }
    const S F_z = p.kf * (u[0] + u[1] + u[2] + u[3]);
    S Fb[3];
    Fb[0] = (F(2) * q[0]) * qg[2] - (F(2) * qs) * qg[1] + df[0];
    Fb[1] = (F(2) * q[1]) * qg[2] + (F(2) * qs) * qg[0] + df[1];
    Fb[2] = ss * p.gz + (F(2) * q[2]) * qg[2] + df[2] + F_z + p.bf4;
    // moments
    S th[4], Mk[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Mk[k] = p.km * u[k];
      th[k] = p.kf * u[k] + p.bf;
    }
    S tau[3];
    tau[0] = p.ay[0] * th[0];
    tau[1] = -(p.ax[0] * th[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      tau[0] = tau[0] + p.ay[k] * th[k];
      tau[1] = tau[1] - p.ax[k] * th[k];
    }
    tau[2] = Mk[0] - Mk[1] + Mk[2] - Mk[3];
    // kinematics
    const S dqr = q[0] * v[0] + q[1] * v[1] + q[2] * v[2];
    S c[3];
    cross<S, F>(q, v, c);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xd[i] = ss * v[i] + (F(2) * q[i]) * dqr + (F(2) * qs) * c[i];
    const S p00 = m[0] * m[0], p11 = m[1] * m[1], p22 = m[2] * m[2];
    const S A[3][3] = {
        {F(1) + p00 - p11 - p22, F(2) * (m[0] * m[1] - m[2]),
         F(2) * (m[0] * m[2] + m[1])},
        {F(2) * (m[1] * m[0] + m[2]), F(1) - p00 + p11 - p22,
         F(2) * (m[1] * m[2] - m[0])},
        {F(2) * (m[2] * m[0] - m[1]), F(2) * (m[2] * m[1] + m[0]),
         F(1) - p00 - p11 + p22}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xd[3 + i] = F(0.25) * (A[i][0] * w[0] + A[i][1] * w[1] + A[i][2] * w[2]);
    S wxv[3];
    cross<S, F>(w, v, wxv);
#pragma unroll
    for (int i = 0; i < 3; ++i) xd[6 + i] = Fb[i] / p.mass - wxv[i];
    S Jw[3], wxJw[3], rhs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      Jw[i] = p.J[i][0] * w[0] + p.J[i][1] * w[1] + p.J[i][2] * w[2];
    cross<S, F>(w, Jw, wxJw);
#pragma unroll
    for (int i = 0; i < 3; ++i) rhs[i] = tau[i] - wxJw[i];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      xd[9 + i] =
          p.Ji[i][0] * rhs[0] + p.Ji[i][1] * rhs[1] + p.Ji[i][2] * rhs[2];
  }
};

template <typename F>
using QuadrotorDyn = Rk4Dyn<QuadrotorSys, F>;

}  // namespace dqmpc

#ifndef K2_HOST
AL_WARP_ENTRY(al_fused_quadrotor_f32, float,
              AL_WARP_CASE(5, dqmpc::QuadrotorSys, float, 4))
AL_WARP_ENTRY(al_fused_quadrotor_f64, double,
              AL_WARP_CASE(5, dqmpc::QuadrotorSys, double, 4))
AL_WARP_SMEM_ENTRY(al_fused_quadrotor_smem_f32,
                   AL_WARP_SMEM_CASE(5, dqmpc::QuadrotorSys, float, 4))
AL_WARP_SMEM_ENTRY(al_fused_quadrotor_smem_f64,
                   AL_WARP_SMEM_CASE(5, dqmpc::QuadrotorSys, double, 4))
#else
// the host build: the one-lane kernel at G 1 only
AL_FUSED_ENTRY(al_fused_quadrotor_f32, float,
               AL_HOST_CASE(5, dqmpc::QuadrotorDyn, float))
AL_FUSED_ENTRY(al_fused_quadrotor_f64, double,
               AL_HOST_CASE(5, dqmpc::QuadrotorDyn, double))
#endif
