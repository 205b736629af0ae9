// K2's functor for the 2-link cartpole (diff_qp_mpc_tpu/models/cartpole.py,
// Cartpole2L, the default model and .pkg() alike): Cartpole2LSys for the
// warp layout of al_fused_warp.cuh (al_fused_cartpole2l.cu) and
// Cartpole2LDyn for the one-lane kernel of al_fused_common.cuh, which the
// host build of that source runs (utils/k2_host.py).
#pragma once

#include "al_fused_common.cuh"

namespace dqmpc {

// State (x, θ₁, θ₂, ẋ, θ̇₁, θ̇₂), θ from down, θ₂ relative to link 1; RK4.
// Mass points m₁, m₂ at r₁ = com·l₁, r₂ = com·l₂ along the links and a
// rotational inertia I (link_inertia) of each link about its absolute
// rate, so M, m₁, m₂, l₁, l₂, g, com and I are run-time constants. With
// c₁ = cos θ₁, c₂ = cos θ₂, c₁₂ = cos(θ₁ + θ₂) (s the sines), ω₁₂ = θ̇₁ +
// θ̇₂, k₁ = m₁r₁ + m₂l₁, k₂ = m₂r₂, k₃ = m₂l₁r₂, the equations of motion of
// the energies in closed form are M(q) q̈ = b with
//   M = [[M+m₁+m₂, k₁c₁ + k₂c₁₂, k₂c₁₂],
//        [·, m₁r₁² + m₂(l₁² + r₂²) + 2I + 2k₃c₂, m₂r₂² + I + k₃c₂],
//        [·, ·, m₂r₂² + I]],
//   b = (u + k₁s₁θ̇₁² + k₂s₁₂ω₁₂², k₃s₂θ̇₂(2θ̇₁ + θ̇₂) − g(k₁s₁ + k₂s₁₂),
//        −k₃s₂θ̇₁² − g k₂s₁₂),
// solved by elimination without pivoting in the order of the JAX package's
// manipulator_accel_parts (lagrangian.py:100-115). The plain version,
// operation for operation, is models/cartpole.py's Cartpole2L._ode_parts.
struct Cartpole2LSys {
  static constexpr int NX = 6;
  static constexpr int NU = 1;

  // (M+m₁+m₂, k₁, k₂, k₃, 2k₃, m₁r₁² + m₂(l₁² + r₂²) + 2I, m₂r₂² + I, g·k₁,
  // g·k₂, dt, dt/2, dt/6), folded in double precision
  template <typename F>
  struct Params {
    F m00, k1, k2, k3, k3x2, m11c, m12c, gk1, gk2, dt, h, dt6;
  };

  template <typename F>
  static Params<F> load(const double* p) {
    return {static_cast<F>(p[0]),  static_cast<F>(p[1]),
            static_cast<F>(p[2]),  static_cast<F>(p[3]),
            static_cast<F>(p[4]),  static_cast<F>(p[5]),
            static_cast<F>(p[6]),  static_cast<F>(p[7]),
            static_cast<F>(p[8]),  static_cast<F>(p[9]),
            static_cast<F>(p[10]), static_cast<F>(p[11])};
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void ode(const Params<F>& p, const S* x,
                                             const S* u, S* xd) {
    const S th1 = x[1], th2 = x[2], w1 = x[4], w2 = x[5];
    const S s1 = sin_of(th1), c1 = cos_of(th1);
    const S s2 = sin_of(th2), c2 = cos_of(th2);
    const S phi = th1 + th2;
    const S sp = sin_of(phi), cp = cos_of(phi);
    const S w12 = w1 + w2;
    const S m01 = p.k1 * c1 + p.k2 * cp;
    const S m02 = p.k2 * cp;
    const S m11 = p.m11c + p.k3x2 * c2;
    const S m12 = p.m12c + p.k3 * c2;
    const F m22 = p.m12c;
    const S k3s2 = p.k3 * s2;
    const S gk2sp = p.gk2 * sp;
    const S b0 = u[0] + p.k1 * s1 * (w1 * w1) + p.k2 * sp * (w12 * w12);
    S b1 = k3s2 * w2 * (F(2) * w1 + w2) - (p.gk1 * s1 + gk2sp);
    S b2 = -(k3s2 * (w1 * w1)) - gk2sp;
    // M q̈ = b, no pivoting (M is SPD)
    const F inv0 = F(1) / p.m00;
    S f = m01 * inv0;
    const S a11 = m11 - f * m01;
    const S a12 = m12 - f * m02;
    b1 = b1 - f * b0;
    f = m02 * inv0;
    const S a21 = m12 - f * m01;
    S a22 = m22 - f * m02;
    b2 = b2 - f * b0;
    const S inv1 = F(1) / a11;
    f = a21 * inv1;
    a22 = a22 - f * a12;
    b2 = b2 - f * b1;
    const S qdd2 = b2 / a22;
    const S qdd1 = (b1 - a12 * qdd2) / a11;
    const S qdd0 = (b0 - m01 * qdd1 - m02 * qdd2) / p.m00;
    xd[0] = x[3];
    xd[1] = w1;
    xd[2] = w2;
    xd[3] = qdd0;
    xd[4] = qdd1;
    xd[5] = qdd2;
  }
};

template <typename F>
using Cartpole2LDyn = Rk4Dyn<Cartpole2LSys, F>;

}  // namespace dqmpc
