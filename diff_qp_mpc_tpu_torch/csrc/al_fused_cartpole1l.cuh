// K2's functor for the 1-link cartpole (diff_qp_mpc_tpu/models/cartpole.py,
// Cartpole1L): Cartpole1LSys for the warp layout of al_fused_warp.cuh
// (al_fused_cartpole1l.cu) and Cartpole1LDyn for the one-lane kernel of
// al_fused_common.cuh, which the host build of that source runs
// (utils/k2_host.py).
#pragma once

#include "al_fused_common.cuh"

namespace dqmpc {

// State (x, θ, ẋ, θ̇), θ from down; RK4. The equations of motion in closed
// form, from T = ½Mẋ² + ½m(ẋ² + l²θ̇² + 2lθ̇ẋ cosθ) and V = −mgl cosθ:
// M(q) = [[M+m, ml cosθ], [ml cosθ, ml²]], b = τ − c = (u + ml θ̇² sinθ,
// −mgl sinθ), and M q̈ = b by elimination without pivoting in the order of
// the JAX package's manipulator_accel_parts (lagrangian.py:100-115). The
// plain version, operation for operation, is models/cartpole.py's
// Cartpole1L._ode_parts.
struct Cartpole1LSys {
  static constexpr int NX = 4;
  static constexpr int NU = 1;

  // (M + m, m·l, m·l², m·g·l, dt, dt/2, dt/6), folded in double precision
  template <typename F>
  struct Params {
    F m00, ml, ml2, mgl, dt, h, dt6;
  };

  template <typename F>
  static Params<F> load(const double* p) {
    return {static_cast<F>(p[0]), static_cast<F>(p[1]), static_cast<F>(p[2]),
            static_cast<F>(p[3]), static_cast<F>(p[4]), static_cast<F>(p[5]),
            static_cast<F>(p[6])};
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void ode(const Params<F>& p, const S* x,
                                             const S* u, S* xd) {
    const S s = sin_of(x[1]), c = cos_of(x[1]);
    const S m01 = p.ml * c;
    const S b0 = u[0] + p.ml * (x[3] * x[3]) * s;
    S b1 = -(p.mgl * s);
    const F inv0 = F(1) / p.m00;
    const S f = m01 * inv0;
    const S a11 = p.ml2 - f * m01;
    b1 = b1 - f * b0;
    const S qdd1 = b1 / a11;
    const S qdd0 = (b0 - m01 * qdd1) / p.m00;
    xd[0] = x[2];
    xd[1] = x[3];
    xd[2] = qdd0;
    xd[3] = qdd1;
  }
};

template <typename F>
using Cartpole1LDyn = Rk4Dyn<Cartpole1LSys, F>;

}  // namespace dqmpc
