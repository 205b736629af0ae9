// K2 for the two CosSin models, the legacy qpth encodings with (cos θ,
// sin θ) in the state: PendulumCosSin (diff_qp_mpc_tpu/models/pendulum.py)
// and CartpoleCosSin (models/cartpole.py). Their functors and their
// instantiations, float32 at T 5 and 10, float64 at T 5, each at G = 1 .. 32
// (the kernel is al_fused_common.cuh's).
//
// Each step is one Euler step with the control clipped inside it and θ
// recovered by atan2 from (sin θ, cos θ). The step is a template on its
// scalar (F or Dual<F>), so the Jacobian is the one forward-mode
// differentiation of the step evaluates, one dual pass per input column, as
// the TPU kernel's jax.jvp per column. Each operation, and its order, is
// the plain version's (the models' step_parts on models/dual.py's Dual):
// atan2's tangent is JAX's, (ẏ·x − ẋ·y)/(y² + x²) written as its two terms,
// and the clip's tangent is 1 inside the box, ½ at a bound and 0 beyond,
// as JAX's maximum-then-minimum gives it.
#include "al_fused_common.cuh"

namespace dqmpc {

template <typename F>
__device__ __forceinline__ F atan2_of(F y, F x) {
  return atan2(y, x);
}
template <typename F>
__device__ __forceinline__ Dual<F> atan2_of(Dual<F> y, Dual<F> x) {
  const F den = y.v * y.v + x.v * x.v;
  return {atan2(y.v, x.v), y.d * (x.v / den) + (x.d * -y.v) / den};
}

// a clipped to [lo, hi], a NaN kept (as torch.clamp and jnp.clip)
template <typename F>
__device__ __forceinline__ F clip_of(F a, F lo, F hi) {
  return a != a ? a : (a < lo ? lo : (a > hi ? hi : a));
}
template <typename F>
__device__ __forceinline__ Dual<F> clip_of(Dual<F> a, F lo, F hi) {
  const F s = (a.v > lo && a.v < hi)
                  ? F(1)
                  : ((a.v == lo || a.v == hi) ? F(0.5) : F(0));
  return {clip_of(a.v, lo, hi), a.d * s};
}

// State (cos θ, sin θ, θ̇), θ from upright: θ̈ = k_sin·(−sin θ) + 3τ/(m l²)
// with k_sin = −3g/(2l) and τ clipped to ±max_torque; Euler on θ̇, then θ.
struct PendulumCosSinSys {
  static constexpr int NX = 3;
  static constexpr int NU = 1;

  // (dt, −3g/(2l), m·l², max_torque), folded in double precision
  template <typename F>
  struct Params {
    F dt, k_sin, ml2, max_torque;
  };

  template <typename F>
  static Params<F> load(const double* p) {
    return {static_cast<F>(p[0]), static_cast<F>(p[1]), static_cast<F>(p[2]),
            static_cast<F>(p[3])};
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void step(const Params<F>& p, const S* x,
                                              const S* u, S* xn) {
    const S th = atan2_of(x[1], x[0]);
    const S tau = clip_of(u[0], -p.max_torque, p.max_torque);
    const S thddot = p.k_sin * -x[1] + F(3) * tau / p.ml2;
    const S new_thdot = x[2] + thddot * p.dt;
    const S new_th = th + new_thdot * p.dt;
    xn[0] = cos_of(new_th);
    xn[1] = sin_of(new_th);
    xn[2] = new_thdot;
  }
};

// State (x, ẋ, cos θ, sin θ, θ̇), θ from upright: the classic gym cartpole
// (a half-pole's 4/3 moment factor), the force clipped to ±force_mag, Euler
// on every coordinate.
struct CartpoleCosSinSys {
  static constexpr int NX = 5;
  static constexpr int NU = 1;

  // (dt, g, m_cart + m_pole, m_pole·l, m_pole, l, force_mag), folded in
  // double precision
  template <typename F>
  struct Params {
    F dt, g, total, pml, mp, l, fm;
  };

  template <typename F>
  static Params<F> load(const double* p) {
    return {static_cast<F>(p[0]), static_cast<F>(p[1]), static_cast<F>(p[2]),
            static_cast<F>(p[3]), static_cast<F>(p[4]), static_cast<F>(p[5]),
            static_cast<F>(p[6])};
  }

  template <typename S, typename F>
  __device__ __forceinline__ static void step(const Params<F>& p, const S* x,
                                              const S* u, S* xn) {
    const S f = clip_of(u[0], -p.fm, p.fm);
    const S th = atan2_of(x[3], x[2]);
    const S cart_in = (f + p.pml * (x[4] * x[4]) * x[3]) / p.total;
    const S th_acc = (p.g * x[3] - x[2] * cart_in) /
                     (p.l * (F(4.0 / 3.0) - p.mp * (x[2] * x[2]) / p.total));
    const S x_acc = cart_in - p.pml * th_acc * x[2] / p.total;
    const S th_n = th + p.dt * x[4];
    xn[0] = x[0] + p.dt * x[1];
    xn[1] = x[1] + p.dt * x_acc;
    xn[2] = cos_of(th_n);
    xn[3] = sin_of(th_n);
    xn[4] = x[4] + p.dt * th_acc;
  }
};

// The step and one Jacobian column as called device functions, one copy
// per (Sys, F) for every (T, G) instantiation (see rk4_value).
template <class Sys, typename F>
__device__ __noinline__ Vec<F, Sys::NX> euler_value(
    typename Sys::template Params<F> p, Vec<F, Sys::NX + Sys::NU> xu) {
  Vec<F, Sys::NX> out;
  Sys::template step<F, F>(p, xu.v, xu.v + Sys::NX, out.v);
  return out;
}

// ∂ step / ∂ (x, u)_j: the step on duals seeded with the unit vector e_j.
template <class Sys, typename F>
__device__ __noinline__ Vec<F, Sys::NX> euler_column(
    typename Sys::template Params<F> p, Vec<F, Sys::NX + Sys::NU> xu,
    int j) {
  constexpr int NX = Sys::NX, NU = Sys::NU;
  Dual<F> x[NX], u[NU], xn[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = {xu.v[i], F(i == j ? 1 : 0)};
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = {xu.v[NX + i], F(NX + i == j ? 1 : 0)};
  Sys::template step<Dual<F>, F>(p, x, u, xn);
  Vec<F, NX> out;
#pragma unroll
  for (int i = 0; i < NX; ++i) out.v[i] = xn[i].d;
  return out;
}

// K2's model functor for a system with a closed-form step (the interface
// of PendulumDyn in al_fused.cu; the Jacobian as Rk4Dyn's, by columns).
template <class Sys, typename F>
struct DualStepDyn {
  static constexpr int NX = Sys::NX;
  static constexpr int NU = Sys::NU;
  static constexpr bool kRoundedMerit = true;  // see merit_constraints
  typename Sys::template Params<F> p;

  static DualStepDyn make(const double* params) {
    return {Sys::template load<F>(params)};
  }

  __device__ __forceinline__ void step(const F* x, const F* u, F* xn) const {
    Vec<F, NX + NU> xu;
#pragma unroll
    for (int i = 0; i < NX; ++i) xu.v[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) xu.v[NX + i] = u[i];
    const Vec<F, NX> r = euler_value<Sys, F>(p, xu);
#pragma unroll
    for (int i = 0; i < NX; ++i) xn[i] = r.v[i];
  }

  __device__ __forceinline__ void jac(const F* x, const F* u, F (&A)[NX][NX],
                                      F (&B)[NX][NU]) const {
    Vec<F, NX + NU> xu;
#pragma unroll
    for (int i = 0; i < NX; ++i) xu.v[i] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) xu.v[NX + i] = u[i];
#pragma unroll 1
    for (int j = 0; j < NX + NU; ++j) {
      const Vec<F, NX> col = euler_column<Sys, F>(p, xu, j);
#pragma unroll
      for (int k = 0; k < NX + NU; ++k) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          if (k < NX)
            A[i][k] = k == j ? col.v[i] : A[i][k];
          else
            B[i][k - NX] = k == j ? col.v[i] : B[i][k - NX];
        }
      }
    }
  }
};

template <typename F>
using PendulumCosSinDyn = DualStepDyn<PendulumCosSinSys, F>;
template <typename F>
using CartpoleCosSinDyn = DualStepDyn<CartpoleCosSinSys, F>;

}  // namespace dqmpc

AL_FUSED_ENTRY(al_fused_pendulum_cossin_f32, float,
               AL_FUSED_CASE(5, dqmpc::PendulumCosSinDyn, float)
                   AL_FUSED_CASE(10, dqmpc::PendulumCosSinDyn, float))
AL_FUSED_ENTRY(al_fused_pendulum_cossin_f64, double,
               AL_FUSED_CASE(5, dqmpc::PendulumCosSinDyn, double))
AL_RESIDENT_ENTRY(al_fused_pendulum_cossin_resident_threads_f32,
                  AL_RESIDENT_CASE(5, dqmpc::PendulumCosSinDyn, float)
                      AL_RESIDENT_CASE(10, dqmpc::PendulumCosSinDyn, float))
AL_RESIDENT_ENTRY(al_fused_pendulum_cossin_resident_threads_f64,
                  AL_RESIDENT_CASE(5, dqmpc::PendulumCosSinDyn, double))

AL_FUSED_ENTRY(al_fused_cartpole_cossin_f32, float,
               AL_FUSED_CASE(5, dqmpc::CartpoleCosSinDyn, float)
                   AL_FUSED_CASE(10, dqmpc::CartpoleCosSinDyn, float))
AL_FUSED_ENTRY(al_fused_cartpole_cossin_f64, double,
               AL_FUSED_CASE(5, dqmpc::CartpoleCosSinDyn, double))
AL_RESIDENT_ENTRY(al_fused_cartpole_cossin_resident_threads_f32,
                  AL_RESIDENT_CASE(5, dqmpc::CartpoleCosSinDyn, float)
                      AL_RESIDENT_CASE(10, dqmpc::CartpoleCosSinDyn, float))
AL_RESIDENT_ENTRY(al_fused_cartpole_cossin_resident_threads_f64,
                  AL_RESIDENT_CASE(5, dqmpc::CartpoleCosSinDyn, double))
