// K2 for the pendulum: its functor and its instantiations, float32 at T 5
// and 10, float64 at T 5, each at G = 1 .. 32 (the kernel is
// al_fused_common.cuh's).
#include "al_fused_common.cuh"

namespace dqmpc {

// Pendulum (diff_qp_mpc_tpu/models/pendulum.py), semi-implicit Euler:
// θ̈ = (τ + m g l sin θ)/(m l²). mgl = m·g·l and ml2 = m·l² are folded on the
// host in double precision, as the reference's Python constants are.
template <typename F>
struct PendulumDyn {
  static constexpr int NX = 2;
  static constexpr int NU = 1;
  // the merit's dynamics term contracted as nvcc chooses (PR 6's bits; see
  // merit_constraints)
  static constexpr bool kRoundedMerit = false;
  F dt, mgl, ml2;

  // params = (dt, m·g·l, m·l²)
  static PendulumDyn make(const double* p) {
    return {static_cast<F>(p[0]), static_cast<F>(p[1]),
            static_cast<F>(p[2])};
  }

  __device__ __forceinline__ void step(const F* x, const F* u, F* xn) const {
    const F thddot = (u[0] + mgl * sin(x[0])) / ml2;
    const F new_thdot = x[1] + thddot * dt;
    xn[0] = x[0] + new_thdot * dt;
    xn[1] = new_thdot;
  }

  // A = ∂f/∂x, B = ∂f/∂u, in the order forward-mode differentiation of
  // step() evaluates them.
  __device__ __forceinline__ void jac(const F* x, const F* /*u*/,
                                      F (&A)[NX][NX], F (&B)[NX][NU]) const {
    const F d_thdot = mgl * cos(x[0]) / ml2 * dt;
    A[0][0] = F(1) + d_thdot * dt;
    A[0][1] = dt;
    A[1][0] = d_thdot;
    A[1][1] = F(1);
    const F b1 = F(1) / ml2 * dt;
    B[0][0] = b1 * dt;
    B[1][0] = b1;
  }
};

}  // namespace dqmpc

AL_FUSED_ENTRY(al_fused_pendulum_f32, float,
               AL_FUSED_CASE(5, dqmpc::PendulumDyn, float)
                   AL_FUSED_CASE(10, dqmpc::PendulumDyn, float))
AL_FUSED_ENTRY(al_fused_pendulum_f64, double,
               AL_FUSED_CASE(5, dqmpc::PendulumDyn, double))

AL_RESIDENT_ENTRY(al_fused_pendulum_resident_threads_f32,
                  AL_RESIDENT_CASE(5, dqmpc::PendulumDyn, float)
                      AL_RESIDENT_CASE(10, dqmpc::PendulumDyn, float))
AL_RESIDENT_ENTRY(al_fused_pendulum_resident_threads_f64,
                  AL_RESIDENT_CASE(5, dqmpc::PendulumDyn, double))
