// K2 for the double integrator (diff_qp_mpc_tpu/models/integrator.py) with
// one position and one velocity: its functor and its instantiations,
// float32 and float64 at T 5, each at G = 1 .. 32 (the kernel is
// al_fused_common.cuh's).
#include "al_fused_common.cuh"

namespace dqmpc {

// Semi-implicit Euler: v' = v + u·dt, p' = p + v'·dt. The Jacobian is the
// one forward-mode differentiation of step() evaluates: A = [[1, dt], [0,
// 1]], B = [[dt·dt], [dt]].
template <typename F>
struct IntegratorDyn {
  static constexpr int NX = 2;
  static constexpr int NU = 1;
  static constexpr bool kRoundedMerit = true;  // see merit_constraints
  F dt;

  // params = (dt)
  static IntegratorDyn make(const double* p) { return {static_cast<F>(p[0])}; }

  __device__ __forceinline__ void step(const F* x, const F* u, F* xn) const {
    const F vel_n = x[1] + u[0] * dt;
    xn[0] = x[0] + vel_n * dt;
    xn[1] = vel_n;
  }

  __device__ __forceinline__ void jac(const F* /*x*/, const F* /*u*/,
                                      F (&A)[NX][NX], F (&B)[NX][NU]) const {
    A[0][0] = F(1);
    A[0][1] = dt;
    A[1][0] = F(0);
    A[1][1] = F(1);
    B[0][0] = dt * dt;
    B[1][0] = dt;
  }
};

}  // namespace dqmpc

AL_FUSED_ENTRY(al_fused_integrator_f32, float,
               AL_FUSED_CASE(5, dqmpc::IntegratorDyn, float))
AL_FUSED_ENTRY(al_fused_integrator_f64, double,
               AL_FUSED_CASE(5, dqmpc::IntegratorDyn, double))

AL_RESIDENT_ENTRY(al_fused_integrator_resident_threads_f32,
                  AL_RESIDENT_CASE(5, dqmpc::IntegratorDyn, float))
AL_RESIDENT_ENTRY(al_fused_integrator_resident_threads_f64,
                  AL_RESIDENT_CASE(5, dqmpc::IntegratorDyn, double))
