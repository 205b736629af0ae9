// K2 for the 2-link cartpole at T 5: float32 and float64, each at G = 1 ..
// 32 (the functor is al_fused_cartpole2l.cuh's; T 10 is
// al_fused_cartpole2l_t10.cu).
#include "al_fused_cartpole2l.cuh"

AL_FUSED_ENTRY(al_fused_cartpole2l_f32, float,
               AL_FUSED_CASE(5, dqmpc::Cartpole2LDyn, float))
AL_FUSED_ENTRY(al_fused_cartpole2l_f64, double,
               AL_FUSED_CASE(5, dqmpc::Cartpole2LDyn, double))

AL_RESIDENT_ENTRY(al_fused_cartpole2l_resident_threads_f32,
                  AL_RESIDENT_CASE(5, dqmpc::Cartpole2LDyn, float))
AL_RESIDENT_ENTRY(al_fused_cartpole2l_resident_threads_f64,
                  AL_RESIDENT_CASE(5, dqmpc::Cartpole2LDyn, double))
