// K2 for the 2-link cartpole at T 10: float32, at G = 1 .. 32 (the functor
// is al_fused_cartpole2l.cuh's; T 5 is al_fused_cartpole2l_t5.cu).
#include "al_fused_cartpole2l.cuh"

AL_FUSED_ENTRY(al_fused_cartpole2l_f32, float,
               AL_FUSED_CASE(10, dqmpc::Cartpole2LDyn, float))

AL_RESIDENT_ENTRY(al_fused_cartpole2l_resident_threads_f32,
                  AL_RESIDENT_CASE(10, dqmpc::Cartpole2LDyn, float))
