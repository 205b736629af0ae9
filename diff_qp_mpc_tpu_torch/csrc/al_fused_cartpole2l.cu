// K2 for the 2-link cartpole on the warp layout of al_fused_warp.cuh (four
// warps per element, its blocks in shared memory): float32 at T 5 and 10,
// float64 at T 5 (the functor is al_fused_cartpole2l.cuh's). W 4 was the
// fastest of W 1, 2 and 4 at B 64-256 in every (T, dtype) on the card
// (PERF.md). Built for the host by utils/k2_host.py (K2_HOST defined), the
// same functor runs al_fused_common.cuh's one-lane kernel at G 1 instead.
#include "al_fused_cartpole2l.cuh"
#ifndef K2_HOST
#include "al_fused_warp.cuh"

AL_WARP_ENTRY(al_fused_cartpole2l_f32, float,
              AL_WARP_CASE(5, dqmpc::Cartpole2LSys, float, 4)
              AL_WARP_CASE(10, dqmpc::Cartpole2LSys, float, 4))
AL_WARP_ENTRY(al_fused_cartpole2l_f64, double,
              AL_WARP_CASE(5, dqmpc::Cartpole2LSys, double, 4))
AL_WARP_SMEM_ENTRY(al_fused_cartpole2l_smem_f32,
                   AL_WARP_SMEM_CASE(5, dqmpc::Cartpole2LSys, float, 4)
                   AL_WARP_SMEM_CASE(10, dqmpc::Cartpole2LSys, float, 4))
AL_WARP_SMEM_ENTRY(al_fused_cartpole2l_smem_f64,
                   AL_WARP_SMEM_CASE(5, dqmpc::Cartpole2LSys, double, 4))
#else
AL_FUSED_ENTRY(al_fused_cartpole2l_f32, float,
               AL_HOST_CASE(5, dqmpc::Cartpole2LDyn, float)
                   AL_HOST_CASE(10, dqmpc::Cartpole2LDyn, float))
AL_FUSED_ENTRY(al_fused_cartpole2l_f64, double,
               AL_HOST_CASE(5, dqmpc::Cartpole2LDyn, double))
#endif
