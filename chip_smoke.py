#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diff_qp_mpc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. build every CUDA kernel of the main paths from
     diff_qp_mpc_tpu_torch/csrc (one nvcc per source, all in parallel) into
     build/kernels/;
  2. K1 (block-tridiagonal Cholesky, csrc/btsolve.cu) against its plain
     PyTorch version on random SPD block-tridiagonal systems, T 5, n 3,
     B 64 (the main path's shape), 256 and 4096, float32 and float64; then
     each of its layouts (on chip, streaming) against the plain version and
     timed at B 64, 256, 4096 and 262144 (a filled card, with its share of
     the bytes bound);
  3. K2 (the fused AL-MPC solve, csrc/al_fused.cu) against its plain version
     at the main path's budget (pendulum, T 5, al_iter 2, n_newton 4, n_ls
     20, rho_max 1e6, reg 1e-7), B 64 and 256, float32 and float64; then at
     every group width G (lanes per element) at B 64, 256, 4096 and 262144:
     the G the wrapper's rule picks, the time per G, and the outputs at every
     G bit-identical to G 1 (float64 too at B 64 and 256, and on a problem
     whose every line-search candidate ties);
  4. K3 (the Riccati LQR-KKT solve, csrc/riccati.cu) against its plain
     version on random SPD problems, T 5, (nx, nu) = (2, 1), B 64 (the ip
     path's shape), 256 and 4096, and (4, 1), B 4096 (the K4 profiler's
     third case), float32 and float64; then timed at a filled card (B
     262144, (2, 1), float32) with its share of the bytes bound, and the
     launch floor (the device time of one one-block PyTorch kernel) beside
     its time at B 64;
  5. K4 (the whole trajectory-QP IPM, csrc/trajqp_fused.cu) against its
     plain version on pendulum tracking QPs at the ip path's budget
     (max_iter 12, reg 1e-9, box ±3), B 64 and 256, and on the K4
     profiler's (4, 1) problem, B 256, float32 and float64;
  6. K5 (the saturated sin chain, csrc/sin_chain.cu) against its plain
     version at 64 tiles, 8 streams, 256 sins, float32;
  7. one DEQ-MPC policy forward on the card against the same forward on the
     CPU (float64), for the AL checkpoint on both AL paths and the ip
     checkpoint on both ip paths;
  8. the main paths: closed-loop evaluation through the evaluate entry point,
     64 episodes of up to 200 steps, of the AL checkpoint on the scan path
     (K1) and the fused path (K2), and of the ip checkpoint on the ip scan
     path (K3) and the ip fused path (K4), the two scan paths cut to
     MAIN_PATH_CUT_STEPS steps. The launch counts are set to 0 just before
     each run and read just after; each path must launch its kernel and no
     other, exactly 48 (K1), 6 (K2), 432 (K3) or 18 (K4) times per
     closed-loop step, and each fused path must reach a success rate of at
     least 0.95;
  9. the roofline path, counts set to 0 before it and read after: the
     roofline entry point's functions in quick mode (K2 at B 262144 at the
     reference budget, K5's saturated rate from both chain lengths), then
     the K4 profiler's three cases (K4 against the scan IPM on K3), with
     fewer timing windows than the full runs. Every share of a bound must
     lie in [0, 1.1], K5's slope must be positive and K5 must have been
     launched; after the counts are read, K5 at the roofline's shape (4096
     tiles, 8 streams, 4096 sins) and K2 at its problem (B 262144, rho_max
     1e4, reg 1e-5, float32 and float64) are held against their plain
     versions, and K4 and the scan IPM must agree on u on the profiler's
     cases (PROF_U_TOL, float32 and float64);
 10. K1 in float32 on the AL path's own Newton systems (ρ 1 … 1e6, reg 1e-7,
     B 4096; the gradient and a cotangent as right-hand sides) against the
     float64 solution: within K1_AL_RATIO of the plain float32 version's
     error at every ρ;
 11. the training gradient: one DEQ-MPC loss and gradient in float64 from
     each committed checkpoint (B 8, its path's flags) on the card against
     the CPU, relative error of the flattened gradient ≤ GRAD_TOL on all
     four paths; and float32 against float64 on the card (AL fused,
     recorded);
 12. the training path through the train entry point: the committed AL
     checkpoint's meta.json flags (fused, bsz 256, grad_clip 10, pretrain)
     cut to TRAIN_ITERS steps, TRAIN_PRETRAIN of them pretraining, writing
     its checkpoints under build/; the counts are set to 0 before each step
     and read after it: no launch in a pretraining step, exactly
     LAUNCHES_PER_TRAIN_STEP in a DEQ-MPC step; every loss and gradient norm
     finite, the pretraining loss falling, and the checkpoint it wrote
     evaluated through the evaluate entry point. Then OTHER_TRAIN_STEPS
     DEQ-MPC steps on each other path with the same checks. Per path: ms
     per training step, the device's busy share over a profiled window of
     the run's last steps, and the implicit-gradient guard's drops in each
     step.
 13. K1 at the shapes the new models' paths give it, (n, T) = (5, 5),
     (5, 10), (7, 5), (7, 10) and (16, 5), B 8 (the float64 gradient
     check's), 64 (a closed loop's) and 256 (training's), float32 and
     float64, each layout against its plain version within K1_TOL and
     timed; and K1 in float32 on cp1's own AL Newton systems (T 10, B 256,
     ρ 1 … 1e6) and the quadrotor's (T 5, B 128, ρ 1 … 1e4) against
     float64, within K1_AL_RATIO of the plain float32 version's error, as
     phase 10 holds the pendulum's;
 14. K2 on the integrator, the cartpoles and the quadrotor
     (benchmarks/k2_models.py): every (model, T, dtype) it is built for
     against its plain version on seeded tracking problems of the model's
     env, B 64 and 256 (the quadrotor's hover problems at its checkpoint's
     budget: B 64, 128 and 65, the edge of its two-element blocks);
     float32: each element within 1e-2 but for at most SHARE_LIMIT of
     them (the quadrotor: of the plain version's float64 result, but for
     at most F32_SHARE_VS_F64); float64: every element within 3e-6, those
     beyond 1e-6 printed beside the plain version's own change on them
     under one ulp of the inputs; every group width bit-identical to G 1
     (the quadrotor's kernel has one: a warp per element, its blocks in
     shared memory), timed in float32 at B 64 (the quadrotor's also at
     128) with its bound;
 15. one policy forward in float64 on the card against the CPU on the new
     models' paths: cp1 on the scan path (its checkpoint, T 10) and the
     fused path (T 5, seeded weights: K2 has no float64 T 10 instantiation),
     the integrator's checkpoint on the scan path, cp2 v7 on the fused path,
     the quadrotor's checkpoint on both paths;
     row by row within POLICY_ULP_FACTOR times the CPU's own largest change
     under one ulp of the state, measured in the run (the factor from
     policy_spread over seeds), but the rows that change is larger than
     POLICY_JUMP on (printed, at most half);
 16. the new models' closed loops through the evaluate entry point, float32,
     up to 200 steps, counts set to 0 before each run and read after: the
     cp1 checkpoint on the fused path (K2, 24 launches a step) and the
     integrator's on the scan path (K1, 48), each at a success rate of at
     least 0.95, 64 episodes; cp2 v7 and v8 on the fused path (K2, 18 and
     24), 64 episodes, printed beside the JAX package's 0.094 and 0.125 and
     not gated; cp1 on the scan path (K1, 96) for 3 steps; the quadrotor
     checkpoint on the fused path (K2, 12 a step: deq_iter 6 × qp_iter 2,
     warm starts carried) over the env's 100 steps, 64 episodes, at a
     success rate of at least QUAD_MIN_SUCCESS, printed beside the JAX
     package's eval_fused.json, and on the scan path (K1, 48) for 2 steps;
 17. the float64 training gradient card vs CPU (B 8) on cp1 fused (T 5,
     seeded weights), the integrator's scan path and the quadrotor's fused
     path (its checkpoint; QUAD_GRAD_TOL), and training through the train
     entry point with the cp1 checkpoint's meta.json flags (fused, T 10,
     B 256, qp_iter 4, both expert pickles) cut to CP1_TRAIN_PRETRAIN +
     CP1_TRAIN_DEQMPC steps, exactly 24 K2 and 6 K1 launches a DEQ-MPC
     step, and with the quadrotor checkpoint's (fused, T 5, B 128, qp_iter
     2, rho_max 1e4) cut to QUAD_TRAIN_PRETRAIN + QUAD_TRAIN_DEQMPC steps,
     exactly 12 K2 and 6 K1 launches a DEQ-MPC step.
 18. the terminal-LQR ip path and the MPC expert, in this order:
     (a) K3 at (T, nx, nu) = (5, 6, 1) (csrc/riccati.cu) and its horizon
     kernel (csrc/riccati_horizon.cu) at every expert planner's shape
     (K3_HORIZON_SHAPES), B 64, 256 and the dataset's batch (200; the
     quadrotor's 300), float32 and float64, against the plain version:
     float64 within K3_TOL; float32 at T 5 within K3_TOL, over the longer
     horizons against the float64 solution within F32_VS_F64_RATIO of the
     plain float32 version's error; timed at B 64 with the dense KKT's
     torch.linalg.solve beside it, the horizon kernel also at (5, 6, 1).
     K3 at (5, 6, 1) on the cp2 ip checkpoint's own scan-IPM systems and
     the horizon kernel at (10, 6, 1) on the cp2 stabilize expert's, and
     K4 at (5, 6, 1) on the checkpoint's own QPs (terminal P included),
     float32 against float64 by the same ratio rule;
     (b) K4 at (5, 6, 1) on the K4 profiler's random QPs, B 64 and 256,
     both dtypes, all eight outputs within K4_TOL, timed at B 64;
     (c) the float64 policy forward card vs CPU on the cp2 ip checkpoint's
     scan and fused paths (as phase 15), and its closed loops through the
     evaluate entry point (CP2_IP_RUNS), launches per step exact;
     (d) its float64 training gradient card vs CPU (B 8, fused) and
     training with its meta.json's flags (ip, fused, terminal_lqr) cut to
     CP2_IP_TRAIN_PRETRAIN + CP2_IP_TRAIN_DEQMPC steps, exactly 18 K4 and
     6 K3 launches a DEQ-MPC step;
     (e) the MPC expert (learning/datagen.py, float64) on EXPERT_RUNS: the
     cp2 stabilize planner (T 10, terminal LQR) on 64 trajectories × 20
     steps and the quadrotor's (T 20) on 16 × 5, exactly (qp_iter + 1) ×
     12 × 2 horizon-kernel launches an MPC step, ms a step, the success
     share, its first actions card vs CPU within EXPERT_TOL;
     (f) DAgger through its entry point from the cp1 checkpoint: 8
     episodes × 20 steps, 8 states relabeled × 10 steps by the cp1
     stabilize planner (T 60: 264 horizon-kernel launches an MPC step).
 19. the OptNet QP layer, SL1QP and the slew-rate option, in this order
     (the launch counts set to 0 before each and read after):
     (a) the QP layer (solvers/qp.py) at nz = nineq = 100, B 128, both
     solvers, neq 0 and 50: float64 card vs CPU on the first QP_CPU_ROWS
     elements (z and the residual total within QP_TOL, all six gradients
     within QP_GRAD_TOL), float32 against the float64 solution within
     F32_VS_F64_RATIO of the CPU float32 solve's error, no kernel launched;
     ms per solve and per forward plus backward at B 1, 64, 128 in float64
     (benchmarks/prof_qp_sizes.py);
     (b) the sudoku OptNet example through its entry point, 200 iterations
     in float32: the loss halves, no kernel launched;
     (c) SL1QP MPC (riccati backend, SL1QPConfig's defaults) on cp2
     stabilize (T 10, terminal LQR P, B 64) and the quadrotor hover (T 20,
     B 16) with their expert planner's weights and box: float64 value and
     gradient w.r.t. c and x0 card vs CPU within SL1QP_TOL, slack_l1, s
     per solve; the dense backend against the riccati backend on cp2 at T
     5, B 64 (SL1QP_DENSE_CFG); no kernel launched;
     (d) the slew-rate option (sqp_mpc.solve, s 50, with and without
     prev_ctrl) on pendulum tracking problems, B 64, scan and fused, both
     dtypes: exactly 72 K3 (scan) or 3 K4 (fused) launches a solve at
     (5, 3, 1) and one K3 in its backward, no other kernel; float64 u card
     vs CPU within SLEW_TOL; the slew energy below SLEW_ENERGY_RATIO × the
     unpenalized solve's; K3 and K4 at (5, 3, 1) against their plain
     versions on the solves' own systems and on random problems, timed.
 20. the RL experts (learning/rl.py), in this order: (a) both committed
     CGAC actors rolled out over RL_ROLLOUTS trajectories up to their env's
     step limit, gated on RL_ACTORS' least upright share, their float64
     actions over RL_CHECK_STEPS steps card vs CPU within RL_TOL, the
     pendulum's pickle written under RL_DIR; (b) SAC at SACConfig's
     defaults (the warmup, then RL_SAC_BLOCKS blocks of 100 iterations × 8
     updates) and CGAC at CGACConfig's (the warmup, one block), ms per
     block and per update, SAC's buffer and statistics after the warmup
     exact, one float64 update card vs CPU each; (c) PPO at PPOConfig's
     defaults for RL_PPO_ITERS iterations and one float64 update card vs
     CPU; (d) `datagen --expert sac`, cut, writing a pickle that
     learning.data reads, no kernel launched; (e) DEQ-MPC training on (a)'s
     pickle with the main path's meta flags, cut to RL_TRAIN_PRETRAIN +
     RL_TRAIN_DEQMPC steps, exactly 6 K2 and 6 K1 launches a DEQ-MPC step.
 21. the rest of the DEQ network family at the main path's full width (its
     meta flags: pendulum, fused, T 5, deq_iter 6, hdim 128, B 256), in
     this order: (a) DEQ-MPC with the conv cell (--layer_type conv)
     through the train entry point, cut to DEQ_TRAIN_PRETRAIN +
     DEQ_TRAIN_DEQMPC steps, exactly 6 K2 and 6 K1 launches a DEQ-MPC step
     and none a pretraining step; its checkpoint closed-loop through the
     evaluate entry point, 64 episodes × DEQ_LOOP_STEPS steps, exactly 6
     K2 a step, success printed and not gated; its float64 forward (as
     phase 15) and training gradient (within GRAD_TOL, B 8) card vs CPU;
     (b) NNMPCPolicy on the fused tracker, B 256: exactly 1 K2 a forward
     and 1 K1 in its backward, ms per call, float64 actions and gradient
     card vs CPU within GRAD_TOL (B 8); (c) DEQPolicy, hdim 128, B 256: no
     kernel, ms per call, Anderson's residual history, float64 forward and
     gradient card vs CPU within DEQ_NET_TOL; (d) the BC baseline (no
     --deq: NNPolicy, policy_out_type 2) through the train entry point for
     DEQ_BC_STEPS steps and its checkpoint closed-loop for DEQ_LOOP_STEPS
     steps, no kernel launched, the float64 BC loss and gradient card vs
     CPU within DEQ_NET_TOL. Their K1/K2 launches go to the kernels line
     under launches_deq_family.
Every phase prints its seconds ("phase <name>: <s> s") and the run ends
with their table.
Bounds: the larger of the bytes over the HBM rate and the operations over
the float32 peak (diff_qp_mpc_tpu_torch/benchmarks/flops.py); each sin or
cos counts as the 15 FP32 instructions of its fast path (SINF_FP32_INSTR).
It prints one JSON line per kernel summary (the quadrotor's K2, and K3 and
K4 at the slew-augmented pendulum's (5, 3, 1), on rows of their own beside
the others), the card's name and power limit, and as its
last line {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks import kernel_layouts
from diff_qp_mpc_tpu_torch.benchmarks.flops import (
    SINF_FP32_INSTR,
    bound,
    k1_bytes,
    k1_ops,
    k2_bytes,
    k2_ops,
    k2_ops_with_sin,
    k3_bytes,
    k3_ops,
    k4_bytes,
    k4_ops,
    k5_bytes,
    k5_ops,
)
from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import (
    F32_VS_F64_RATIO,
    K1_TOL,
    k2_inputs,
    random_bt_spd,
)
from diff_qp_mpc_tpu_torch.benchmarks.timing import (
    device_kernel_ms,
    events_ms,
    queued_events_ms,
)

CKPT = "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack"
# the ip (interior-point SQP) tracking checkpoint, out_type 1
IP_CKPT = "logs/deqmpc_pendulum_ip_fused_v2/ckpt.msgpack"
EPISODES, MAX_STEPS = 64, 200
MIN_SUCCESS = 0.95
# the pendulum's scan closed loops are host-bound (AL scan ~0.2 s a step,
# 48 K1 launches; ip scan ~0.7-1.1 s a step, 432 K3 launches: the Newton
# and IPM elementwise work around each launch), so they run
# MAIN_PATH_CUT_STEPS steps, their exact launch counts checked, and no
# success gate: the fused path of each checkpoint computes the same
# solves and keeps the gate over MAX_STEPS
MAIN_PATH_CUT_STEPS = {"scan": 20, "ip-scan": 10}
T, NX, NU = 5, 2, 1
N = NX + NU
# K2's budget on the main path (ALConfig defaults, qp_iter 2)
AL_BUDGET = dict(al_iter=2, n_newton=4, n_ls=20, rho_factor=10.0,
                 rho_max=1e6, reg=1e-7)
# tolerances: K1 relative to max|x|; K2 absolute, (xu, res). K2's line
# search takes the first minimum over 20 power-of-two steps; near
# convergence candidate merits tie to within rounding, so two correct
# implementations that round differently (FMA contraction, sum order) can
# take different steps. In float64 the JAX Pallas kernel (interpret mode)
# and the plain version differ by 6.1e-8 on xu on these inputs (B 64), so
# float64 is held to 1e-6. In float32 the Newton systems also amplify the
# rounding (cond ~1e4 at R 0.01): float32 alone moves the plain version up
# to 5.2e-3 on xu and 2.1e-4 on res from its float64 result (B 256), so
# float32 is held to twice that. K1_TOL comes with the K1 layout checks.
# float64 policy forward, card vs CPU: six K1- or K2-backed solves, each with
# the line-search near-ties above
POLICY_TOL = 1e-6
K2_TOL = {torch.float32: (1e-2, 1e-3), torch.float64: (1e-6, 1e-6)}
# K4's budget on the ip path (TrajQPConfig defaults) and the pendulum's box
IP_BUDGET = dict(max_iter=12, reg=1e-9, min_slack=1e-8)
IP_BOX = ((-3.0,), (3.0,))
# tolerances: K3 relative to the largest entry, as K1 (a direct solve). K4
# on all eight outputs, each error over max(1, the field's largest entry):
# x, u and the residual are O(1), so on them this is the absolute error. The
# IPM is continuous in its inputs, so float64 agrees to rounding; float32
# rounding alone moves the plain version from its float64 result by ~1e-4
# on x and u of these pendulum QPs (recorded per run and per field as
# plain_f32_vs_f64), so float32 is held to ten times that, 1e-3
K3_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
K4_TOL = {torch.float32: 1e-3, torch.float64: 1e-8}
K4_FIELDS = ("x", "u", "lam", "z_hi", "z_lo", "s_hi", "s_lo", "resids")
# kernel launches per closed-loop step, deq_iter 6 tracking solves × on the
# AL scan path al_iter 2 × n_newton 4 K1 solves, on the AL fused path one
# K2 launch (its al_iter inside), on the ip paths (qp_iter 2 SQP QPs + the
# final QP) × (max_iter 12 IPM iterations × 2 Riccati solves on the scan
# path, one K4 launch on the fused path)
LAUNCHES_PER_STEP = {"scan": ("K1", 6 * 2 * 4), "fused": ("K2", 6),
                     "ip-scan": ("K3", 6 * 3 * 12 * 2),
                     "ip-fused": ("K4", 6 * 3)}
# K3 on a filled card: 262144 elements, (nx, nu) = (2, 1), float32
K3_FILLED_B = 262144

# K5 at 64 tiles, 8 streams, 256 sins: each output is a sum of 8 chains in
# (0, 1). sin is contractive on (0, 1], so a one- or two-ulp difference per
# step between the kernel's sinf and PyTorch's sin does not grow along the
# chain; 1e-5 absolute on sums of magnitude ≤ 8 is ~20 float32 ulps of 8
K5_SHAPE = dict(n_tiles=64, n_streams=8, n_ops=256)
K5_TOL = 1e-5
# K2 on the roofline's problem (B 262144, rho_max 1e4, reg 1e-5): at this
# budget the solve is discontinuous in its inputs for a few elements (the
# line search's first minimum and the ±3 bound switch), so a per-element
# tolerance cannot hold for all 262144. Measured with the plain version on
# the CPU, B 65536: float32 alone moves 0.22% of the elements by more than
# 1e-2 on xu (54 by more than 1; median 2.0e-5 on xu, 4.7e-8 on res), one
# float32 ulp in x0 moves 0.07%; in float64 a relative change of 1e-7 in
# x0 moves 0.008% by more than 1e-6. So each element is held to K2_TOL's
# xu tolerance, and the share of elements outside it to ROOF_K2_SHARE
# (about five and thirteen times those shares); the median element error
# on xu and the median |Δres| to ROOF_K2_MEDIAN
ROOF_K2_SHARE = {torch.float32: 1e-2, torch.float64: 1e-3}
ROOF_K2_MEDIAN = {torch.float32: 1e-3, torch.float64: 1e-8}
# K4 against the scan IPM (on K3) on the K4 profiler's cases, max |Δu|.
# float64: the two run one IPM and differ only in corner semantics these
# QPs do not reach (≤ 5.8e-10 on u, plain versions on the CPU, B 4096),
# held to 1e-8. float32: the last stage's u sits at the ±1.5 box, where 12
# IPM iterations stall in float32; float32 alone moves each path up to
# 2.5e-3 from its float64 solution on these QPs (plain versions on the CPU,
# B 16384), so the two are held to twice that. (The JAX profiler saw
# ≤ 1.4e-3 on its own chip; each run records the float32 paths' errors.)
PROF_U_TOL = {torch.float32: 5e-3, torch.float64: 1e-8}
# timing windows of the roofline phase (the full runs take 10 × 5)
ROOF_REP, ROOF_OUTER = 3, 3

# the training path: the committed AL checkpoint's run (8000 iterations,
# 1000 of them pretraining) cut to TRAIN_ITERS, TRAIN_PRETRAIN of them
# pretraining, a log line and a checkpoint every TRAIN_CKPT_EVERY
TRAIN_META = CKPT + ".meta.json"
TRAIN_ITERS, TRAIN_PRETRAIN, TRAIN_CKPT_EVERY = 60, 30, 10
OTHER_TRAIN_STEPS = 3
# steps traced by torch.profiler at the end of each path's run; the median
# ms per step leaves them out, and the first DEQ-MPC step
TRACED_TRAIN_STEPS = {"fused": 3, "scan": 1, "ip-scan": 1, "ip-fused": 1}
TRAIN_LOGDIR = os.path.join("build", "chip_smoke_train")
# the solver flags of each path (the meta's own run is "fused")
TRAIN_FLAGS = {"fused": ["--fused"], "scan": [],
               "ip-scan": ["--solver_type", "ip"],
               "ip-fused": ["--solver_type", "ip", "--fused"]}
# kernel launches per DEQ-MPC training step: the forward's, as in
# LAUNCHES_PER_STEP (the scan path carries its warm starts: solver_carry
# auto), plus one implicit-backward solve per tracking solve (deq_iter 6):
# K1 on the AL paths, K3 (the final QP's layer) on the ip paths. A
# pretraining step launches none
LAUNCHES_PER_TRAIN_STEP = {"fused": {"K2": 6, "K1": 6},
                           "scan": {"K1": 6 * 2 * 4 + 6},
                           "ip-scan": {"K3": 6 * 3 * 12 * 2 + 6},
                           "ip-fused": {"K4": 6 * 3, "K3": 6}}
# float64 training gradient, card vs CPU, B GRAD_B: the relative error of
# the flattened gradient, as POLICY_TOL holds the forward (line-search
# near-ties at ~1e-7 in float64)
GRAD_TOL, GRAD_B = 1e-6, 8
DATA = "data/expert_traj_sac-Pendulum-v0_new.pkl"

# the models beyond the pendulum: their committed checkpoints
CP1_CKPT = "logs/deqmpc_cp1_fused_v10_T10/ckpt_best.msgpack"
INT_CKPT = "logs/deqmpc_integrator_mpc_T5_bsz256/ckpt.msgpack"
CP2_V7_CKPT = "logs/deqmpc_cp2_fused_v7_corrected/ckpt_best.msgpack"
CP2_V8_CKPT = "logs/deqmpc_cp2_fused_v8_T10/ckpt_best.msgpack"
# the quadrotor's checkpoint (RexQuadrotor, T 5, deq_iter 6, hdim 128,
# qp_iter 2, rho_max 1e4, al_reg null: 1e-7, solver_carry on, fused)
QUAD_CKPT = "logs/deqmpc_quadrotor_fused_v8/ckpt_best.msgpack"
QUAD_META = QUAD_CKPT + ".meta.json"
# its closed loop's gate: the JAX package's 0.953 over 64 episodes
# (eval_fused.json) less two binomial standard deviations at 64 episodes
# (2·sqrt(0.953·0.047/64) = 0.053)
QUAD_MIN_SUCCESS = 0.89
QUAD_MAX_STEPS = 100  # QuadrotorEnv.max_steps
# their closed loops: (name, checkpoint, flags, max steps, kernel, launches
# per step, the JAX package's success rate over 64 episodes (its eval
# JSONs), the least success rate that passes, or None where the run is not
# gated). Launches per step: deq_iter 6 tracking solves × on the fused path
# (warm starts carried: solver_carry on) one K2 launch per AL iteration
# (qp_iter), on the scan path qp_iter × n_newton 4 K1 solves
MODEL_RUNS = (
    ("cp1-fused", CP1_CKPT, ["--fused"], MAX_STEPS, "K2", 6 * 4, 1.0,
     MIN_SUCCESS),
    ("integrator-scan", INT_CKPT, [], MAX_STEPS, "K1", 6 * 2 * 4, 1.0,
     MIN_SUCCESS),
    ("cp2-v7-fused", CP2_V7_CKPT, ["--fused"], MAX_STEPS, "K2", 6 * 3,
     0.09375, None),
    ("cp2-v8-fused", CP2_V8_CKPT, ["--fused"], MAX_STEPS, "K2", 6 * 4, 0.125,
     None),
    ("cp1-scan", CP1_CKPT, [], 3, "K1", 6 * 4 * 4, None, None),
    ("quad-fused", QUAD_CKPT, ["--fused"], QUAD_MAX_STEPS, "K2", 6 * 2,
     0.953125, QUAD_MIN_SUCCESS),
    ("quad-scan", QUAD_CKPT, [], 2, "K1", 6 * 2 * 4, None, None))
# the new paths' float64 policy forward, card vs CPU, per initial state
# (row): each of its 6 × qp_iter tracking solves meets the line search's
# near-ties, and the DEQ iterates carry them on, so one ulp of the state
# moves the CPU's own result by far more than rounding (up to 5e-6 on cp1
# fused), by an amount that differs from one machine's CPU to another's,
# and on the scan paths the forward is discontinuous in the state (a row
# moves by up to 207 on cp1). So the run measures its own witness: the
# largest change of the CPU's result under the four one-ulp nudges of
# ``_ulp_nudges``. A row they move by more than POLICY_JUMP is not compared
# (it is printed; at most half the rows); the other rows are held to
# POLICY_ULP_FACTOR times the witness over them, or POLICY_TOL if larger.
# The factor: over POLICY_SPREAD_SEEDS seeds of 8 states, four other
# one-ulp perturbations (``_other_nudges``) move a path's held rows by up
# to 7.0 times the witness (the integrator, one seed of 16; at most 2.1,
# 1.8 and 2.5 on cp1 scan, cp1 fused and cp2: ``policy_spread``, on the
# CPU; PERF.md PR 7); the card's rounding is held to twice the largest
POLICY_JUMP = 1e-3
POLICY_ULP_FACTOR = 14.0
# the paths of the new models' policy check, and the cp2 ip checkpoint's
# (held alike in phase (c) of the terminal-LQR slice)
MODEL_POLICY_PATHS = ("cp1-scan", "cp1-fused-T5", "integrator-scan",
                      "cp2-v7-fused", "quad-scan", "quad-fused")
CP2_IP_POLICY_PATHS = ("cp2-ip-scan", "cp2-ip-fused")
POLICY_SPREAD_SEEDS = 16
# the K2 instantiation each fused run launches
MODEL_RUN_KERNEL = {"cp1-fused": "cartpole1l T10 float32",
                    "cp2-v7-fused": "cartpole2l T5 float32",
                    "cp2-v8-fused": "cartpole2l T10 float32",
                    "quad-fused": "quadrotor T5 float32"}
# training with the cp1 checkpoint's flags, cut to this many pretraining and
# DEQ-MPC steps; per DEQ-MPC step 24 K2 launches (as the closed loop) and
# one K1 backward solve per tracking solve
CP1_TRAIN_PRETRAIN, CP1_TRAIN_DEQMPC = 20, 20
CP1_META = CP1_CKPT + ".meta.json"
LAUNCHES_PER_TRAIN_STEP["cp1-fused"] = {"K2": 6 * 4, "K1": 6}
# training with the quadrotor checkpoint's flags (bsz 128), cut likewise;
# per DEQ-MPC step 12 K2 launches (as its closed loop) and one K1 backward
# solve per tracking solve
QUAD_TRAIN_PRETRAIN, QUAD_TRAIN_DEQMPC = 20, 20
LAUNCHES_PER_TRAIN_STEP["quad-fused"] = {"K2": 6 * 2, "K1": 6}
TRACED_TRAIN_STEPS["quad-fused"] = 2
# the quadrotor's float64 training gradient, card vs CPU (B GRAD_B): its
# problems at rho_max 1e4 are well conditioned (one ulp of an input moves
# the plain K2 version by at most 2.2e-9 in float64, k2_models --plain)
QUAD_GRAD_TOL = 1e-8
# the new paths' float64 training gradient checks, card vs CPU
GRAD_TOLS = {"cp1-fused-T5": GRAD_TOL, "integrator-scan": GRAD_TOL,
             "quad-fused": QUAD_GRAD_TOL, "cp2-ip-fused": GRAD_TOL}
# K1 at the new models' (n, T): cp1 (n 5) at T 5 (the float64 gradient
# check, B 8) and T 10 (its scan closed loop, B 64, and the backward of its
# fused training, B 256), cp2 (n 7) at T 5 and 10 (card tests only)
K1_MODEL_SHAPES = ((5, 5), (5, 10), (7, 5), (7, 10), (16, 5))
K1_MODEL_BATCHES = (GRAD_B, EPISODES, 256)
# the runs that launch K1 at each shape, (n, T): [(run, kind)]
K1_SHAPE_RUNS = {(5, 10): [("cp1-scan", "closed loop"),
                           ("cp1-fused", "training")],
                 (16, 5): [("quad-scan", "closed loop"),
                           ("quad-fused", "training")]}
TRACED_TRAIN_STEPS["cp1-fused"] = 2

# the terminal-LQR ip path: the cp2 ip checkpoint (Cartpole2L stabilize, ip,
# T 5, qp_iter 2, tracking_r 0.01, terminal_lqr, trained fused)
CP2_IP_CKPT = "logs/deqmpc_cp2_ip_term_v1/ckpt_best.msgpack"
CP2_IP_META = CP2_IP_CKPT + ".meta.json"
# its closed loops: (name, flags, max steps, kernel, launches per step),
# as LAUNCHES_PER_STEP's ip paths; not gated (the JAX package reads 0.016
# fused and 0.094 scan over its own 64 episodes of up to 200 steps:
# eval_fused.json, eval.json, written before its Cartpole2L.state_clip
# wrapped θ₂ to [−π, π), which the port copies: RESULTS.md's
# "pre-seam-fix"; tests/test_torch_cp2_ip_closed_loop.py rolls both
# packages as they are from the JAX evaluator's initial states). Both are
# host-bound (the cp2 model's dual Jacobians and rollouts: ~0.8 s a fused
# step), so the fused path runs 64 episodes cut to 15 steps (every episode
# that succeeds on the port's draw does so within its first 10 steps) and
# the scan path to 10
CP2_IP_RUNS = (("cp2-ip-fused", ["--fused"], 15, "K4", 6 * 3),
               ("cp2-ip-scan", [], 10, "K3", 6 * 3 * 12 * 2))
# its training, cut as cp1's: per DEQ-MPC step 18 K4 and one K3 backward
# solve per tracking solve
CP2_IP_TRAIN_PRETRAIN, CP2_IP_TRAIN_DEQMPC = 20, 20
LAUNCHES_PER_TRAIN_STEP["cp2-ip-fused"] = {"K4": 6 * 3, "K3": 6}
TRACED_TRAIN_STEPS["cp2-ip-fused"] = 2
# the MPC expert planners' (T, nx, nu) (learning/datagen.py EXPERT_PLANNER):
# cp2 stabilize (terminal LQR), the pendulum's two, the integrator's CLI
# default T, cp1 stabilize and swing-up, cp2 swing-up, the quadrotor
K3_HORIZON_SHAPES = ((10, 6, 1), (20, 2, 1), (40, 2, 1), (30, 2, 1),
                     (60, 4, 1), (80, 4, 1), (120, 6, 1), (20, 12, 4))
# the datasets' batch by (nx, nu): 200 trajectories, the quadrotor's 300
K3_DATASET_B = {(12, 4): 300}
# the device ms of the terminal-LQR kernel rows (K3 at (5, 6, 1), the
# horizon kernel, K4 at (5, 6, 1)) come from CUDA events queued
# behind a spin kernel (timing.queued_events_ms), not from torch.profiler:
# on one card machine the profiler saw no time of the horizon kernel in
# three windows running, where on another it saw every launch

# the expert runs: (name, env, env flags, trajectories, MPC steps)
EXPERT_RUNS = (("cp2-stabilize", "cartpole2link", {"stabilization": True},
                EPISODES, 20),
               ("quadrotor", "rexquadrotor", {}, 16, 5))
# the expert's first actions card vs CPU, float64, on EXPERT_CPU_ROWS rows:
# each plan's SQP meets near-ties (its best-iterate comparison and rollout
# line search pick between candidates whose costs agree to rounding); the
# port and the JAX package, both on the CPU, differ by up to 6.3e-7 of the
# plan's largest force on cp2's stabilize plans
# (tests/test_torch_datagen.py), and the card rounds differently again
EXPERT_CPU_ROWS, EXPERT_TOL = 4, 1e-5
# DAgger from the cp1 checkpoint: episodes × steps of the policy (fused,
# warm starts carried: 24 K2 a step), relabeled states × expert steps with
# the cp1 stabilize planner (T 60, qp_iter 10: 11 QPs × 12 × 2 K3h a step)
DAGGER_EPISODES, DAGGER_STEPS = 8, 20
DAGGER_RELABEL, DAGGER_RELABEL_STEPS = 8, 10
DAGGER_K2_PER_STEP, DAGGER_K3H_PER_STEP = 6 * 4, 11 * 12 * 2

# the OptNet QP layer at the reference's profiling size (qpth's
# prof-gurobi.py: nz = nineq = 100, neq 0), B 128, both solvers, and one
# draw with QP_NEQ_DRAW equality rows through a feasible point. Each
# element's IPM is independent of the others', so the CPU solves the first
# QP_CPU_ROWS elements of the card's batch. float64 card vs CPU: z within
# QP_TOL of its largest entry (the same factorizations in another
# library's order over 20 iterations) and the residual total within QP_TOL
# of max(1, its largest entry) (at convergence it is ~1e-12, rounding noise
# that differs by half of itself between the card and the CPU), the six
# gradients within QP_GRAD_TOL; float32 against the float64 solution
# within F32_VS_F64_RATIO of the CPU float32 solve's error (Q = LLᵀ +
# 1e-3·I with L uniform is ill conditioned: float32 alone moves z by up to
# 4e-2 of its largest entry on one element of 16 with neq 50, the prefactor
# solver, on the CPU)
QP_NZ, QP_NINEQ, QP_B, QP_NEQ_DRAW = 100, 100, 128, 50
QP_CPU_ROWS, QP_TOL, QP_GRAD_TOL = 16, 1e-8, 1e-6
# SL1QP (SL1QPConfig's defaults: qp_iter 10, μ 10, QP max_iter 20, the
# riccati backend) on the two widest models the port runs, with their
# expert planner's stage weights, box and (cp2) terminal LQR P as a
# QuadCost: (name, env, env flags, B). The CPU solves the first
# SL1QP_CPU_ROWS elements (independent of the others); float64 value and
# gradient within SL1QP_TOL (the SQP tolerance, ROADMAP Queue 3 item 3)
SL1QP_RUNS = (("cp2-stabilize", "cartpole2link", {"stabilization": True},
               EPISODES),
              ("quadrotor", "rexquadrotor", {}, 16))
SL1QP_CPU_ROWS, SL1QP_TOL = 4, 1e-6
# the dense backend against the riccati backend on the card, cp2 at T 5,
# B 64, as tests/test_sl1qp.py:93 (qp_iter 4, μ 100, rtol 1e-2, atol 1e-3)
# on a problem whose slacks vanish, as that test's: the planner's stage
# weights without the terminal P. With P (entries to 2.5e5) the dynamics
# rows' duals exceed μ, the ℓ1 penalty is inexact and the slacks stay
# active (Σ ≈ 0.1 in both backends); the dense expansion's problem then
# differs from the structured one (its 1e-6 quadratic on the slacks, its
# box slacks) and so does its minimizer: u 0.19 apart of 4.05 in float64
# on the CPU, whatever the IPM's iteration count. That case is printed,
# not gated
SL1QP_DENSE_T, SL1QP_DENSE_CFG = 5, dict(qp_iter=4, mu=100.0)
# the slew-rate option: pendulum tracking problems (k4_inputs' draw) at the
# ip checkpoint's budget, B 64, s 50, with and without prev_ctrl; the
# augmented problem runs K3 (scan) or K4 (fused) at (5, 3, 1). Launches per
# solve: (qp_iter + 1) QPs × max_iter × 2 K3 on scan, qp_iter + 1 K4 on
# fused; the backward one K3. float64 u card vs CPU within SLEW_TOL (the
# SQP tolerance); the slew energy below SLEW_ENERGY_RATIO × the unpenalized
# solve's (tests/test_sqp_mpc.py:90)
SLEW_PENALTY, SLEW_QP_ITER = 50.0, 2
SLEW_LAUNCHES = {"scan": ("K3", (SLEW_QP_ITER + 1) * IP_BUDGET["max_iter"]
                          * 2),
                 "fused": ("K4", SLEW_QP_ITER + 1)}
SLEW_TOL, SLEW_ENERGY_RATIO = 1e-6, 0.2
SLEW_SHAPE = (T, NX + NU, NU)  # (5, 3, 1)
# the RL experts (learning/rl.py). The committed CGAC actors rolled out
# over RL_ROLLOUTS trajectories up to their env's step limit, from the
# port's seeded initial states, float32, each gated on a least share of
# final states near upright: the pendulum on tests/test_expert_data.py's
# criterion for the committed pickle (|θ| < 0.1 on more than 0.95); the
# 1-link cartpole's committed checkpoint is not the actor that wrote its
# committed pickle (the JAX package's own rollout of it from the pickle's
# initial states, PRNGKey(0), reads 0.400 against the pickle's 1.000), so
# it is gated on that reading less two binomial standard deviations at
# 300 trajectories (0.343), the pickle's 0.9 printed beside it
RL_ROLLOUTS = 300
RL_ACTORS = (("pendulum", "data/expert_traj_cgac-Pendulum-v0_new.pkl"
              ".cgac_ckpt.msgpack", 0.1, 0.95),
             ("cartpole1link", "data/expert_traj_cgac-Cartpole1l-v0_new.pkl"
              ".cgac_ckpt.msgpack", 0.15, 0.343))
RL_PICKLE_CRITERION = {"pendulum": 0.95, "cartpole1link": 0.9}
# float64 card vs CPU: the actors' actions over the first RL_CHECK_STEPS
# closed-loop steps, and one SAC / CGAC update and one PPO update (its 32
# minibatch steps) from the same state and draws, every tensor within
# RL_TOL of its largest entry (the CPU tests hold the same updates to the
# JAX package's within 1e-9 and read ≤ 4e-11; the card's matrix products
# sum in another order)
RL_CHECK_STEPS, RL_TOL = 20, 1e-9
# SAC at SACConfig's defaults: the warmup (62 env steps of 16 envs), then
# RL_SAC_BLOCKS blocks of 100 iterations × 8 updates; CGAC at CGACConfig's:
# the warmup (4 env steps of 256 envs), then one block (400 updates); PPO
# at PPOConfig's for RL_PPO_ITERS iterations
RL_SAC_BLOCKS, RL_PPO_ITERS = 2, 2
# `datagen --expert sac`, cut: one block of SAC training, 16 trajectories
RL_DATAGEN_ARGV = ["--env", "pendulum", "--expert", "sac", "--sac_iters",
                   "100", "--num_traj", "16"]
# DEQ-MPC training on the CGAC pickle this phase writes, with the main
# path's meta flags (fused, T 5, deq_iter 6, bsz 256), cut to
# RL_TRAIN_PRETRAIN pretraining and RL_TRAIN_DEQMPC DEQ-MPC steps
RL_TRAIN_PRETRAIN, RL_TRAIN_DEQMPC = 10, 3
LAUNCHES_PER_TRAIN_STEP["rl-cgac"] = LAUNCHES_PER_TRAIN_STEP["fused"]
TRACED_TRAIN_STEPS["rl-cgac"] = 1
RL_DIR = os.path.join("build", "chip_smoke_rl")
# the rest of the DEQ network family (phase 21): the conv DEQ-MPC training
# cut to DEQ_TRAIN_PRETRAIN + DEQ_TRAIN_DEQMPC steps and the BC baseline's
# to DEQ_BC_STEPS, their closed loops to DEQ_LOOP_STEPS steps,
# NNMPCPolicy's and DEQPolicy's DEQ_CALLS calls at B DEQ_B; DEQ_NET_TOL
# holds the float64 checks with no solve inside (DEQPolicy's Anderson
# iteration aside) card vs CPU
DEQ_TRAIN_PRETRAIN, DEQ_TRAIN_DEQMPC, DEQ_LOOP_STEPS = 5, 3, 10
DEQ_B, DEQ_CALLS, DEQ_BC_STEPS, DEQ_NET_TOL = 256, 3, 20, 1e-9
LAUNCHES_PER_TRAIN_STEP["conv-fused"] = LAUNCHES_PER_TRAIN_STEP["fused"]
LAUNCHES_PER_TRAIN_STEP["bc"] = {}
TRACED_TRAIN_STEPS["conv-fused"] = TRACED_TRAIN_STEPS["bc"] = 1
GRAD_TOLS["conv-fused"] = GRAD_TOL
# the device of this slice's phases
CARD = "cuda"


def log(*a):
    print(*a, flush=True)


#: seconds of each phase of main(), by name
PHASE_SECONDS = {}


def timed(name, phase, *args):
    """Run ``phase(*args)``, print and record its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 1)
    log(f"phase {name}: {PHASE_SECONDS[name]} s")
    return out


# ---------------------------------------------------------------- K1 ----
def phase_k1():
    from diff_qp_mpc_tpu_torch.ops import btsolve, btsolve_cuda

    reg = AL_BUDGET["reg"]
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for B in (64, 256, 4096):
            D, O, b = random_bt_spd(B, T, N, dtype, seed=B)
            x_k = btsolve_cuda.batched_factor_solve(D, O, b, reg)
            x_p = btsolve.batched_factor_solve(D, O, b, reg)
            torch.cuda.synchronize()
            abs_err = float((x_k - x_p).abs().max())
            err = abs_err / float(x_p.abs().max())
            ok = bool(torch.isfinite(x_k).all()) and err <= K1_TOL[dtype]
            row = dict(B=B, dtype=str(dtype), max_rel_err=err,
                       max_abs_err=abs_err, tol=K1_TOL[dtype])
            if dtype == torch.float32:
                H = btsolve.to_dense(D, O) + reg * torch.eye(
                    T * N, dtype=dtype, device="cuda")
                bf = b.reshape(B, T * N, 1)

                def library():
                    Lh = torch.linalg.cholesky(H)
                    return torch.cholesky_solve(bf, Lh)

                kern = lambda: btsolve_cuda.batched_factor_solve(D, O, b, reg)
                row["ms_events"] = events_ms(kern, 200)
                row["ms"] = device_kernel_ms(kern, 50, "btsolve")
                row["plain_ms"] = events_ms(
                    lambda: btsolve.batched_factor_solve(D, O, b, reg), 20)
                row["library_ms"] = events_ms(library, 50)
                row["bound_ms"], row["bound_by"] = bound(B * k1_bytes(T, N),
                                                         B * k1_ops(T, N))
                rows[B] = row
            log("K1", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K1 disagrees with its plain version: "
                                   f"{row}")
    # every layout at the main path's shape against the plain version
    # (raises above K1_TOL), timed, at B 64 .. 4096 and on a filled card
    rows["layouts"] = kernel_layouts.k1_layouts(kernel_layouts.BATCHES, reg)
    for r in rows["layouts"]:
        log("K1 layouts", json.dumps(r))
    filled = rows["layouts"][-1]
    share = filled["bound_share"][filled["chosen_layout"]]
    if not 0.0 <= share <= 1.1:
        raise RuntimeError(f"K1 at a filled card: bound share {share}")
    return rows


# ---------------------------------------------------------------- K2 ----
def phase_k2():
    """K2 against its plain version; its bound counts each sin or cos as
    SINF_FP32_INSTR FP32 instructions (and, beside it, as one operation)."""
    from diff_qp_mpc_tpu_torch.models import Pendulum
    from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

    model = Pendulum()
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for B in (64, 256):
            Cd, c, x0, xi, ui = k2_inputs(B, dtype, seed=B)
            args = (model, Cd, c, x0, (-3.0,), (3.0,), xi, ui)
            kern = lambda: al_fused_cuda.fused_al_solve(*args, **AL_BUDGET)
            out_k = kern()
            out_p = al_fused_cuda.fused_al_solve_reference(*args, **AL_BUDGET)
            torch.cuda.synchronize()
            err_xu = (out_k[0] - out_p[0]).abs()
            err_res = float((out_k[4] - out_p[4]).abs().max())
            el_err = err_xu.reshape(B, -1).max(dim=1).values
            row = dict(B=B, dtype=str(dtype),
                       max_abs_err_xu=float(err_xu.max()),
                       max_abs_err_res=err_res,
                       elements_over_tol=int(
                           (el_err > K2_TOL[dtype][0]).sum()),
                       tol=K2_TOL[dtype],
                       res_mean=float(out_k[4].mean()))
            ok = (all(bool(torch.isfinite(o).all()) for o in out_k)
                  and row["max_abs_err_xu"] <= K2_TOL[dtype][0]
                  and err_res <= K2_TOL[dtype][1])
            if dtype == torch.float32:
                row["ms_events"] = events_ms(kern, 20)
                row["ms"] = device_kernel_ms(kern, 10, "al_fused_kernel")
                row["plain_ms"] = events_ms(
                    lambda: al_fused_cuda.fused_al_solve_reference(
                        *args, **AL_BUDGET), 3, warmup=1)
                budget = {k: AL_BUDGET[k] for k in
                          ("al_iter", "n_newton", "n_ls")}
                nbytes = B * k2_bytes(T, NX, NU)
                row["bound_ms"], row["bound_by"] = bound(
                    nbytes, B * k2_ops_with_sin(
                        T, NX, NU, **budget, sin_fp32_instr=SINF_FP32_INSTR))
                row["bound_ms_sin_as_one_op"] = bound(
                    nbytes, B * k2_ops(T, NX, NU, **budget))[0]
                rows[B] = row
            log("K2", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K2 disagrees with its plain version: "
                                   f"{row}")
    # every group width at each batch: the G the rule picks, times, and the
    # outputs bit-identical to G 1 (raises otherwise; float64 too at B 64
    # and 256, and on a problem where every candidate ties)
    rows["groups"] = kernel_layouts.k2_groups(kernel_layouts.BATCHES,
                                              AL_BUDGET)
    for r in rows["groups"]:
        log("K2 groups", json.dumps(r))
    log("K2 tie", json.dumps(kernel_layouts.k2_tie(EPISODES, AL_BUDGET)))
    return rows


# ---------------------------------------------------------------- K3 ----
def lqr_problem(B, T_, nx, nu, dtype, seed, device="cuda"):
    """Random LQR-KKT system with SPD stage costs, on the card."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T_, nx, nx)
    Mu = rng.randn(B, T_, nu, nu)
    arrays = (M @ M.transpose(0, 1, 3, 2) + np.eye(nx),
              0.2 * rng.randn(B, T_, nx, nu),
              Mu @ Mu.transpose(0, 1, 3, 2) + np.eye(nu),
              rng.randn(B, T_, nx), rng.randn(B, T_, nu),
              np.eye(nx) + 0.1 * rng.randn(B, T_ - 1, nx, nx),
              0.2 * rng.randn(B, T_ - 1, nx, nu),
              0.1 * rng.randn(B, T_ - 1, nx), rng.randn(B, nx))
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


def dense_kkt(Cxx, Cxu, Cuu, gx, gu, A, Bm, r, dx0, reg):
    """The LQR-KKT system K3 solves, assembled dense per element:
    [[H, Eᵀ], [E, 0]] [w; λ] = [−g; dx0; r] with w = (x₀, u₀, …) and λ
    the initial-state and dynamics-row multipliers (K3's λ)."""
    B, T_, nx, nu = Cxu.shape
    n = nx + nu
    nw = T_ * n
    K = Cxx.new_zeros(B, nw + T_ * nx, nw + T_ * nx)
    rhs = Cxx.new_zeros(B, nw + T_ * nx)
    eye_x = torch.eye(nx, dtype=Cxx.dtype, device=Cxx.device)
    eye_u = torch.eye(nu, dtype=Cxx.dtype, device=Cxx.device)
    E = Cxx.new_zeros(B, T_ * nx, nw)
    for t in range(T_):
        o = t * n
        K[:, o:o + nx, o:o + nx] = Cxx[:, t]
        K[:, o:o + nx, o + nx:o + n] = Cxu[:, t]
        K[:, o + nx:o + n, o:o + nx] = Cxu[:, t].transpose(-1, -2)
        K[:, o + nx:o + n, o + nx:o + n] = Cuu[:, t] + reg * eye_u
        rhs[:, o:o + nx] = -gx[:, t]
        rhs[:, o + nx:o + n] = -gu[:, t]
    E[:, :nx, :nx] = eye_x
    rhs[:, nw:nw + nx] = dx0
    for t in range(T_ - 1):
        rr, o = (t + 1) * nx, t * n
        E[:, rr:rr + nx, o + n:o + n + nx] = eye_x
        E[:, rr:rr + nx, o:o + nx] = -A[:, t]
        E[:, rr:rr + nx, o + nx:o + n] = -Bm[:, t]
        rhs[:, nw + rr:nw + rr + nx] = r[:, t]
    K[:, nw:, :nw] = E
    K[:, :nw, nw:] = E.transpose(-1, -2)
    return K, rhs


def dense_kkt_split(z, T_, nx, nu):
    """(dx, du, λ) from the dense KKT solution z [B, T·(nx+nu) + T·nx]."""
    nw = T_ * (nx + nu)
    w = z[:, :nw].reshape(-1, T_, nx + nu)
    return w[..., :nx], w[..., nx:], z[:, nw:].reshape(-1, T_, nx)


def _max_errs(got, want):
    """(max abs error, max error relative to the largest entry) over
    matching tensors."""
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got, want))
    return abs_err, rel


def phase_k3():
    from diff_qp_mpc_tpu_torch.ops import riccati, riccati_cuda

    reg = IP_BUDGET["reg"]
    rows = {}
    for dtype in (torch.float32, torch.float64):
        for nx, nu, B in ((NX, NU, 64), (NX, NU, 256), (NX, NU, 4096),
                          (4, 1, 4096)):
            args = lqr_problem(B, T, nx, nu, dtype, seed=B)
            kern = lambda: riccati_cuda.batched_lqr_kkt_solve(*args, reg)
            out_k = kern()
            ref = riccati.batched_lqr_kkt_solve(*args, reg)
            torch.cuda.synchronize()
            abs_err, err = _max_errs(out_k, (ref.dx, ref.du, ref.lam))
            ok = all(bool(torch.isfinite(o).all()) for o in out_k) \
                and err <= K3_TOL[dtype]
            row = dict(B=B, nx=nx, nu=nu, dtype=str(dtype), max_rel_err=err,
                       max_abs_err=abs_err, tol=K3_TOL[dtype])
            if dtype == torch.float32 and (nx, nu) == (NX, NU):
                Kd, rhs = dense_kkt(*args, reg)
                library = lambda: torch.linalg.solve(Kd, rhs)
                _, lib_err = _max_errs(dense_kkt_split(library(), T, NX, NU),
                                       (ref.dx, ref.du, ref.lam))
                row["library_max_rel_err"] = lib_err
                ok = ok and lib_err <= 1e-3  # the library solves the same
                row["ms_events"] = events_ms(kern, 200)
                row["ms"] = device_kernel_ms(kern, 50, "riccati_kernel")
                row["plain_ms"] = events_ms(
                    lambda: riccati.batched_lqr_kkt_solve(*args, reg), 20)
                row["library_ms"] = events_ms(library, 50)
                row["bound_ms"], row["bound_by"] = bound(
                    B * k3_bytes(T, NX, NU), B * k3_ops(T, NX, NU))
                rows[B] = row
            log("K3", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K3 disagrees with its plain version "
                                   f"(or the library): {row}")
    z = torch.empty(64, device="cuda")
    rows[EPISODES]["launch_floor_ms"] = device_kernel_ms(
        lambda: z.zero_(), 200, "elementwise_kernel")
    log("launch floor", json.dumps(dict(
        what="zero_ of 64 floats, one block",
        ms=rows[EPISODES]["launch_floor_ms"], k3_ms=rows[EPISODES]["ms"])))
    rows["filled"] = phase_k3_filled(reg)
    return rows


def phase_k3_filled(reg):
    """K3 at K3_FILLED_B elements, float32, against its plain version on
    the whole batch, timed, with its share of the bytes bound."""
    from diff_qp_mpc_tpu_torch.ops import riccati, riccati_cuda

    B = K3_FILLED_B
    args = lqr_problem(B, T, NX, NU, torch.float32, seed=B)
    kern = lambda: riccati_cuda.batched_lqr_kkt_solve(*args, reg)
    out_k = kern()
    ref = riccati.batched_lqr_kkt_solve(*args, reg)
    torch.cuda.synchronize()
    abs_err, err = _max_errs(out_k, (ref.dx, ref.du, ref.lam))
    row = dict(B=B, nx=NX, nu=NU, dtype=str(torch.float32), max_rel_err=err,
               max_abs_err=abs_err, tol=K3_TOL[torch.float32])
    row["ms_events"] = events_ms(kern, 50)
    row["ms"] = device_kernel_ms(kern, 20, "riccati_kernel")
    row["bound_ms"], row["bound_by"] = bound(B * k3_bytes(T, NX, NU),
                                             B * k3_ops(T, NX, NU))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    log("K3 filled", json.dumps(row))
    if not (all(bool(torch.isfinite(o).all()) for o in out_k)
            and err <= K3_TOL[torch.float32]
            and 0.0 <= row["bound_share"] <= 1.1):
        raise RuntimeError(f"K3 at a filled card: {row}")
    return row


# ---------------------------------------------------------------- K4 ----
def k4_inputs(B, dtype, seed, device="cuda"):
    """Pendulum tracking QPs as the ip path's first SQP QP poses them: the
    dynamics linearized along a reference that drifts from x0, C = diag(Q,
    R), c = −C·τ_ref, warm-started at the reference."""
    from diff_qp_mpc_tpu_torch.models import Pendulum

    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    x_ref[:, 0] = x0
    u_ref = rng.uniform(-4.0, 4.0, (B, T, NU))
    Cd = np.array([10.0, 1.0, 0.01])
    C = np.broadcast_to(np.diag(Cd), (B, T, N, N))
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    to = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)
    x_ref, u_ref = to(x_ref), to(u_ref)
    x_next, A, Bm = Pendulum().linearize(x_ref, u_ref)
    f = x_next - (A @ x_ref[:, :-1, :, None])[..., 0] \
        - (Bm @ u_ref[:, :-1, :, None])[..., 0]
    u_init = torch.clamp(u_ref, IP_BOX[0][0] + 1e-3, IP_BOX[1][0] - 1e-3)
    return (to(C), to(c), A.contiguous(), Bm.contiguous(), f.contiguous(),
            to(x0), x_ref, u_init)


def k4_errors(got, want):
    """Per output field of K4: max |got − want| / max(1, max |want|)."""
    return {name: float((g - w).abs().max()) / max(1.0,
                                                     float(w.abs().max()))
            for name, g, w in zip(K4_FIELDS, got, want)}


def phase_k4():
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
    from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda

    rows = {}
    for dtype in (torch.float32, torch.float64):
        for B in (64, 256):
            args = k4_inputs(B, dtype, seed=B) + IP_BOX
            kern = lambda: trajqp_fused_cuda.fused_trajqp_solve(
                *args, **IP_BUDGET)
            out_k = kern()
            out_p = trajqp_fused_cuda.fused_trajqp_solve_reference(
                *args, **IP_BUDGET)
            torch.cuda.synchronize()
            abs_err, _ = _max_errs(out_k[:2], out_p[:2])
            errs = k4_errors(out_k, out_p)
            row = dict(B=B, dtype=str(dtype), max_abs_err_xu=abs_err,
                       max_abs_err_res=float(
                           (out_k[7] - out_p[7]).abs().max()),
                       scaled_err=errs, tol=K4_TOL[dtype],
                       res_max=float(out_k[7].max()),
                       u_absmax=float(out_k[1].abs().max()))
            ok = (all(bool(torch.isfinite(o).all()) for o in out_k)
                  and abs_err <= K4_TOL[dtype]
                  and max(errs.values()) <= K4_TOL[dtype]
                  and row["u_absmax"] <= IP_BOX[1][0] + 1e-4)
            if dtype == torch.float32:
                out_64 = trajqp_fused_cuda.fused_trajqp_solve_reference(
                    *(a.double() for a in args[:8]), *IP_BOX, **IP_BUDGET)
                row["plain_f32_vs_f64"] = k4_errors(
                    [o.double() for o in out_p], out_64)
                row["ms_events"] = events_ms(kern, 20)
                row["ms"] = device_kernel_ms(kern, 10, "trajqp_fused_kernel")
                row["plain_ms"] = events_ms(
                    lambda: trajqp_fused_cuda.fused_trajqp_solve_reference(
                        *args, **IP_BUDGET), 3, warmup=1)
                row["bound_ms"], row["bound_by"] = bound(
                    B * k4_bytes(T, NX, NU),
                    B * k4_ops(T, NX, NU, IP_BUDGET["max_iter"]))
                rows[B] = row
            log("K4", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K4 disagrees with its plain version: "
                                   f"{row}")
    budget = dict(max_iter=prof.MAX_ITER, reg=prof.REG)
    for dtype in (torch.float32, torch.float64):
        args, bounds = prof.problem(256, T, 4, 1, dtype)
        args = (*args, *prof.cold_start(*args), bounds.u_lo, bounds.u_hi)
        out_k = trajqp_fused_cuda.fused_trajqp_solve(*args, **budget)
        out_p = trajqp_fused_cuda.fused_trajqp_solve_reference(*args,
                                                               **budget)
        torch.cuda.synchronize()
        errs = k4_errors(out_k, out_p)
        row = dict(B=256, nx=4, nu=1, dtype=str(dtype), scaled_err=errs,
                   tol=K4_TOL[dtype])
        log("K4", json.dumps(row))
        if not (all(bool(torch.isfinite(o).all()) for o in out_k)
                and max(errs.values()) <= K4_TOL[dtype]):
            raise RuntimeError(f"K4 disagrees with its plain version: {row}")
    return rows


# ---------------------------------------------------------------- K5 ----
def phase_k5():
    """K5 against its plain version at K5_SHAPE, timed, with its bound (each
    sin as SINF_FP32_INSTR FP32 instructions)."""
    from diff_qp_mpc_tpu_torch.ops import sin_chain_cuda

    n_tiles, n_streams, n_ops = (K5_SHAPE[k] for k in
                                 ("n_tiles", "n_streams", "n_ops"))
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.uniform(0.1, 0.9, (n_tiles, n_streams, 8, 128)),
                     dtype=torch.float32, device="cuda")
    kern = lambda: sin_chain_cuda.sin_chain(x, n_ops)
    out_k = kern()
    out_p = sin_chain_cuda.sin_chain_reference(x, n_ops)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    row = dict(K5_SHAPE, max_abs_err=err, tol=K5_TOL,
               out_absmax=float(out_k.abs().max()))
    row["ms_events"] = events_ms(kern, 50)
    row["ms"] = device_kernel_ms(kern, 20, "sin_chain_kernel")
    row["plain_ms"] = events_ms(
        lambda: sin_chain_cuda.sin_chain_reference(x, n_ops), 3, warmup=1)
    row["bound_ms"], row["bound_by"] = bound(
        k5_bytes(n_tiles, n_streams),
        k5_ops(n_tiles, n_streams, n_ops, SINF_FP32_INSTR))
    log("K5", json.dumps(row))
    if not (bool(torch.isfinite(out_k).all()) and err <= K5_TOL):
        raise RuntimeError(f"K5 disagrees with its plain version: {row}")
    return row


# ---------------------------------------------------------- roofline ----
def phase_roofline():
    """The roofline entry point's functions in quick mode and the K4
    profiler's cases, with the launch counts set to 0 before and read
    after; K5 must have been launched."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
    from diff_qp_mpc_tpu_torch.benchmarks import roofline_fused

    reset_launches()
    roof = roofline_fused.roofline(quick=True, n_rep=ROOF_REP,
                                   n_outer=ROOF_OUTER)
    log("roofline", json.dumps(roof))
    cases = []
    for case in prof.CASES:
        row = prof.bench(*case, n_rep=ROOF_REP, n_outer=ROOF_OUTER)
        log("prof_trajqp_fused", json.dumps(row))
        cases.append(row)
    counts = read_launches()
    log("roofline launches", json.dumps(counts))
    if counts["K5"] <= 0:
        raise RuntimeError("the roofline path launched K5 no time")
    check_roofline_k5()
    check_roofline_k2()
    for case in prof.CASES:
        u = {}
        for dtype in PROF_U_TOL:
            args, bounds = prof.problem(*case, dtype=dtype)
            u.update({(k, dtype): prof.solve_u(args, bounds, k)
                      for k in ("scan", "fused")})
        diff = {str(dt): float((u["fused", dt] - u["scan", dt]).abs().max())
                for dt in PROF_U_TOL}
        f32_err = {k: float((u[k, torch.float32].double()
                             - u["scan", torch.float64]).abs().max())
                   for k in ("scan", "fused")}
        row = dict(zip(("B", "T", "nx", "nu"), case), max_abs_u_diff=diff,
                   tol={str(dt): v for dt, v in PROF_U_TOL.items()},
                   f32_vs_f64_u=f32_err)
        log("prof agreement", json.dumps(row))
        if not all(diff[str(dt)] <= tol for dt, tol in PROF_U_TOL.items()):
            raise RuntimeError(f"K4 and the scan IPM disagree on u: {row}")
    return dict(roofline=roof, prof=cases, launches=counts)


def check_roofline_k5():
    """K5 against its plain version on the roofline's input and its shorter
    chain."""
    from diff_qp_mpc_tpu_torch.benchmarks import roofline_fused as rf
    from diff_qp_mpc_tpu_torch.ops import sin_chain_cuda

    x = rf.sin_input()
    n_ops = rf.SIN_CHAINS[0]
    out_k = sin_chain_cuda.sin_chain(x, n_ops)
    out_p = sin_chain_cuda.sin_chain_reference(x, n_ops)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    row = dict(n_tiles=x.shape[0], n_streams=x.shape[1], n_ops=n_ops,
               max_abs_err=err, tol=K5_TOL)
    log("roofline K5", json.dumps(row))
    if not (bool(torch.isfinite(out_k).all()) and err <= K5_TOL):
        raise RuntimeError(f"K5 disagrees with its plain version on the "
                           f"roofline's input: {row}")


def check_roofline_k2():
    """K2 against its plain version on the roofline's problem and budget,
    float32 (what the roofline times) and float64; see ROOF_K2_SHARE."""
    from diff_qp_mpc_tpu_torch.benchmarks import roofline_fused as rf
    from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

    model, *arrays = rf._problem(262144)
    kw = dict(rf.KERNEL_KW, **rf.BASE)
    for dtype in (torch.float32, torch.float64):
        Cd, c, x0, xi, ui = (a.to(dtype) for a in arrays)
        args = (model, Cd, c, x0, (-3.0,), (3.0,), xi, ui)
        out_k = al_fused_cuda.fused_al_solve(*args, **kw)
        out_p = al_fused_cuda.fused_al_solve_reference(*args, **kw)
        torch.cuda.synchronize()
        el = (out_k[0] - out_p[0]).abs().reshape(Cd.shape[0], -1).max(
            dim=1).values
        tol = K2_TOL[dtype][0]
        row = dict(B=Cd.shape[0], dtype=str(dtype), **kw,
                   share_over_tol=float((el > tol).double().mean()),
                   median_abs_err_xu=float(el.median()),
                   max_abs_err_xu=float(el.max()),
                   median_abs_err_res=float(
                       (out_k[4] - out_p[4]).abs().median()),
                   tol=tol, share_limit=ROOF_K2_SHARE[dtype],
                   median_limit=ROOF_K2_MEDIAN[dtype])
        log("roofline K2", json.dumps(row))
        if not (all(bool(torch.isfinite(o).all()) for o in out_k)
                and row["share_over_tol"] <= ROOF_K2_SHARE[dtype]
                and row["median_abs_err_xu"] <= ROOF_K2_MEDIAN[dtype]
                and row["median_abs_err_res"] <= ROOF_K2_MEDIAN[dtype]):
            raise RuntimeError(f"K2 disagrees with its plain version on the "
                               f"roofline's problem: {row}")


# ------------------------------------------------------------ policy ----
# (name, checkpoint, extra flags) of every solver path the policy phases run
PATHS = (("scan", CKPT, []), ("fused", CKPT, ["--fused"]),
         ("ip-scan", IP_CKPT, []), ("ip-fused", IP_CKPT, ["--fused"]))


def make_policy_from(args, env, ckpt):
    from diff_qp_mpc_tpu_torch.learning.train import make_policy
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    policy = make_policy(args, env)
    policy.load_state_dict(load_policy_params(ckpt, policy.flax_modules()))
    return policy


def phase_policy():
    """One policy forward, float64, on the card vs on the CPU, per path."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate

    rng = np.random.RandomState(0)
    x = torch.tensor(rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (8, NX)),
                     dtype=torch.float64)
    for path, ckpt, flags in PATHS:
        args = evaluate.parse_args(["--env", "pendulum", "--deq", "--ckpt",
                                    ckpt] + flags)
        env = make_env(args.env)
        outs = []
        for device in ("cpu", "cuda"):
            policy = make_policy_from(args, env, ckpt).to(
                device=device, dtype=torch.float64)
            with torch.no_grad():
                its, _ = policy(x.to(device))
            outs.append(torch.cat([its[-1].states, its[-1].actions],
                                  -1).cpu())
        err = float((outs[0] - outs[1]).abs().max())
        log("policy", json.dumps(dict(path=path, max_abs_err=err,
                                      tol=POLICY_TOL)))
        if not err <= POLICY_TOL:
            raise RuntimeError(f"policy on the card disagrees with the CPU "
                               f"({path}): {err}")


# --------------------------------------------------------- main path ----
def kernel_wrappers():
    """Each kernel's wrapper module and the name of its launch count: K3's
    wrapper counts its unrolled kernel in ``launches`` and its horizon
    kernel (K3h) in ``horizon_launches``."""
    from diff_qp_mpc_tpu_torch.ops import (
        al_fused_cuda,
        btsolve_cuda,
        riccati_cuda,
        sin_chain_cuda,
        trajqp_fused_cuda,
    )

    return {"K1": (btsolve_cuda, "launches"),
            "K2": (al_fused_cuda, "launches"),
            "K3": (riccati_cuda, "launches"),
            "K3h": (riccati_cuda, "horizon_launches"),
            "K4": (trajqp_fused_cuda, "launches"),
            "K5": (sin_chain_cuda, "launches")}


def reset_launches():
    """Every kernel's launch count set to 0."""
    for module, count in kernel_wrappers().values():
        setattr(module, count, 0)


def read_launches():
    """Every kernel's launch count, by kernel id."""
    return {k: getattr(module, count)
            for k, (module, count) in kernel_wrappers().items()}


def closed_loops(runs, tag):
    """Each run (name, evaluate argv, kernel, launches per step, least
    success rate or None) of the evaluate entry point with the launch
    counts set to 0 before it and read after: exactly that many launches of
    that kernel per step and no other kernel, a finite reward, and, where
    gated, a success rate of at least the run's least. Returns the metrics
    with the launches, by name."""
    from diff_qp_mpc_tpu_torch.learning import evaluate

    out = {}
    for name, argv, kid, per_step, min_success in runs:
        reset_launches()
        metrics = evaluate.main(argv)
        counts = read_launches()
        out[name] = dict(metrics, launches=counts, launches_per_step=(
            counts[kid] / metrics["steps_run"]))
        log(tag, name, json.dumps(out[name]))
        others = {k: v for k, v in counts.items() if k != kid and v}
        if counts[kid] <= 0 or others or \
                counts[kid] != per_step * metrics["steps_run"]:
            raise RuntimeError(
                f"{name}: launches {counts} over {metrics['steps_run']} "
                f"steps, expected {per_step} {kid} launches per step and no "
                f"other kernel")
        if not np.isfinite(metrics["mean_reward"]):
            raise RuntimeError(f"{name}: non-finite reward")
        if min_success is not None and \
                metrics["success_rate"] < min_success:
            raise RuntimeError(f"{name}: success rate "
                               f"{metrics['success_rate']} < {min_success}")
    return out


def phase_main_path():
    cut = MAIN_PATH_CUT_STEPS
    return closed_loops(
        [(path, ["--env", "pendulum", "--deq", "--ckpt", ckpt, "--episodes",
                 str(EPISODES), "--max_steps",
                 str(cut.get(path, MAX_STEPS))] + flags,
          *LAUNCHES_PER_STEP[path], None if path in cut else MIN_SUCCESS)
         for path, ckpt, flags in PATHS],
        "main_path")


# ------------------------------------------------------------ training ----
def meta_argv(path=TRAIN_META):
    """The train entry point's flags that a JAX trainer's meta.json sets,
    but for the run's length, its logging and checkpointing, and the
    solver kernel (each path adds its own)."""
    from diff_qp_mpc_tpu_torch.learning.train import build_parser

    skip = {"fused", "iters", "pretrain_iters", "ckpt_every", "name",
            "logdir", "save", "load", "ckpt", "data", "x64", "device"}
    with open(path) as f:
        meta = json.load(f)
    argv = []
    for a in build_parser()._actions:
        if a.dest in skip or a.dest not in meta or not a.option_strings:
            continue
        v = meta[a.dest]
        if a.nargs == 0:  # store_true
            argv += [a.option_strings[0]] if v else []
        elif v is not None:
            argv += [a.option_strings[0], str(v)]
    return argv


def phase_k1_al():
    """K1 in float32 on the AL path's Newton systems, against float64."""
    rows = kernel_layouts.k1_al_systems()
    for r in rows:
        log("K1 AL systems", json.dumps(r))
    return rows


def phase_k1_models():
    """K1 at the new models' shapes against its plain version (both
    dtypes, each layout, timed; raises above K1_TOL) and on cp1's own AL
    Newton systems (raises above K1_AL_RATIO)."""
    rows = {}
    for n, T_ in K1_MODEL_SHAPES:
        rows[n, T_] = kernel_layouts.k1_layouts(K1_MODEL_BATCHES, n=n,
                                                T_=T_)
        for r in rows[n, T_]:
            log("K1 model shapes", json.dumps(r))
        rows["library", n, T_] = k1_library_ms(EPISODES, n, T_)
        log("K1 model shapes library", json.dumps(dict(
            B=EPISODES, n=n, T=T_, library_ms=rows["library", n, T_])))
    rows["cp1 AL systems"] = kernel_layouts.k1_al_systems(
        B=256, model_name="cartpole1l", T_=10)
    for r in rows["cp1 AL systems"]:
        log("K1 cp1 AL systems", json.dumps(r))
    rows["quad AL systems"] = kernel_layouts.k1_al_systems(
        B=128, rhos=kernel_layouts.K1_QUAD_AL_RHOS, model_name="quadrotor",
        T_=5)
    for r in rows["quad AL systems"]:
        log("K1 quad AL systems", json.dumps(r))
    return rows


def k1_library_ms(B, n, T_):
    """ms of torch.linalg.cholesky + cholesky_solve on the dense (T·n)²
    systems K1 solves (float32, K1's reg on the diagonal)."""
    from diff_qp_mpc_tpu_torch.ops import btsolve

    reg = AL_BUDGET["reg"]
    D, O, b = random_bt_spd(B, T_, n, torch.float32, seed=B)
    H = btsolve.to_dense(D, O) + reg * torch.eye(
        T_ * n, dtype=torch.float32, device="cuda")
    bf = b.reshape(B, T_ * n, 1)
    return events_ms(lambda: torch.cholesky_solve(
        bf, torch.linalg.cholesky(H)), 50)


def k1_by_shape(k1_models, model_runs, training):
    """The kernels line's K1 rows per new (n, T): float32 ms (the layout
    the rule picks), bound and the largest relative error per dtype at B
    64, and the launches of the runs that take the shape."""
    out = {}
    for (n, T_), rows in ((k, v) for k, v in k1_models.items()
                          if isinstance(k, tuple) and len(k) == 2):
        r = next(r for r in rows if r["B"] == EPISODES)
        lay = r["chosen_layout"]
        entry = dict(B=EPISODES, layout=lay, ms=r["ms"][lay],
                     library_ms=k1_models["library", n, T_],
                     bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                     launches=0, **{k: max(x[k] for x in rows)
                                    for k in r if k.startswith("max_rel")})
        for run, kind in K1_SHAPE_RUNS.get((n, T_), []):
            got = (model_runs[run]["launches"]["K1"] if kind == "closed loop"
                   else training[run]["launches_total"]["K1"])
            entry["launches"] += got
            entry[f"launches_{run}"] = got
        out[f"n{n} T{T_}"] = entry
    # the integrator's scan path takes the pendulum's shape, held by the
    # main row
    out["n3 T5"] = dict(launches_integrator_scan=model_runs[
        "integrator-scan"]["launches"]["K1"], checked="the main row")
    al = k1_models["cp1 AL systems"]
    out["n5 T10"]["cp1_al_systems_max_ratio"] = max(r["ratio"] for r in al)
    out["n16 T5"]["quad_al_systems_max_ratio"] = max(
        r["ratio"] for r in k1_models["quad AL systems"])
    return out


def phase_train_grad():
    """One DEQ-MPC loss and gradient, float64, from each committed
    checkpoint on the card against the CPU; AL fused also in float32 on
    the card against float64 on the card (recorded)."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import data, evaluate, train

    dataset = data.load_expert_pickle(DATA)
    batch = data.sample_window_batch(dataset, GRAD_B, T,
                                     np.random.RandomState(0),
                                     use_native=False)
    rows = {}
    for path, ckpt, flags in PATHS:
        args = evaluate.parse_args(["--env", "pendulum", "--deq", "--ckpt",
                                    ckpt] + flags)
        env = make_env(args.env)
        runs = [("cpu", torch.float64), ("cuda", torch.float64)]
        if path == "fused":
            runs.append(("cuda", torch.float32))
        out = {}
        for device, dtype in runs:
            policy = make_policy_from(args, env, ckpt).to(device=device,
                                                          dtype=dtype)
            loss, _, _ = train.compute_loss(
                policy, args, train.to_batch(batch, device, dtype), True,
                torch.Generator())
            g = torch.autograd.grad(loss, list(policy.parameters()))
            out[device, dtype] = (float(loss.detach()), torch.cat(
                [x.reshape(-1) for x in g]).double().cpu())
        ref = out["cpu", torch.float64][1]
        rel = lambda g: float((g - ref).norm() / ref.norm())
        row = dict(path=path, B=GRAD_B, loss=out["cpu", torch.float64][0],
                   grad_norm=float(ref.norm()),
                   rel_err_card_vs_cpu_f64=rel(
                       out["cuda", torch.float64][1]), tol=GRAD_TOL)
        if path == "fused":
            g32 = out["cuda", torch.float32][1]
            g64 = out["cuda", torch.float64][1]
            row["rel_err_f32_vs_f64_card"] = float(
                (g32 - g64).norm() / g64.norm())
            if not torch.isfinite(g32).all():
                raise RuntimeError(f"float32 training gradient not finite: "
                                   f"{row}")
        log("train grad", json.dumps(row))
        rows[path] = row
        if not (torch.isfinite(out["cuda", torch.float64][1]).all()
                and row["rel_err_card_vs_cpu_f64"] <= GRAD_TOL):
            raise RuntimeError(f"training gradient on the card disagrees "
                               f"with the CPU ({path}): {row}")
    return rows


def train_run(path, argv, traced_steps):
    """The train entry point with ``argv``; the launch counts and the
    implicit-gradient guard's drops are set to 0 before every step and read
    after it, and a torch.profiler trace spans the last ``traced_steps``
    steps. Returns the step records and the trace's summary: host ms per
    step over the traced window and the device's busy share of it
    (kernels, copies and memsets)."""
    from torch.profiler import ProfilerActivity, profile

    from diff_qp_mpc_tpu_torch.learning import train
    from diff_qp_mpc_tpu_torch.solvers import al_mpc
    from diff_qp_mpc_tpu_torch.utils.profile_main_path import (
        _trace_device_time,
    )

    iters = train.build_parser().parse_args(argv).iters
    records = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def reset():
        reset_launches()
        al_mpc.guard_drops = 0

    def on_step(rec):
        rec["launches"] = read_launches()
        rec["guard_drops"] = int(al_mpc.guard_drops)
        records.append(rec)
        if len(records) == iters - traced_steps:
            prof.start()
            window["t0"] = time.perf_counter()
        elif len(records) == iters:
            window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.stop()
        reset()

    reset()
    try:
        train.main(argv, on_step=on_step)
    finally:
        al_mpc.guard_drops = None
        if "t0" in window and "wall_us" not in window:
            prof.stop()
    want = {k: 0 for k in kernel_wrappers()}
    want.update(LAUNCHES_PER_TRAIN_STEP[path])
    for rec in records:
        expected = want if rec["mode"] == "deqmpc" else {
            k: 0 for k in kernel_wrappers()}
        if rec["launches"] != expected:
            raise RuntimeError(f"{path} training step {rec['iter']} "
                               f"({rec['mode']}): launches "
                               f"{rec['launches']}, expected {expected}")
        if not all(np.isfinite(rec[k]) for k in ("loss", "loss_end",
                                                 "grad_norm")):
            raise RuntimeError(f"{path} training step {rec['iter']}: "
                               f"non-finite {rec}")
    out = os.path.join("build", "profile")
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, f"trace_train_{path}.json")
    prof.export_chrome_trace(trace)
    busy, kernels = _trace_device_time(trace)
    busy_us, wall_us = sum(busy.values()), window["wall_us"]
    return records, dict(
        traced_steps=traced_steps,
        host_ms_per_traced_step=wall_us / traced_steps / 1e3,
        device_busy_ms_per_step=busy_us / traced_steps / 1e3,
        device_busy_share=busy_us / wall_us,
        device_launches_per_step=sum(c for _, c in kernels.values())
        / traced_steps)


def phase_train():
    """The training path through the train entry point on all four
    solver paths (see the module docstring, phase 12)."""
    from diff_qp_mpc_tpu_torch.learning import evaluate

    base = meta_argv() + ["--logdir", TRAIN_LOGDIR, "--save"]
    summary = {}
    for path, flags in TRAIN_FLAGS.items():
        t0 = time.perf_counter()
        if path == "fused":
            argv = base + flags + [
                "--iters", str(TRAIN_ITERS), "--pretrain_iters",
                str(TRAIN_PRETRAIN), "--ckpt_every", str(TRAIN_CKPT_EVERY),
                "--name", path]
        else:
            argv = [a for a in base if a != "--pretrain"] + flags + [
                "--iters", str(OTHER_TRAIN_STEPS), "--ckpt_every",
                str(OTHER_TRAIN_STEPS), "--name", path]
        traced = TRACED_TRAIN_STEPS[path]
        records, trace = train_run(path, argv, traced)
        deq = [r for r in records if r["mode"] == "deqmpc"]
        row = dict(path=path, steps=len(records), deqmpc_steps=len(deq),
                   launches_per_deqmpc_step=deq[-1]["launches"],
                   ms_per_step_median=float(np.median(
                       [r["ms"] for r in deq[1:-traced]])),
                   ms_first_deqmpc_step=deq[0]["ms"],
                   guard_drops_per_step=[r["guard_drops"] for r in records],
                   ms_deqmpc_steps=[r["ms"] for r in deq],
                   loss_end_last=deq[-1]["loss_end"],
                   launches_total={k: sum(r["launches"][k] for r in records)
                                   for k in records[0]["launches"]},
                   grad_norm_max=max(r["grad_norm"] for r in records),
                   seconds=time.perf_counter() - t0)
        if path == "fused":
            pre = [r["loss"] for r in records if r["mode"] == "deq"]
            row.update(pretrain_steps=len(pre),
                       pretrain_loss_first5=float(np.mean(pre[:5])),
                       pretrain_loss_last5=float(np.mean(pre[-5:])),
                       ms_pretrain_median=float(np.median(
                           [r["ms"] for r in records
                            if r["mode"] == "deq"][1:])))
            if not row["pretrain_loss_last5"] < row["pretrain_loss_first5"]:
                raise RuntimeError(f"the pretraining loss did not fall: "
                                   f"{row}")
            ckpt = os.path.join(TRAIN_LOGDIR, path, "ckpt.msgpack")
            ev = evaluate.main(["--env", "pendulum", "--deq", "--ckpt", ckpt,
                                "--fused", "--episodes", "8", "--max_steps",
                                "30"])
            row["evaluate"] = ev
            if not (ev["steps_run"] > 0 and np.isfinite(ev["mean_reward"])):
                raise RuntimeError(f"the written checkpoint did not "
                                   f"evaluate: {ev}")
        row.update(trace)
        log("train", json.dumps(row))
        summary[path] = row
    return summary

# ---------------------------------------------- the integrator, cartpoles --
def phase_k2_models():
    """K2 on every new (model, T, dtype) against its plain version, every G
    against G 1, timed (benchmarks/k2_models.py; raises on a failure)."""
    from diff_qp_mpc_tpu_torch.benchmarks import k2_models

    return k2_models.run(log=lambda *a: log(*a))


def _cp1_t5_policy(args, env):
    """cp1's policy at T 5 with weights from seed 0 (flax's initial
    distributions), for the float64 checks: K2 has no float64 T 10
    instantiation, and the checkpoint's weights are T 10's."""
    from diff_qp_mpc_tpu_torch.learning.train import make_policy

    torch.manual_seed(0)
    return make_policy(args, env)


def _model_policies(names=MODEL_POLICY_PATHS):
    """(name, args, env, policy factory) of the float64 checks' paths
    ``names``."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate, train

    with open(CP1_META) as f:
        cp1_data = json.load(f)["data"]
    cp1_t5 = train.build_parser().parse_args(
        meta_argv(CP1_META) + ["--fused", "--T", "5", "--data", cp1_data])
    cases = [("cp1-scan", evaluate.parse_args(["--ckpt", CP1_CKPT]),
              CP1_CKPT),
             ("cp1-fused-T5", cp1_t5, None),
             ("integrator-scan", evaluate.parse_args(["--ckpt", INT_CKPT]),
              INT_CKPT),
             ("cp2-v7-fused", evaluate.parse_args(["--ckpt", CP2_V7_CKPT,
                                                   "--fused"]),
              CP2_V7_CKPT),
             ("quad-scan", evaluate.parse_args(["--ckpt", QUAD_CKPT]),
              QUAD_CKPT),
             ("quad-fused", evaluate.parse_args(["--ckpt", QUAD_CKPT,
                                                 "--fused"]), QUAD_CKPT),
             ("cp2-ip-scan", evaluate.parse_args(["--ckpt", CP2_IP_CKPT]),
              CP2_IP_CKPT),
             ("cp2-ip-fused", evaluate.parse_args(["--ckpt", CP2_IP_CKPT,
                                                   "--fused"]),
              CP2_IP_CKPT)]
    out = []
    for name, args, ckpt in (c for c in cases if c[0] in names):
        env = make_env(args.env, **({"stabilization": True}
                                    if args.stabilization else {}))
        state = (make_policy_from(args, env, ckpt) if ckpt else
                 _cp1_t5_policy(args, env)).state_dict()

        def factory(args=args, env=env, state=state):
            from diff_qp_mpc_tpu_torch.learning.train import make_policy

            policy = make_policy(args, env)
            policy.load_state_dict(state)
            return policy

        out.append((name, args, env, factory))
    return out


def _ulp_nudges(x):
    """The state one ulp up, one down, and up and down in alternate
    coordinates (both ways)."""
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = torch.nextafter(x, torch.full_like(x, -float("inf")))
    even = torch.arange(x.shape[-1]) % 2 == 0
    return [up, down, torch.where(even, up, down),
            torch.where(even, down, up)]


def _other_nudges(x, seed):
    """Four one-ulp perturbations of the state beside ``_ulp_nudges``: two
    ulps up and down, and two random sign patterns (seeded)."""
    inf = torch.full_like(x, float("inf"))
    up = torch.nextafter(x, inf)
    down = torch.nextafter(x, -inf)
    signs = torch.rand((2,) + x.shape, generator=torch.Generator()
                       .manual_seed(seed)) < 0.5
    return [torch.nextafter(up, inf), torch.nextafter(down, -inf),
            torch.where(signs[0], up, down), torch.where(signs[1], up, down)]


def _last_iterate(policy, x):
    with torch.no_grad():
        its, _ = policy(x)
    return torch.cat([its[-1].states, its[-1].actions], -1).cpu()


def _row_change(policy, ref, nudged):
    """Each row's largest |Δ| of the policy's last iterate over the nudged
    states, from ``ref``."""
    return torch.stack([(_last_iterate(policy, xx) - ref).abs().flatten(
        1).amax(-1) for xx in nudged]).amax(0)


def policy_spread(seeds=POLICY_SPREAD_SEEDS, B=8):
    """On the CPU, float64, per new path over ``seeds`` seeds of B initial
    states: the witness (the largest change of a row under
    ``_ulp_nudges``) and the largest change under ``_other_nudges``, over
    the rows neither moves by more than POLICY_JUMP; prints per path their
    largest ratio over the seeds, from which POLICY_ULP_FACTOR is set. Run
    it as ``python3 -c 'import chip_smoke; chip_smoke.policy_spread()'``."""
    out = {}
    for name, args, env, factory in _model_policies(
            MODEL_POLICY_PATHS + CP2_IP_POLICY_PATHS):
        policy = factory().to(dtype=torch.float64)
        ratios, witness, jumps = [], [], 0
        for seed in range(seeds):
            x = env._sample_init(torch.Generator().manual_seed(seed), B)
            ref = _last_iterate(policy, x)
            w = _row_change(policy, ref, _ulp_nudges(x))
            o = _row_change(policy, ref, _other_nudges(x, seed))
            held = (w <= POLICY_JUMP) & (o <= POLICY_JUMP)
            jumps += int((~held).sum())
            wmax, omax = float(w[held].max()), float(o[held].max())
            witness.append(wmax)
            ratios.append(omax / wmax if wmax > 0 else float(omax > 0))
        out[name] = dict(path=name, T=args.T, seeds=seeds, rows=seeds * B,
                         rows_over_jump=jumps, largest_witness=max(witness),
                         largest_ratio=max(ratios), ratios=ratios)
        log("policy spread", json.dumps(out[name]))
    return out


def phase_model_policy(names=MODEL_POLICY_PATHS, cases=None):
    """One float64 policy forward on the card against the CPU on the paths
    ``names`` (or on ``cases``, as _model_policies gives them), row by row:
    within POLICY_ULP_FACTOR times the CPU's own largest change under one
    ulp of the state (or POLICY_TOL if larger) on every row that change
    moves by at most POLICY_JUMP (at least half)."""
    for name, args, env, factory in cases or _model_policies(names):
        x = env._sample_init(torch.Generator().manual_seed(0), 8)
        cpu = factory().to(dtype=torch.float64)
        ref = _last_iterate(cpu, x)
        spread = _row_change(cpu, ref, _ulp_nudges(x))
        card = _last_iterate(factory().to(device="cuda",
                                          dtype=torch.float64), x.cuda())
        err = (card - ref).abs().flatten(1).amax(-1)
        held = spread <= POLICY_JUMP
        witness = float(spread[held].max()) if held.any() else 0.0
        tol = max(POLICY_TOL, POLICY_ULP_FACTOR * witness)
        row = dict(path=name, T=args.T, tol=tol, witness=witness,
                   rows=len(err), rows_held=int(held.sum()),
                   max_abs_err_held=float(err[held].max()) if held.any()
                   else None,
                   not_held=[dict(err=float(e), cpu_one_ulp_change=float(c))
                             for e, c in zip(err[~held], spread[~held])])
        log("model policy", json.dumps(row))
        if not (bool(torch.isfinite(card).all())
                and 2 * row["rows_held"] >= row["rows"]
                and row["max_abs_err_held"] <= tol):
            raise RuntimeError(f"policy on the card disagrees with the CPU "
                               f"({name}): {row}")


def phase_model_main_path():
    """The new models' closed loops through the evaluate entry point (see
    the module docstring, phase 16), each beside the JAX package's success
    rate."""
    runs = closed_loops(
        [(name, ["--ckpt", ckpt, "--episodes", str(EPISODES), "--max_steps",
                 str(max_steps)] + flags, kid, per_step, min_success)
         for name, ckpt, flags, max_steps, kid, per_step, _, min_success
         in MODEL_RUNS], "model main_path")
    for name, *_, jax_success, _ in MODEL_RUNS:
        runs[name]["jax_success_rate"] = jax_success
        log("model main_path vs JAX", name, json.dumps(dict(
            success_rate=runs[name]["success_rate"],
            jax_success_rate=jax_success)))
    # the quadrotor beside the JAX package's own 64 episodes on its fused
    # path (its draw of initial states, not the port's)
    with open(os.path.join(os.path.dirname(QUAD_CKPT),
                           "eval_fused.json")) as f:
        jax_eval = json.load(f)
    keys = ("success_rate", "mean_reward", "mean_episode_len",
            "median_final_goal_err")
    log("quad main_path vs JAX", json.dumps(dict(
        port={k: runs["quad-fused"][k] for k in keys},
        jax={k: jax_eval[k] for k in keys},
        ms_per_step=runs["quad-fused"]["ms_per_step"],
        launches_per_step=runs["quad-fused"]["launches_per_step"])))
    return runs


def phase_model_train_grad(names=MODEL_POLICY_PATHS, cases=None):
    """One DEQ-MPC loss and gradient, float64, B GRAD_B, on the card against
    the CPU: cp1 fused (T 5, seeded weights, a batch of its expert data)
    and the integrator's checkpoint on the scan path (or ``cases``)."""
    from diff_qp_mpc_tpu_torch.learning import data, train

    rows = {}
    for name, args, env, factory in cases or _model_policies(names):
        if name not in GRAD_TOLS:
            continue
        dataset = data.load_expert_pickle(
            args.data or train.default_data_path(args, env))
        batch = data.sample_window_batch(dataset, GRAD_B, args.T,
                                         np.random.RandomState(0),
                                         use_native=False)
        out = {}
        for device in ("cpu", "cuda"):
            policy = factory().to(device=device, dtype=torch.float64)
            loss, _, _ = train.compute_loss(
                policy, args, train.to_batch(batch, device, torch.float64),
                True, torch.Generator().manual_seed(0))
            g = torch.autograd.grad(loss, list(policy.parameters()))
            out[device] = (float(loss.detach()), torch.cat(
                [x.reshape(-1) for x in g]).cpu())
        ref = out["cpu"][1]
        row = dict(path=name, B=GRAD_B, T=args.T, loss=out["cpu"][0],
                   grad_norm=float(ref.norm()),
                   rel_err_card_vs_cpu_f64=float(
                       (out["cuda"][1] - ref).norm() / ref.norm()),
                   tol=GRAD_TOLS[name])
        log("model train grad", json.dumps(row))
        rows[name] = row
        if not (torch.isfinite(out["cuda"][1]).all()
                and row["rel_err_card_vs_cpu_f64"] <= GRAD_TOLS[name]):
            raise RuntimeError(f"training gradient on the card disagrees "
                               f"with the CPU ({name}): {row}")
    return rows


def phase_model_train(path, meta_path, pretrain, deqmpc, data=None,
                      extra=(), ckpt_every=10):
    """Training through the train entry point with a checkpoint's flags
    (its meta.json, fused, then ``extra``) on its data (or ``data``), cut
    to ``pretrain`` + ``deqmpc`` steps; launches checked exactly at every
    step (train_run)."""
    with open(meta_path) as f:
        meta = json.load(f)
    argv = meta_argv(meta_path) + [
        "--data", data or meta["data"], "--fused", "--logdir", TRAIN_LOGDIR,
        "--save", "--iters", str(pretrain + deqmpc),
        "--pretrain_iters", str(pretrain), "--ckpt_every", str(ckpt_every),
        "--name", path, *extra]
    t0 = time.perf_counter()
    traced = TRACED_TRAIN_STEPS[path]
    records, trace = train_run(path, argv, traced)
    deq = [r for r in records if r["mode"] == "deqmpc"]
    pre = [r for r in records if r["mode"] == "deq"]
    row = dict(path=path, steps=len(records), deqmpc_steps=len(deq),
               launches_per_deqmpc_step=deq[-1]["launches"],
               ms_per_step_median=float(np.median(
                   [r["ms"] for r in deq[1:-traced]])),
               ms_first_deqmpc_step=deq[0]["ms"],
               ms_pretrain_median=float(np.median(
                   [r["ms"] for r in pre[1:]])),
               loss_end_last=deq[-1]["loss_end"],
               loss_end_deqmpc=[r["loss_end"] for r in deq],
               guard_drops_per_step=[r["guard_drops"] for r in records],
               launches_total={k: sum(r["launches"][k] for r in records)
                               for k in records[0]["launches"]},
               grad_norm_max=max(r["grad_norm"] for r in records),
               seconds=time.perf_counter() - t0)
    row.update(trace)
    if not (len(pre) == pretrain and len(deq) == deqmpc):
        raise RuntimeError(f"{path} training: {len(pre)} pretraining and "
                           f"{len(deq)} DEQ-MPC steps")
    log("model train", json.dumps(row))
    return row


# ------------------- the terminal-LQR ip path and the MPC expert (cp2) ----
def _rel_err(got, want):
    """max |got − want| over max |want|, in float64."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _k3_errors(out, ref):
    """The largest of dx's, du's and λ's _rel_err."""
    return max(_rel_err(g, w) for g, w in zip(out, ref))


def _plain_k3(args, reg):
    from diff_qp_mpc_tpu_torch.ops import riccati

    sol = riccati.batched_lqr_kkt_solve(*args, reg)
    return sol.dx, sol.du, sol.lam


def k3_check(args, reg, ratio=None):
    """K3 on ``args`` against its plain version: float64 within K3_TOL;
    float32 within K3_TOL, or with ``ratio`` (by default where T is not
    the tracker's 5; an IPM's own systems pass True) against the float64
    solution within F32_VS_F64_RATIO of the plain float32 version's error
    (or K3_TOL). Returns the row; raises on a failure."""
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda

    dtype = args[0].dtype
    B, T_, nx, nu = args[1].shape
    out = riccati_cuda.batched_lqr_kkt_solve(*args, reg)
    plain = _plain_k3(args, reg)
    torch.cuda.synchronize()
    row = dict(B=B, T=T_, nx=nx, nu=nu, dtype=str(dtype),
               kernel=riccati_cuda.kernel_for(T_, nx, nu),
               max_rel_err=_k3_errors(out, plain), tol=K3_TOL[dtype])
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    if ratio is None:
        ratio = T_ != T
    if dtype == torch.float64 or not ratio:
        ok = finite and row["max_rel_err"] <= K3_TOL[dtype]
    else:
        ref = _plain_k3([a.double() for a in args], reg)
        row["kernel_vs_f64"] = _k3_errors(out, ref)
        row["plain_vs_f64"] = _k3_errors(plain, ref)
        row["limit"] = max(K3_TOL[dtype],
                           F32_VS_F64_RATIO * row["plain_vs_f64"])
        ok = finite and row["kernel_vs_f64"] <= row["limit"]
    if not ok:
        raise RuntimeError(f"K3 disagrees with its plain version: {row}")
    return row


def k3_timing(args, reg, name=None):
    """ms of the kernel ``name`` (by default the one the shape routes to;
    device time from events queued behind a spin kernel, see the note
    above EXPERT_RUNS), of the plain version, and of torch.linalg.solve on
    the dense KKT system (events around 50 calls, as phase_k3's rows), and
    the bound, float32."""
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda

    B, T_, nx, nu = args[1].shape
    name = name or riccati_cuda.kernel_for(T_, nx, nu)
    kern = lambda: riccati_cuda._launch(args, float(reg), name)
    row = dict(B=B, T=T_, nx=nx, nu=nu, kernel=name,
               ms=queued_events_ms(kern, 20),
               plain_ms=events_ms(lambda: _plain_k3(args, reg), 3,
                                  warmup=1))
    Kd, rhs = dense_kkt(*args, reg)
    library = lambda: torch.linalg.solve(Kd, rhs)
    row["library_ms"] = events_ms(library, 50)
    row["library_max_rel_err"] = _k3_errors(
        dense_kkt_split(library(), T_, nx, nu), _plain_k3(args, reg))
    row["bound_ms"], row["bound_by"] = bound(B * k3_bytes(T_, nx, nu),
                                             B * k3_ops(T_, nx, nu))
    return row


def phase_k3_horizon():
    """(a) K3 at (5, 6, 1) (the unrolled kernel) and the horizon kernel at
    every expert planner's shape, B 64, 256 and the dataset's batch, both
    dtypes, against the plain version (k3_check); timed in float32 at B
    64, the horizon kernel also at (5, 6, 1) beside the unrolled one."""
    reg = IP_BUDGET["reg"]
    rows = {}
    for shape in ((T, 6, 1),) + K3_HORIZON_SHAPES:
        T_, nx, nu = shape
        key = f"T{T_} nx{nx} nu{nu}"
        checks = []
        for dtype in (torch.float32, torch.float64):
            for B in (EPISODES, 256, K3_DATASET_B.get((nx, nu), 200)):
                args = lqr_problem(B, T_, nx, nu, dtype, seed=B + T_)
                checks.append(k3_check(args, reg))
                log("K3 horizon", json.dumps(checks[-1]))
        args = lqr_problem(EPISODES, T_, nx, nu, torch.float32,
                           seed=EPISODES + T_)
        rows[key] = dict(k3_timing(args, reg), checks=checks)
        if T_ == T:
            rows[key]["horizon_kernel"] = k3_timing(args, reg,
                                                    "riccati_horizon")
        log("K3 horizon timing", json.dumps(
            {k: v for k, v in rows[key].items() if k != "checks"}))
    return rows


class recording:
    """Within the block, ``module.name`` also records a copy of its
    positional arguments (and keywords) at every call."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = getattr(self.module, self.name)

        def spy(*args, **kw):
            self.calls.append((tuple(a.clone() if isinstance(
                a, torch.Tensor) else a for a in args), dict(kw)))
            return fn(*args, **kw)

        self.fn = fn
        setattr(self.module, self.name, spy)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _cp2_ip_policy(fused, device="cuda", dtype=torch.float32):
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate

    args = evaluate.parse_args(["--ckpt", CP2_IP_CKPT]
                               + (["--fused"] if fused else []))
    env = make_env(args.env, stabilization=args.stabilization)
    policy = make_policy_from(args, env, CP2_IP_CKPT)
    return policy.to(device=device, dtype=dtype), env


def phase_cp2_qps():
    """K3 at (5, 6, 1) on the cp2 ip checkpoint's own Riccati systems (its
    scan IPM's, terminal P included), K4 at (5, 6, 1) on its own QPs (its
    fused path's) and the horizon kernel at (10, 6, 1) on the cp2
    stabilize expert's systems, recorded on the card in float32 from 64
    initial states; and (b) K4 at (5, 6, 1) on the K4 profiler's random
    QPs, B 64 and 256, both dtypes, within K4_TOL on all eight outputs,
    timed at B 64."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import datagen
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda, trajqp_fused_cuda

    rows = {"K3 checkpoint systems": [], "K4 checkpoint QPs": [],
            "K3 expert systems": []}
    policy, env = _cp2_ip_policy(fused=False)
    x = env._sample_init(torch.Generator().manual_seed(1), EPISODES).to(
        device="cuda", dtype=torch.float32)
    with recording(riccati_cuda, "batched_lqr_kkt_solve") as calls:
        with torch.no_grad():
            policy(x)
    # every 24th system: the predictor of each IPM solve's first iteration
    for args, _ in calls[::24] + calls[23::24]:
        for dtype in (torch.float32, torch.float64):
            rows["K3 checkpoint systems"].append(k3_check(
                [a.to(dtype) for a in args[:9]], args[9], ratio=True))
    log("K3 cp2 checkpoint systems", json.dumps(dict(
        systems=len(rows["K3 checkpoint systems"]) // 2,
        worst=max(rows["K3 checkpoint systems"], key=lambda r: r.get(
            "kernel_vs_f64", 0.0) / r.get("limit", 1.0)))))

    policy, env = _cp2_ip_policy(fused=True)
    with recording(trajqp_fused_cuda, "fused_trajqp_solve") as calls:
        with torch.no_grad():
            policy(x)
    for args, kw in calls[::3]:
        rows["K4 checkpoint QPs"].append(k4_check(args, kw, ratio=True))
    log("K4 cp2 checkpoint QPs", json.dumps(rows["K4 checkpoint QPs"][-1]))

    stab = make_env("cartpole2link", stabilization=True)
    with recording(riccati_cuda, "batched_lqr_kkt_solve") as calls:
        datagen.mpc_expert_rollouts(
            stab, EPISODES, max_steps=1, dtype=torch.float32, seed=1,
            device="cuda")
    for args, _ in calls[::12]:
        for dtype in (torch.float32, torch.float64):
            rows["K3 expert systems"].append(k3_check(
                [a.to(dtype) for a in args[:9]], args[9], ratio=True))
    log("K3 cp2 expert systems", json.dumps(dict(
        systems=len(rows["K3 expert systems"]) // 2,
        worst=max(rows["K3 expert systems"], key=lambda r: r.get(
            "kernel_vs_f64", 0.0) / r.get("limit", 1.0)))))

    rows["K4 random"] = []
    for dtype in (torch.float32, torch.float64):
        for B in (EPISODES, 256):
            arrays, box = prof.problem(B, T, 6, 1, dtype)
            arrays = (*arrays, *prof.cold_start(*arrays))
            bounds = (box.u_lo, box.u_hi)
            row = k4_check(arrays, dict(IP_BUDGET, u_lo=bounds[0],
                                        u_hi=bounds[1]))
            rows["K4 random"].append(row)
            log("K4 T5 nx6 nu1", json.dumps(row))
            if dtype == torch.float32 and B == EPISODES:
                kern = lambda: trajqp_fused_cuda.fused_trajqp_solve(
                    *arrays, *bounds, **IP_BUDGET)
                rows["timing"] = dict(
                    B=B, ms=queued_events_ms(kern, 10),
                    plain_ms=events_ms(
                        lambda: trajqp_fused_cuda.fused_trajqp_solve_reference(
                            *arrays, *bounds, **IP_BUDGET), 3, warmup=1),
                    library_ms=None)
                rows["timing"]["bound_ms"], rows["timing"]["bound_by"] = \
                    bound(B * k4_bytes(T, 6, 1),
                          B * k4_ops(T, 6, 1, IP_BUDGET["max_iter"]))
                log("K4 T5 nx6 nu1 timing", json.dumps(rows["timing"]))
    return rows


def _ulp_nudged(args, i, up):
    """``args`` with the tensor at ``i`` one ulp up or down."""
    out = list(args)
    out[i] = torch.nextafter(args[i], torch.full_like(
        args[i], float("inf") if up else -float("inf")))
    return out


def k4_check(args, kw, ratio=False):
    """K4 on the QP ``args`` (C … u_init, then the box if positional) with
    the keywords ``kw`` against its plain version, on all eight outputs:
    float64 within K4_TOL; float32 within K4_TOL, or with ``ratio`` (the
    checkpoint's own QPs) against the float64 solution, per output, within
    F32_VS_F64_RATIO of the plain float32 version's error or K4_TOL. The
    plain version's error there is its rounding envelope: the largest over
    the QP and its four one-ulp nudges of c and x0 (float32 rounding of the
    residual total alone, with P's entries at 2.5e5, moves it by 1-3% from
    draw to draw). Returns the row; raises on a failure."""
    from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda

    args = [a.contiguous() if isinstance(a, torch.Tensor) else a
            for a in args]
    dtype = args[0].dtype
    out = trajqp_fused_cuda.fused_trajqp_solve(*args, **kw)
    plain = trajqp_fused_cuda.fused_trajqp_solve_reference(*args, **kw)
    torch.cuda.synchronize()
    errs = k4_errors(out, plain)
    row = dict(B=args[0].shape[0], dtype=str(dtype), scaled_err=errs,
               tol=K4_TOL[dtype])
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    if dtype == torch.float64 or not ratio:
        ok = finite and max(errs.values()) <= K4_TOL[dtype]
    else:
        a64 = [a.double() if isinstance(a, torch.Tensor) else a
               for a in args]
        ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*a64, **kw)
        k_err = k4_errors([o.double() for o in out], ref)
        p_err = k4_errors([o.double() for o in plain], ref)
        for i in (1, 5):  # c, x0
            for up in (True, False):
                e = k4_errors([o.double() for o in
                               trajqp_fused_cuda.fused_trajqp_solve_reference(
                                   *_ulp_nudged(args, i, up), **kw)], ref)
                p_err = {f: max(p_err[f], e[f]) for f in K4_FIELDS}
        row.update(kernel_vs_f64=k_err, plain_vs_f64=p_err)
        ok = finite and all(k_err[f] <= max(K4_TOL[dtype],
                                            F32_VS_F64_RATIO * p_err[f])
                            for f in K4_FIELDS)
        out64 = trajqp_fused_cuda.fused_trajqp_solve(*a64, **kw)
        row["float64_scaled_err"] = k4_errors(out64, ref)
        ok = ok and max(row["float64_scaled_err"].values()) \
            <= K4_TOL[torch.float64]
    if not ok:
        raise RuntimeError(f"K4 disagrees with its plain version: {row}")
    return row


def phase_cp2_ip_main_path():
    """(c) the cp2 ip checkpoint in closed loop through the evaluate entry
    point, float32, 64 episodes: the fused path (K4, 18 launches a step)
    cut to 15 steps, beside the JAX package's eval_fused.json (its
    episodes run up to 200), and the scan path (K3 at (5, 6, 1), 432 a
    step) cut to 10 steps; the launches per step exact, no other kernel.
    The float64 forward card vs CPU runs in phase_model_policy (its cases
    include these paths)."""
    runs = closed_loops(
        [(name, ["--ckpt", CP2_IP_CKPT, "--episodes", str(EPISODES),
                 "--max_steps", str(steps)] + flags, kid, per_step, None)
         for name, flags, steps, kid, per_step in CP2_IP_RUNS],
        "cp2 ip main_path")
    with open(os.path.join(os.path.dirname(CP2_IP_CKPT),
                           "eval_fused.json")) as f:
        jax_eval = json.load(f)
    keys = ("success_rate", "mean_reward", "mean_episode_len",
            "median_final_goal_err")
    log("cp2 ip main_path vs JAX", json.dumps(dict(
        port={k: runs["cp2-ip-fused"][k] for k in keys},
        jax={k: jax_eval[k] for k in keys})))
    return runs


def expert_run(name, env, num_traj, max_steps, per_step):
    """The MPC expert (datagen.mpc_expert_rollouts, float64, the default)
    on ``env`` from its reset draw: the launch counts set to 0 before every
    MPC step and read after it, exactly ``per_step`` horizon-kernel (K3h)
    launches and no other kernel; ms per step (host clock, each step ends
    in a copy to the host), the success share of the trajectories' last
    states; its first step's actions against the CPU expert's on the first
    EXPERT_CPU_ROWS initial states, within EXPERT_TOL of their largest; and
    the device's busy share over a torch.profiler trace of the second and
    third MPC steps (kernels, copies and memsets over the host's time)."""
    from torch.profiler import ProfilerActivity, profile

    from diff_qp_mpc_tpu_torch.learning import datagen
    from diff_qp_mpc_tpu_torch.utils.profile_main_path import (
        _trace_device_time,
    )

    want = {k: 0 for k in kernel_wrappers()}
    want["K3h"] = per_step
    times, bad = [], []
    t_prev = [time.perf_counter()]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}

    def on_step(step):
        counts = read_launches()
        if counts != want:
            bad.append((step, counts))
        reset_launches()
        now = time.perf_counter()
        times.append((now - t_prev[0]) * 1e3)
        t_prev[0] = now
        if step == 0:  # trace the second and third steps
            prof.start()
            window["t0"] = time.perf_counter()
        elif step == 2:
            window["wall_us"] = (time.perf_counter() - window["t0"]) * 1e6
            prof.stop()

    reset_launches()
    t0 = time.perf_counter()
    try:
        trajs = datagen.mpc_expert_rollouts(
            env, num_traj, max_steps=max_steps, device="cuda",
            on_step=on_step)
    finally:
        if "t0" in window and "wall_us" not in window:
            prof.stop()
    seconds = time.perf_counter() - t0
    trace = os.path.join("build", "profile", f"trace_expert_{name}.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    busy, kernels = _trace_device_time(trace)
    if bad:
        raise RuntimeError(f"{name}: launches per MPC step {bad[:3]}, "
                           f"expected {want}")
    finals = torch.as_tensor(np.stack([t[-1][0] for t in trajs]))
    # the reset draw the card run started from (drawn on the CPU, float64)
    x0 = env._sample_init(torch.Generator().manual_seed(0), num_traj)
    cpu = datagen.mpc_expert_rollouts(env, EXPERT_CPU_ROWS, max_steps=1,
                                      init_states=x0[:EXPERT_CPU_ROWS],
                                      device="cpu")
    u_card = np.stack([t[0][1] for t in trajs[:EXPERT_CPU_ROWS]])
    u_cpu = np.stack([t[0][1] for t in cpu])
    row = dict(name=name, trajectories=len(trajs),
               steps=len(times), launches_per_step=dict(K3h=per_step),
               ms_per_step_median=float(np.median(times[1:])),
               ms_first_step=times[0], seconds=seconds,
               success_share=float(env._success(finals).double().mean()),
               mean_len=float(np.mean([len(t) for t in trajs])),
               first_action_card_vs_cpu=float(np.abs(u_card - u_cpu).max()),
               tol=EXPERT_TOL * float(np.abs(u_cpu).max()),
               traced_steps=2,
               device_busy_ms_per_step=sum(busy.values()) / 2 / 1e3,
               device_busy_share=sum(busy.values()) / window["wall_us"],
               device_launches_per_step=sum(
                   c for _, c in kernels.values()) / 2,
               launches_total={"K3h": per_step * len(times)})
    log("expert", json.dumps(row))
    if not (all(np.isfinite(p).all() for t in trajs for s in t for p in s)
            and row["first_action_card_vs_cpu"] <= row["tol"]):
        raise RuntimeError(f"{name}: {row}")
    return row


def phase_experts():
    """(e) the cp2 stabilize expert (terminal LQR, T 10, K3h at (10, 6, 1))
    on 64 trajectories cut to 20 steps, and the quadrotor's (T 20, K3h at
    (20, 12, 4)) on 16 × 5; per MPC step (qp_iter + 1) QPs × max_iter 12
    × 2 Riccati solves."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import datagen

    out = {}
    for name, env_name, kw, n, steps in EXPERT_RUNS:
        env = make_env(env_name, **kw)
        qp_iter = datagen.planner_settings(env)["qp_iter"]
        per_step = (qp_iter + 1) * IP_BUDGET["max_iter"] * 2
        out[name] = expert_run(name, env, n, steps, per_step)
    return out


def phase_dagger():
    """(f) DAgger through its entry point from the cp1 checkpoint (its
    meta.json's flags, fused): DAGGER_EPISODES episodes of DAGGER_STEPS
    steps (K2, 24 launches a step), DAGGER_RELABEL states relabeled by the
    stabilize expert for DAGGER_RELABEL_STEPS steps (K3h at (60, 4, 1),
    264 launches an MPC step, exact); the pickle it writes must load."""
    from diff_qp_mpc_tpu_torch.learning import dagger, data

    out = os.path.join("build", "chip_smoke_dagger.pkl")
    argv = meta_argv(CP1_META) + [
        "--ckpt", CP1_CKPT, "--fused", "--episodes", str(DAGGER_EPISODES),
        "--max_steps", str(DAGGER_STEPS), "--num_relabel",
        str(DAGGER_RELABEL), "--relabel_steps", str(DAGGER_RELABEL_STEPS),
        "--out", out]
    want = {k: 0 for k in kernel_wrappers()}
    want["K3h"] = DAGGER_K3H_PER_STEP
    collect, bad, times = {}, [], []

    def on_step(step):
        if not collect:
            collect.update(read_launches())
        elif read_launches() != want:
            bad.append((step, read_launches()))
        reset_launches()
        times.append(time.perf_counter())

    reset_launches()
    t0 = time.perf_counter()
    summary = dagger.main(argv, on_expert_step=on_step)
    seconds = time.perf_counter() - t0
    loaded = data.load_expert_pickle(out)
    # the first expert step's counts also hold the collection's K2 launches
    k2 = collect.get("K2", 0)
    first = {k: v for k, v in collect.items() if k != "K2"}
    row = dict(summary, seconds=seconds, collect_k2_launches=k2,
               expert_steps=len(times),
               ms_per_expert_step=float(np.median(np.diff(times)) * 1e3)
               if len(times) > 1 else None,
               launches_per_expert_step=dict(K3h=DAGGER_K3H_PER_STEP),
               launches_total={"K2": k2, "K3h": DAGGER_K3H_PER_STEP
                               * len(times)})
    log("dagger", json.dumps(row))
    if bad or first != {k: v for k, v in want.items() if k != "K2"} or not (
            0 < k2 <= DAGGER_K2_PER_STEP * DAGGER_STEPS
            and k2 % DAGGER_K2_PER_STEP == 0):
        raise RuntimeError(f"DAgger launches: collection and first expert "
                           f"step {collect}, later steps {bad[:3]}, "
                           f"expected {want} an expert step and "
                           f"{DAGGER_K2_PER_STEP} K2 a policy step")
    if not (summary["num_traj"] == DAGGER_RELABEL
            and len(loaded["state"]) == summary["steps"]
            and np.isfinite(loaded["state"]).all()):
        raise RuntimeError(f"DAgger wrote {summary}, loaded "
                           f"{len(loaded['state'])} steps")
    return row


# ------------- the OptNet QP layer, SL1QP and the slew-rate option ----
class one_cpu_thread:
    """Within the block, PyTorch's CPU ops run on one thread: the batched
    CPU LU (getrf) of the QP layer's references has deadlocked and
    reported bad pivots under several threads on one host."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def sync():
    torch.cuda.synchronize()


def _check_err(row):
    """The error a K3 or K4 check is judged by: against the float64
    solution where the ratio rule applies, else against the plain
    version (K4: its largest field)."""
    err = row.get("kernel_vs_f64", row.get("max_rel_err",
                                           row.get("scaled_err")))
    return max(err.values()) if isinstance(err, dict) else err


def _scaled_err(got, want, floor=1e-300):
    """max |got − want| over max(max |want|, floor), in float64; 0 for
    empty tensors."""
    if want.numel() == 0:
        return 0.0
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), floor))


def phase_qp_layer():
    """The OptNet QP layer (solvers.qp) at nz = nineq = 100, B 128, neq 0
    and QP_NEQ_DRAW, both solvers: float64 card vs CPU (z, the residual
    total, the six gradients), float32 by the ratio rule; no kernel
    launched. Then ms per solve and per forward plus backward at B 1, 64
    and 128 in float64 (benchmarks/prof_qp_sizes.py)."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_qp_sizes
    from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig, qp_solve

    rows = []
    R = QP_CPU_ROWS
    reset_launches()
    for neq in (0, QP_NEQ_DRAW):
        for solver in prof_qp_sizes.SOLVERS:
            cfg = QPConfig(solver=solver)
            card = prof_qp_sizes.problem(QP_B, QP_NZ, QP_NINEQ, neq,
                                         torch.float64, CARD)
            cpu = [a[:R].cpu() for a in card]
            sol = qp_solve(*card, cfg)
            grads = prof_qp_sizes.forward_backward(card, cfg)[1:]
            sol32 = qp_solve(*(a.float() for a in card), cfg)
            with one_cpu_thread():
                ref = qp_solve(*cpu, cfg)
                ref_grads = prof_qp_sizes.forward_backward(cpu, cfg)[1:]
                ref32 = qp_solve(*(a.float() for a in cpu), cfg)
            row = dict(neq=neq, solver=solver, B=QP_B, cpu_rows=R,
                       z_f64=_scaled_err(sol.z[:R], ref.z),
                       resid_f64=_scaled_err(sol.resids[:R], ref.resids,
                                             floor=1.0),
                       grads_f64={n: _scaled_err(g[:R], w) for n, g, w in
                                  zip("Q p G h A b".split(), grads,
                                      ref_grads)},
                       z_f32_card_vs_f64=_scaled_err(sol32.z[:R], ref.z),
                       z_f32_cpu_vs_f64=_scaled_err(ref32.z, ref.z),
                       resid_max=float(sol.resids.max()))
            row["f32_limit"] = F32_VS_F64_RATIO * row["z_f32_cpu_vs_f64"]
            log("QP layer", json.dumps(row))
            rows.append(row)
            ok = (bool(torch.isfinite(sol.z).all())
                  and row["z_f64"] <= QP_TOL and row["resid_f64"] <= QP_TOL
                  and max(row["grads_f64"].values()) <= QP_GRAD_TOL
                  and row["z_f32_card_vs_f64"] <= row["f32_limit"])
            if not ok:
                raise RuntimeError(f"QP layer card vs CPU: {row}")
    counts = read_launches()
    if any(counts.values()):
        raise RuntimeError(f"the QP layer launched kernels: {counts}")
    timing = prof_qp_sizes.measure(CARD, torch.float64)
    log("QP layer timing", json.dumps(timing))
    return dict(checks=rows, timing=timing)


def phase_sudoku():
    """The sudoku OptNet example through its entry point on the card, its
    full 200 iterations in float32: the loss halves (its own check), the
    held-out cell accuracy and ms per iteration printed; no kernel."""
    from diff_qp_mpc_tpu_torch.examples import sudoku_optnet

    reset_launches()
    out = sudoku_optnet.main(["--device", CARD])
    counts = read_launches()
    log("sudoku", json.dumps(dict(out, launches=counts)))
    if any(counts.values()) or not out["lossN"] < 0.5 * out["loss0"]:
        raise RuntimeError(f"sudoku: {out}, launches {counts}")
    return out


def _sl1qp_problem(env_name, env_kw, B, device, T_=None, terminal=True):
    """(env, cost, x0, bounds, u_init) of the expert planner's problem
    from the env's reset draw (seed 1), float64, on ``device``; without
    ``terminal`` the planner's terminal LQR P is left out."""
    from diff_qp_mpc_tpu_torch.core.types import Bounds
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import datagen

    env = make_env(env_name, **env_kw)
    planner = datagen.planner_settings(env)
    if T_ is not None:
        planner["T"] = T_
    if not terminal:
        planner.pop("terminal_lqr", None)
    kw = dict(dtype=torch.float64, device=device)
    cost = datagen.expert_cost(env, planner, B, torch.float64, device)
    x0 = env.reset(torch.Generator().manual_seed(1), B, **kw).x
    bounds = Bounds(u_lo=torch.as_tensor(env.action_space.low, **kw),
                    u_hi=torch.as_tensor(env.action_space.high, **kw))
    return env, cost, x0, bounds, torch.zeros(B, planner["T"], env.nu, **kw)


def _first_rows(cost, R, device):
    """The cost of the first R elements (a QuadCost or DiagQuadCost) on
    ``device``."""
    return type(cost)(**{f.name: getattr(cost, f.name)[:R].to(device)
                         for f in dataclasses.fields(cost)})


def _sl1qp_value_and_grad(env, cost, x0, bounds, u_init, cfg):
    """The differentiable SL1QP solve and the gradient of Σ x² + Σ u²
    w.r.t. the cost's linear term c and x0."""
    from diff_qp_mpc_tpu_torch.solvers import sl1qp_mpc

    c = cost.c.detach().clone().requires_grad_(True)
    x0 = x0.detach().clone().requires_grad_(True)
    res = sl1qp_mpc.solve(env.model, dataclasses.replace(cost, c=c), x0,
                          bounds, u_init, cfg=cfg)
    dc, dx0 = torch.autograd.grad((res.x ** 2).sum() + (res.u ** 2).sum(),
                                  (c, x0))
    return res, dc, dx0


def phase_sl1qp():
    """SL1QP MPC (riccati backend, SL1QPConfig's defaults) on cp2 stabilize
    (T 10, terminal LQR P, B 64) and the quadrotor hover (T 20, B 16):
    float64 card vs CPU on the first SL1QP_CPU_ROWS elements, the value
    and the gradient w.r.t. c and x0; ms per solve; slack_l1. Then the
    dense backend against the riccati backend on cp2 at T 5, B 64. The
    launch counts are set to 0 before and read after: no kernel."""
    from diff_qp_mpc_tpu_torch.solvers import sl1qp_mpc

    out = {}
    R = SL1QP_CPU_ROWS
    reset_launches()
    for name, env_name, env_kw, B in SL1QP_RUNS:
        env, cost, x0, bounds, u0 = _sl1qp_problem(env_name, env_kw, B,
                                                   CARD)
        cfg = sl1qp_mpc.SL1QPConfig()
        sync()
        t0 = time.perf_counter()
        res, dc, dx0 = _sl1qp_value_and_grad(env, cost, x0, bounds, u0, cfg)
        sync()
        seconds = time.perf_counter() - t0
        cpu = lambda a: a[:R].cpu()
        ref, ref_dc, ref_dx0 = _sl1qp_value_and_grad(
            env, _first_rows(cost, R, "cpu"), cpu(x0),
            type(bounds)(bounds.u_lo.cpu(), bounds.u_hi.cpu()), cpu(u0), cfg)
        row = dict(name=name, B=B, T=u0.shape[1], nx=env.nx, nu=env.nu,
                   s_per_solve_with_grad=seconds,
                   **{f"{k}_f64": _scaled_err(getattr(res, k)[:R],
                                              getattr(ref, k))
                      for k in ("x", "u", "cost")},
                   grad_c_f64=_scaled_err(dc[:R], ref_dc),
                   grad_x0_f64=_scaled_err(dx0[:R], ref_dx0),
                   slack_l1_max=float(res.slack_l1.max()),
                   slack_l1_median=float(res.slack_l1.median()),
                   tol=SL1QP_TOL)
        log("SL1QP", json.dumps(row))
        out[name] = row
        errs = [row[k] for k in ("x_f64", "u_f64", "cost_f64", "grad_c_f64",
                                 "grad_x0_f64")]
        if not (all(e <= SL1QP_TOL for e in errs)
                and bool(torch.isfinite(res.u).all())):
            raise RuntimeError(f"SL1QP card vs CPU: {row}")

    for terminal in (False, True):
        env, cost, x0, bounds, u0 = _sl1qp_problem(
            "cartpole2link", {"stabilization": True}, EPISODES, CARD,
            T_=SL1QP_DENSE_T, terminal=terminal)
        res, seconds = {}, {}
        for backend in ("riccati", "dense"):
            sync()
            t0 = time.perf_counter()
            res[backend] = sl1qp_mpc.solve(
                env.model, cost, x0, bounds, u0, differentiable=False,
                cfg=sl1qp_mpc.SL1QPConfig(backend=backend,
                                          **SL1QP_DENSE_CFG))
            sync()
            seconds[backend] = time.perf_counter() - t0
        du = (res["riccati"].u - res["dense"].u).abs()
        row = dict(T=SL1QP_DENSE_T, B=EPISODES, terminal_P=terminal,
                   gated=not terminal, max_abs_du=float(du.max()),
                   u_absmax=float(res["dense"].u.abs().max()),
                   within=bool((du <= 1e-3 + 1e-2 * res["dense"].u.abs())
                               .all()),
                   slack_l1_max={k: float(r.slack_l1.max())
                                 for k, r in res.items()},
                   s_per_solve=seconds)
        log("SL1QP riccati vs dense", json.dumps(row))
        out[f"riccati_vs_dense{' terminal P' if terminal else ''}"] = row
        if not terminal and not row["within"]:
            raise RuntimeError(f"SL1QP riccati vs dense: {row}")
    counts = read_launches()
    out["launches"] = counts
    log("SL1QP launches", json.dumps(counts))
    if any(counts.values()):
        raise RuntimeError(f"SL1QP launched kernels: {counts}")
    return out


def _slew_solve(kernel, dtype, prev, device=None, slew=SLEW_PENALTY,
                requires_grad=False):
    """sqp_mpc.solve with the slew penalty on k4_inputs' pendulum tracking
    problems (B 64), the ip checkpoint's budget, box ±3; returns the result
    and the (c, x0) it differentiates."""
    from diff_qp_mpc_tpu_torch.core.types import Bounds, QuadCost
    from diff_qp_mpc_tpu_torch.models import Pendulum
    from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

    device = device or CARD
    C, c, _, _, _, x0, x_ref, u_init = k4_inputs(EPISODES, dtype, seed=7,
                                                 device=device)
    c.requires_grad_(requires_grad)
    x0.requires_grad_(requires_grad)
    bounds = (Bounds(*IP_BOX) if kernel == "fused" else
              Bounds(*(torch.tensor(b, dtype=dtype, device=device)
                       for b in IP_BOX)))
    prev_ctrl = (torch.linspace(-1.0, 1.0, EPISODES, dtype=dtype,
                                device=device)[:, None] if prev else None)
    cfg = sqp_mpc.SQPConfig(qp_iter=SLEW_QP_ITER, qp=trajqp.TrajQPConfig(
        kernel=kernel, **IP_BUDGET))
    res = sqp_mpc.solve(Pendulum(), QuadCost(C=C, c=c), x0, bounds, u_init,
                        x_ref, cfg, slew_rate_penalty=slew,
                        prev_ctrl=prev_ctrl)
    return res, (c, x0)


def phase_slew():
    """The slew-rate option on the card: sqp_mpc.solve with s 50 on the
    pendulum's tracking problems, with and without prev_ctrl, scan (K3 at
    (5, 3, 1)) and fused (K4 at (5, 3, 1)), float32 and float64, B 64; the
    counts set to 0 before each solve and read after it, then before and
    after its backward: exactly SLEW_LAUNCHES and no other kernel, one K3
    backward launch; float64 u card vs CPU within SLEW_TOL; the slew energy
    criterion. K3 and K4 at (5, 3, 1) are held against their plain
    versions on the solves' own systems (recorded; float32 by the ratio
    rule) and on random problems, and timed."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda, trajqp_fused_cuda

    T_, nx, nu = SLEW_SHAPE
    reg = IP_BUDGET["reg"]
    out = dict(runs=[], launches={"K3": 0, "K4": 0})
    for kernel in ("scan", "fused"):
        kid, per_solve = SLEW_LAUNCHES[kernel]
        for dtype in (torch.float32, torch.float64):
            for prev in (False, True):
                reset_launches()
                t0 = time.perf_counter()
                res, (c, x0) = _slew_solve(kernel, dtype, prev,
                                           requires_grad=True)
                sync()
                ms = 1e3 * (time.perf_counter() - t0)
                fwd = read_launches()
                reset_launches()
                (res.u ** 2).sum().backward()
                bwd = read_launches()
                row = dict(kernel=kernel, dtype=str(dtype), prev_ctrl=prev,
                           ms_per_solve=ms, launches=fwd,
                           backward_launches=bwd)
                if dtype == torch.float64:
                    ref, _ = _slew_solve(kernel, dtype, prev, device="cpu")
                    row["u_card_vs_cpu"] = float(
                        (res.u.detach().cpu() - ref.u).abs().max())
                log("slew", json.dumps(row))
                out["runs"].append(row)
                out["launches"][kid] += fwd[kid]
                out["launches"]["K3"] += bwd["K3"]
                others = {k: v for k, v in fwd.items() if k != kid and v}
                bad_bwd = {k: v for k, v in bwd.items()
                           if v != (1 if k == "K3" else 0)}
                if (fwd[kid] != per_solve or others or bad_bwd
                        or row.get("u_card_vs_cpu", 0.0) > SLEW_TOL
                        or not bool(torch.isfinite(res.u).all())):
                    raise RuntimeError(f"slew solve: {row}, expected "
                                       f"{per_solve} {kid} launches and "
                                       f"one K3 in the backward")

    energy = lambda u: float(((u[:, 1:] - u[:, :-1]) ** 2).sum())
    plain, _ = _slew_solve("scan", torch.float64, False, slew=None)
    slew, _ = _slew_solve("scan", torch.float64, False)
    out["energy"] = dict(slew=energy(slew.u), unpenalized=energy(plain.u),
                         ratio=energy(slew.u) / energy(plain.u),
                         limit=SLEW_ENERGY_RATIO)
    log("slew energy", json.dumps(out["energy"]))
    if not out["energy"]["ratio"] < SLEW_ENERGY_RATIO:
        raise RuntimeError(f"slew energy: {out['energy']}")

    # K3 and K4 at (5, 3, 1) on the slew solves' own systems and QPs
    with recording(riccati_cuda, "batched_lqr_kkt_solve") as k3_calls:
        with torch.no_grad():
            _slew_solve("scan", torch.float32, True)
    with recording(trajqp_fused_cuda, "fused_trajqp_solve") as k4_calls:
        with torch.no_grad():
            _slew_solve("fused", torch.float32, True)
    checks = {"K3 slew systems": [], "K4 slew QPs": [], "K3 random": [],
              "K4 random": []}
    for args, _ in k3_calls[::24] + k3_calls[23::24]:
        for dtype in (torch.float32, torch.float64):
            checks["K3 slew systems"].append(k3_check(
                [a.to(dtype) for a in args[:9]], args[9], ratio=True))
    for args, kw in k4_calls:
        checks["K4 slew QPs"].append(k4_check(args, kw, ratio=True))
    for dtype in (torch.float32, torch.float64):
        for B in (EPISODES, 256):
            checks["K3 random"].append(k3_check(
                lqr_problem(B, T_, nx, nu, dtype, seed=B + 3, device=CARD),
                reg))
            arrays, box = prof.problem(B, T_, nx, nu, dtype, device=CARD)
            arrays = (*arrays, *prof.cold_start(*arrays))
            checks["K4 random"].append(k4_check(
                arrays, dict(IP_BUDGET, u_lo=box.u_lo, u_hi=box.u_hi)))
    for key, rows in checks.items():
        log(f"slew {key}", json.dumps(dict(checks=len(rows), worst=max(
            rows, key=_check_err))))
    out["checks"] = checks

    args = lqr_problem(EPISODES, T_, nx, nu, torch.float32, seed=EPISODES,
                       device=CARD)
    out["K3 timing"] = k3_timing(args, reg)
    out["K3 timing"]["max_abs_err"] = _max_errs(
        riccati_cuda.batched_lqr_kkt_solve(*args, reg),
        _plain_k3(args, reg))[0]
    arrays, box = prof.problem(EPISODES, T_, nx, nu, torch.float32,
                               device=CARD)
    arrays = (*arrays, *prof.cold_start(*arrays))
    bounds = (box.u_lo, box.u_hi)
    kern = lambda: trajqp_fused_cuda.fused_trajqp_solve(*arrays, *bounds,
                                                        **IP_BUDGET)
    t = dict(B=EPISODES, ms=queued_events_ms(kern, 10),
             plain_ms=events_ms(
                 lambda: trajqp_fused_cuda.fused_trajqp_solve_reference(
                     *arrays, *bounds, **IP_BUDGET), 3, warmup=1),
             library_ms=None)
    t["bound_ms"], t["bound_by"] = bound(
        EPISODES * k4_bytes(T_, nx, nu),
        EPISODES * k4_ops(T_, nx, nu, IP_BUDGET["max_iter"]))
    t["max_abs_err"] = _max_errs(
        kern(), trajqp_fused_cuda.fused_trajqp_solve_reference(
            *arrays, *bounds, **IP_BUDGET))[0]
    out["K4 timing"] = t
    log("slew K3 timing", json.dumps(out["K3 timing"]))
    log("slew K4 timing", json.dumps(t))
    return out


def slew_kernel_rows(slew):
    """The kernels line's rows of K3 and K4 at (5, 3, 1): ms, plain,
    library (K3: the dense KKT's torch.linalg.solve; K4: none) and bound
    in float32 at B 64, the largest errors of their checks, and the
    launches of the slew phase's solves and backwards."""
    T_, nx, nu = SLEW_SHAPE
    k3, k4 = slew["K3 timing"], slew["K4 timing"]
    ch = slew["checks"]
    k3_rows = ch["K3 slew systems"] + ch["K3 random"]
    err = lambda rows, dtype: max(_check_err(r) for r in rows
                                  if r["dtype"] == dtype)
    shape = f"B={EPISODES} T={T_} nx={nx} nu={nu} float32"
    return [
        {"name": "riccati (K3) at the slew-augmented pendulum's shape",
         "route": "cuda", "source": "diff_qp_mpc_tpu_torch/csrc/riccati.cu",
         "replaces": "diff_qp_mpc_tpu/ops/riccati_pallas.py:219",
         "launches": slew["launches"]["K3"],
         "max_abs_err": k3["max_abs_err"],
         "checks_max_rel_err_float32": err(k3_rows, "torch.float32"),
         "checks_max_rel_err_float64": err(k3_rows, "torch.float64"),
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": k3["library_ms"], "shape": shape},
        {"name": "trajqp_fused (K4) at the slew-augmented pendulum's shape",
         "route": "cuda",
         "source": "diff_qp_mpc_tpu_torch/csrc/trajqp_fused.cu",
         "replaces": "diff_qp_mpc_tpu/ops/trajqp_fused_pallas.py:308",
         "launches": slew["launches"]["K4"],
         "max_abs_err": k4["max_abs_err"],
         "checks_max_scaled_err_float32": err(ch["K4 random"],
                                              "torch.float32"),
         "checks_max_scaled_err_float64": err(ch["K4 random"],
                                              "torch.float64"),
         "slew_qps_kernel_vs_f64": err(ch["K4 slew QPs"], "torch.float32"),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None, "shape": shape}]


# -------------------------------------------------------- the RL experts --
def _upright_share(env, trajs, radius):
    """The share of trajectories whose last state is within ``radius`` of
    upright: the pendulum's θ, or the cartpole's pole angle from π."""
    from diff_qp_mpc_tpu_torch.models import angle_normalize

    finals = torch.tensor(np.array([t[-1][0] for t in trajs]),
                          dtype=torch.float64)
    err = (angle_normalize(finals[:, 0]) if env.nq == 1
           else angle_normalize(finals[:, 1] - np.pi))
    return float((err.abs() < radius).double().mean())


def _actor_actions_f64(env, path, init, device):
    """The CGAC actor's float64 actions over RL_CHECK_STEPS closed-loop
    steps from ``init`` on ``device`` [steps, B, nu], on the CPU."""
    from diff_qp_mpc_tpu_torch.envs import EnvState
    from diff_qp_mpc_tpu_torch.learning import rl

    actor, m, v = rl.load_cgac_actor(path, device=device, dtype=torch.float64)
    act = rl.actor_act_fn(env, actor, m, v)
    state, us = EnvState.make(init.to(device)), []
    for _ in range(RL_CHECK_STEPS):
        us.append(act(state.x))
        state, _, _ = env.step(state, us[-1])
    return torch.stack(us).cpu()


def rl_actors():
    """The committed CGAC actors on the card: RL_ROLLOUTS rollouts each,
    gated on RL_ACTORS' least upright share; float64 actions card vs CPU;
    the pendulum's pickle written under RL_DIR. Returns the rows and the
    pickle's path."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import rl
    from diff_qp_mpc_tpu_torch.learning.data import save_expert_pickle

    rows, pickle_path = {}, None
    for env_name, path, radius, least in RL_ACTORS:
        env = make_env(env_name)
        actor, m, v = rl.load_cgac_actor(path, device=CARD)
        sync()
        t0 = time.perf_counter()
        trajs = rl.sac_expert_rollouts(env, rl.actor_act_fn(env, actor, m, v),
                                       RL_ROLLOUTS, device=CARD)
        seconds = time.perf_counter() - t0
        steps = max(len(t) for t in trajs)
        init = env.reset(torch.Generator().manual_seed(0), RL_ROLLOUTS,
                         dtype=torch.float64).x
        err = _scaled_err(_actor_actions_f64(env, path, init, CARD),
                          _actor_actions_f64(env, path, init, "cpu"))
        row = dict(env=env_name, ckpt=path, rollouts=RL_ROLLOUTS,
                   steps=steps, seconds=seconds,
                   ms_per_step=1e3 * seconds / steps,
                   mean_len=float(np.mean([len(t) for t in trajs])),
                   upright_share=_upright_share(env, trajs, radius),
                   radius=radius, least_share=least,
                   pickle_criterion=RL_PICKLE_CRITERION[env_name],
                   actions_f64_card_vs_cpu=err, tol=RL_TOL)
        log("rl actor", json.dumps(row))
        rows[env_name] = row
        if not (row["upright_share"] > least and err <= RL_TOL):
            raise RuntimeError(f"RL actor {env_name}: {row}")
        if env_name == "pendulum":
            pickle_path = os.path.join(
                RL_DIR, f"expert_traj_cgac-{env.spec_id}_new.pkl")
            save_expert_pickle(pickle_path, trajs)
    return rows, pickle_path


def _update_card_vs_cpu(algo_cls, cfg):
    """One grad_update in float64 on the card and on the CPU from the same
    state (seeded, warmed up on the CPU) and draws: the largest error over
    the losses, the networks' parameters and log α, each over its largest
    entry."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import rl

    env, f64 = make_env("pendulum"), torch.float64
    cpu = algo_cls(env, cfg, dtype=f64, device="cpu")
    card = algo_cls(env, cfg, dtype=f64, device=CARD)
    draws = rl.Draws(1, "cpu")
    st = cpu.init_state(1, draws)
    cpu.warmup(st, draws)
    st_card = rl.state_to(st, CARD)
    B, nu = cfg.batch_size, env.nu
    idx = draws.randint(cpu.batch_high(st), B)
    eps = (draws.normal((B, nu), f64), draws.normal((B, nu), f64))
    got = card.grad_update(st_card, idx.to(CARD), *(e.to(CARD) for e in eps))
    want = cpu.grad_update(st, idx, *eps)
    pairs = list(zip(got, want)) + [(st_card.log_alpha, st.log_alpha)]
    for name in ("actor", "q", "q_targ"):
        pairs += list(zip(getattr(st_card, name).parameters(),
                          getattr(st, name).parameters()))
    return max(_scaled_err(g, w, 1e-30) for g, w in pairs)


def _train_blocks(algo, n_blocks):
    """The trainer's state from seed 0 on the card, its warmup, then
    ``n_blocks`` blocks, each timed on the host clock after a sync."""
    from diff_qp_mpc_tpu_torch.learning import rl

    draws = rl.Draws(0, CARD)
    st = algo.init_state(0, draws)
    sync()
    t0 = time.perf_counter()
    algo.warmup(st, draws)
    sync()
    row = dict(warmup_s=time.perf_counter() - t0,
               warmup_env_steps=algo.warmup_steps(), ms_per_block=[])
    after_warmup = dict(
        filled=getattr(st, "filled", None), size=getattr(st, "size", None),
        ptr=getattr(st, "ptr", None),
        obs_mean=st.obs_mean.tolist(), obs_var=st.obs_var.tolist(),
        obs_count=float(st.obs_count))
    cfg = algo.cfg
    for _ in range(n_blocks):
        t0 = time.perf_counter()
        mean_r, q_loss, a_loss = algo.train_block(st, draws)
        sync()
        row["ms_per_block"].append(1e3 * (time.perf_counter() - t0))
        if not all(bool(torch.isfinite(v).all())
                   for v in (mean_r, q_loss, a_loss)):
            raise RuntimeError(f"non-finite RL losses: {q_loss}, {a_loss}")
    updates = cfg.block * cfg.updates_per_iter
    row.update(updates_per_block=updates,
               ms_per_update=[ms / updates for ms in row["ms_per_block"]],
               q_loss_last=float(q_loss[-1]), a_loss_last=float(a_loss[-1]),
               step_r_last=float(mean_r[-1]),
               alpha=float(torch.exp(st.log_alpha.detach())),
               after_warmup=after_warmup)
    return row


def rl_sac_cgac():
    """SAC and CGAC on the card at their default configurations (see
    RL_SAC_BLOCKS), ms per block and per update; SAC's buffer and
    statistics after the warmup exactly as its configuration gives them;
    one float64 update card vs CPU each."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import rl

    env = make_env("pendulum")
    out = {}
    for name, cls, cfg, blocks in (
            ("sac", rl.SAC, rl.SACConfig(), RL_SAC_BLOCKS),
            ("cgac", rl.CGAC, rl.CGACConfig(), 1)):
        row = _train_blocks(cls(env, cfg, device=CARD), blocks)
        row["update_f64_card_vs_cpu"] = _update_card_vs_cpu(cls, cfg)
        row["tol"] = RL_TOL
        log(f"rl {name}", json.dumps(row))
        out[name] = row
        w = row["after_warmup"]
        if name == "sac":
            n = max(1, cfg.warmup_steps // cfg.n_envs) * cfg.n_envs
            exact = (w["size"] == w["ptr"] == n
                     and w["obs_mean"] == [0.0] * env.nx
                     and w["obs_var"] == [1.0] * env.nx
                     and w["obs_count"] == float(np.float32(1e-4)))
        else:
            exact = w["filled"] == min(cfg.warmup_steps, cfg.window)
        if not (exact and row["update_f64_card_vs_cpu"] <= RL_TOL):
            raise RuntimeError(f"RL {name}: {row}")
    return out


def rl_ppo():
    """PPO on the card at PPOConfig's defaults for RL_PPO_ITERS iterations
    (ms each), and one float64 update (its epochs × minibatches steps)
    card vs CPU on the same CPU rollout and permutations."""
    import copy

    from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
    from diff_qp_mpc_tpu_torch.learning import rl
    from diff_qp_mpc_tpu_torch.learning.optim import Adam

    env, cfg = make_env("pendulum"), rl.PPOConfig()
    ppo = rl.PPO(env, cfg, device=CARD)
    draws = rl.Draws(0, CARD)
    net, opt = ppo.init(0)
    env_state = EnvState.make(draws.fresh(env, (1, cfg.n_envs),
                                          torch.float32)[0])
    ms, losses = [], []
    for _ in range(RL_PPO_ITERS):
        sync()
        t0 = time.perf_counter()
        env_state, loss, mean_r = ppo.iteration(net, opt, env_state, draws)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(loss))

    f64 = torch.float64
    cpu = rl.PPO(env, cfg, dtype=f64, device="cpu")
    card = rl.PPO(env, cfg, dtype=f64, device=CARD)
    d = rl.Draws(1, "cpu")
    net_c, opt_c = cpu.init(1)
    L, n = cfg.rollout_len, cfg.n_envs
    es = EnvState.make(d.fresh(env, (1, n), f64)[0])
    _, traj, last_v = cpu.collect(net_c, es, d.normal((L, n, env.nu), f64),
                                  d.fresh(env, (L, n), f64))
    advs, returns = cpu.gae(traj, last_v)
    perms = torch.stack([d.permutation(L * n) for _ in range(cfg.epochs)])
    net_g = copy.deepcopy(net_c).to(CARD)
    opt_g = Adam(dict(net_g.named_parameters()), cfg.lr)
    to = lambda a: a.to(CARD)
    loss_g = card.update(net_g, opt_g, rl.Transition(*map(to, traj)),
                         to(advs), to(returns), to(perms))
    loss_c = cpu.update(net_c, opt_c, traj, advs, returns, perms)
    err = max(_scaled_err(g, w, 1e-30) for g, w in [(loss_g, loss_c)] + list(
        zip(net_g.parameters(), net_c.parameters())))
    row = dict(ms_per_iteration=ms, loss=losses, n_envs=n, rollout_len=L,
               update_steps=cfg.epochs * cfg.minibatches,
               update_f64_card_vs_cpu=err, tol=RL_TOL)
    log("rl ppo", json.dumps(row))
    if not (np.isfinite(losses).all() and err <= RL_TOL):
        raise RuntimeError(f"RL PPO: {row}")
    return row


def rl_datagen():
    """``datagen --expert sac`` on the card, cut (RL_DATAGEN_ARGV): a
    pickle that learning.data reads, and no kernel launched."""
    from diff_qp_mpc_tpu_torch.learning import data, datagen

    out = os.path.join(RL_DIR, "expert_traj_sac-Pendulum-v0_new.pkl")
    reset_launches()
    t0 = time.perf_counter()
    trajs = datagen.main(RL_DATAGEN_ARGV
                         + ["--out", out, "--device", CARD])
    seconds = time.perf_counter() - t0
    counts = read_launches()
    loaded = data.load_expert_pickle(out)
    row = dict(argv=RL_DATAGEN_ARGV, seconds=seconds, trajectories=len(trajs),
               steps=int(loaded["state"].shape[0]), launches=counts)
    log("rl datagen", json.dumps(row))
    if not (len(trajs) == 16 and loaded["state"].shape[1:] == (2,)
            and np.isfinite(loaded["state"]).all() and not any(
                counts.values())):
        raise RuntimeError(f"RL datagen: {row}")
    return row


def phase_rl():
    """The RL experts (see the module docstring, phase 20)."""
    os.makedirs(RL_DIR, exist_ok=True)
    actors, pickle_path = rl_actors()
    out = dict(actors=actors, **rl_sac_cgac(), ppo=rl_ppo(),
               datagen=rl_datagen())
    out["train"] = phase_model_train("rl-cgac", TRAIN_META,
                                     RL_TRAIN_PRETRAIN, RL_TRAIN_DEQMPC,
                                     data=pickle_path)
    return out


# ------------------------------------------ the rest of the DEQ family --
def _flat_grad(loss, module):
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
        loss, list(module.parameters()))]).double().cpu()


def _pendulum_batch(B):
    """A window batch of the main path's expert data, numpy."""
    from diff_qp_mpc_tpu_torch.learning import data

    return data.sample_window_batch(data.load_expert_pickle(DATA), B, T,
                                    np.random.RandomState(0),
                                    use_native=False)


def _seeded(make):
    """A factory of ``make()``'s module with the weights of seed 0 (flax's
    initial distributions)."""
    torch.manual_seed(0)
    state = make().state_dict()

    def factory():
        module = make()
        module.load_state_dict(state)
        return module

    return factory


def deq_conv():
    """(a) DEQ-MPC with the conv cell through the train entry point, its
    checkpoint closed-loop through the evaluate entry point, and the
    float64 forward and training gradient card vs CPU."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate

    steps = DEQ_TRAIN_PRETRAIN + DEQ_TRAIN_DEQMPC
    train_row = phase_model_train(
        "conv-fused", TRAIN_META, DEQ_TRAIN_PRETRAIN, DEQ_TRAIN_DEQMPC,
        data=DATA, extra=["--layer_type", "conv"], ckpt_every=steps - 1)
    ckpt = os.path.join(TRAIN_LOGDIR, "conv-fused", "ckpt.msgpack")
    loop = closed_loops(
        [("conv-fused", ["--ckpt", ckpt, "--fused", "--episodes",
                         str(EPISODES), "--max_steps", str(DEQ_LOOP_STEPS)],
          "K2", LAUNCHES_PER_STEP["fused"][1], None)],
        "deq conv main_path")["conv-fused"]
    args = evaluate.parse_args(["--ckpt", ckpt, "--fused", "--data", DATA])
    env = make_env(args.env)
    if args.layer_type != "conv":
        raise RuntimeError(f"the conv checkpoint's meta: {args}")
    state = make_policy_from(args, env, ckpt).state_dict()

    def factory():
        from diff_qp_mpc_tpu_torch.learning.train import make_policy

        policy = make_policy(args, env)
        policy.load_state_dict(state)
        return policy

    cases = [("conv-fused", args, env, factory)]
    phase_model_policy(cases=cases)
    grad = phase_model_train_grad(cases=cases)["conv-fused"]
    return dict(train=train_row, closed_loop=loop, grad=grad)


def deq_nnmpc():
    """(b) NNMPCPolicy on the main path's fused tracker at B DEQ_B: the
    launch counts set to 0 before each call and read after its forward
    and its backward (the BC loss on a batch of expert data), exactly 1 K2
    and then 1 K1; ms per call; float64 actions and gradient card vs CPU
    at B GRAD_B."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import losses, train
    from diff_qp_mpc_tpu_torch.learning.policies import NNMPCPolicy

    args = train.build_parser().parse_args(meta_argv() + ["--fused"])
    env = make_env(args.env)
    tracking = train.make_policy(args, env).tracking
    factory = _seeded(lambda: NNMPCPolicy(env.nx, env.nu, env.nq, args.T,
                                          args.hdim, tracking))

    def loss_of(policy, batch):
        s, a = policy(batch["state"][:, 0])
        return losses.compute_loss_bc(2, batch["state"], batch["action"],
                                      batch["mask"], s, a)[0], a

    policy = factory().to(CARD)
    batch = train.to_batch(_pendulum_batch(DEQ_B), CARD, torch.float32)
    want = {k: 0 for k in kernel_wrappers()}
    totals, ms = dict(want), []
    for _ in range(DEQ_CALLS):
        sync()
        t0 = time.perf_counter()
        reset_launches()
        loss, _ = loss_of(policy, batch)
        fwd = read_launches()
        _flat_grad(loss, policy)
        back = read_launches()
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
        if fwd != dict(want, K2=1) or back != dict(want, K2=1, K1=1):
            raise RuntimeError(f"NNMPCPolicy launches: forward {fwd}, "
                               f"with its backward {back}")
        totals = {k: totals[k] + back[k] for k in totals}
    small = _pendulum_batch(GRAD_B)
    out = {}
    for device in ("cpu", CARD):
        p = factory().to(device=device, dtype=torch.float64)
        loss, acts = loss_of(p, train.to_batch(small, device, torch.float64))
        out[device] = (acts.detach().double().cpu(), _flat_grad(loss, p))
    row = dict(B=DEQ_B, calls=DEQ_CALLS, ms_per_call=ms,
               launches_total=totals,
               actions_rel_err_f64=_rel_err(out[CARD][0], out["cpu"][0]),
               grad_rel_err_f64=_rel_err(out[CARD][1], out["cpu"][1]),
               tol=GRAD_TOL)
    log("deq nnmpc", json.dumps(row))
    if not max(row["actions_rel_err_f64"],
               row["grad_rel_err_f64"]) <= GRAD_TOL:
        raise RuntimeError(f"NNMPCPolicy on the card disagrees with the "
                           f"CPU: {row}")
    return row


def deq_policy():
    """(c) DEQPolicy at B DEQ_B, hdim 128: no kernel launched over its
    forward and backward, ms per call, Anderson's residual history on the
    card; float64 forward and gradient card vs CPU within DEQ_NET_TOL."""
    from diff_qp_mpc_tpu_torch.learning import deq, losses
    from diff_qp_mpc_tpu_torch.learning.train import to_batch

    factory = _seeded(lambda: deq.DEQPolicy(nx=NX, T=T, hdim=128))
    batch = _pendulum_batch(DEQ_B)

    def loss_of(policy, b):
        out = policy(b["state"][:, 0])
        return losses.iterate_loss(1, b["state"], b["action"], b["mask"],
                                   out, None), out

    policy = factory().to(CARD)
    card_batch = to_batch(batch, CARD, torch.float32)
    ms = []
    reset_launches()
    for _ in range(DEQ_CALLS):
        sync()
        t0 = time.perf_counter()
        loss, _ = loss_of(policy, card_batch)
        _flat_grad(loss, policy)
        sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    counts = read_launches()
    x = card_batch["state"][:, 0]
    with torch.no_grad():
        xinp = policy.inp_ln(policy.inp(x))
        _, res_hist = deq.anderson(lambda z: policy.cell(xinp, z),
                                   policy.init_z(x),
                                   max_iter=policy.fwd_iter)
    out = {}
    for device in ("cpu", CARD):
        p = factory().to(device=device, dtype=torch.float64)
        loss, fwd = loss_of(p, to_batch(batch, device, torch.float64))
        out[device] = (fwd.detach().cpu(), _flat_grad(loss, p))
    row = dict(B=DEQ_B, hdim=128, calls=DEQ_CALLS, ms_per_call=ms,
               launches=counts, anderson_residuals_f32=res_hist.tolist(),
               forward_rel_err_f64=_rel_err(out[CARD][0], out["cpu"][0]),
               grad_rel_err_f64=_rel_err(out[CARD][1], out["cpu"][1]),
               tol=DEQ_NET_TOL)
    log("deq policy", json.dumps(row))
    if any(counts.values()) or not max(
            row["forward_rel_err_f64"],
            row["grad_rel_err_f64"]) <= DEQ_NET_TOL:
        raise RuntimeError(f"DEQPolicy: {row}")
    return row


def deq_bc():
    """(d) the BC baseline through the train entry point (no --deq), no
    kernel launched at any step; its checkpoint closed-loop through the
    evaluate entry point, no kernel launched; the float64 BC loss and
    gradient card vs CPU within DEQ_NET_TOL."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate, train

    argv = [a for a in meta_argv() if a not in ("--deq", "--qp_solve",
                                                 "--pretrain")] + [
        "--data", DATA, "--logdir", TRAIN_LOGDIR, "--save", "--iters",
        str(DEQ_BC_STEPS), "--ckpt_every", str(DEQ_BC_STEPS - 1),
        "--name", "bc"]
    records, trace = train_run("bc", argv, TRACED_TRAIN_STEPS["bc"])
    ckpt = os.path.join(TRAIN_LOGDIR, "bc", "ckpt.msgpack")
    reset_launches()
    loop = evaluate.main(["--ckpt", ckpt, "--episodes", str(EPISODES),
                          "--max_steps", str(DEQ_LOOP_STEPS)])
    loop["launches"] = read_launches()
    args = evaluate.parse_args(["--ckpt", ckpt])
    env = make_env(args.env)
    batch = _pendulum_batch(GRAD_B)
    out = {}
    for device in ("cpu", CARD):
        p = make_policy_from(args, env, ckpt).to(device=device,
                                                 dtype=torch.float64)
        loss, _, _ = train.compute_loss(p, args, train.to_batch(
            batch, device, torch.float64), False, torch.Generator())
        out[device] = (loss.detach().cpu().reshape(1), _flat_grad(loss, p))
    row = dict(steps=len(records), modes=sorted({r["mode"] for r in records}),
               ms_per_step_median=float(np.median(
                   [r["ms"] for r in records[1:-1]])),
               loss_first=records[0]["loss"], loss_last=records[-1]["loss"],
               launches_total={k: sum(r["launches"][k] for r in records)
                               for k in records[0]["launches"]},
               closed_loop=loop,
               loss_rel_err_f64=_rel_err(out[CARD][0], out["cpu"][0]),
               grad_rel_err_f64=_rel_err(out[CARD][1], out["cpu"][1]),
               tol=DEQ_NET_TOL, **trace)
    log("deq bc", json.dumps(row))
    if not (row["modes"] == ["bc"] and args.deq is False
            and not any(loop["launches"].values())
            and np.isfinite(loop["mean_reward"])
            and max(row["loss_rel_err_f64"],
                    row["grad_rel_err_f64"]) <= DEQ_NET_TOL):
        raise RuntimeError(f"BC baseline: {row}")
    return row


def phase_deq_family():
    """The rest of the DEQ network family (see the module docstring, phase
    21). Returns the rows and the K1/K2 launches of the runs that make
    them (the conv training and closed loop, NNMPCPolicy's calls)."""
    out = dict(conv=deq_conv(), nnmpc=deq_nnmpc(), deq_policy=deq_policy(),
               bc=deq_bc())
    by_run = {"conv-fused training": out["conv"]["train"]["launches_total"],
              "conv-fused closed loop": out["conv"]["closed_loop"][
                  "launches"],
              "NNMPCPolicy calls": out["nnmpc"]["launches_total"]}
    out["launches_total"] = {k: sum(r[k] for r in by_run.values())
                             for k in kernel_wrappers()}
    out["launches_by_run"] = {run: {k: v for k, v in counts.items() if v}
                              for run, counts in by_run.items()}
    return out


def k3_by_shape(k3_horizon, cp2_qps, cp2_runs, training, experts):
    """The kernels line's K3 rows per new (T, nx, nu): the kernel that
    serves it and its source, float32 ms at B 64 with plain, library (the
    dense KKT's torch.linalg.solve) and bound, the largest error per dtype
    of the random-problem checks (float32 against the float64 solution
    over long horizons), and the launches of the runs that take it."""
    runs_at = {"T5 nx6 nu1": [("cp2-ip-scan closed loop", cp2_runs[
                   "cp2-ip-scan"]["launches"]["K3"]),
                   ("cp2-ip-fused training", training["cp2-ip-fused"][
                       "launches_total"]["K3"])],
               "T10 nx6 nu1": [("cp2-stabilize expert", experts[
                   "cp2-stabilize"]["launches_total"]["K3h"])],
               "T20 nx12 nu4": [("quadrotor expert", experts["quadrotor"][
                   "launches_total"]["K3h"])],
               "T60 nx4 nu1": [("cp1 DAgger relabeling", experts["dagger"][
                   "launches_total"]["K3h"])]}
    out = {}
    for key, row in k3_horizon.items():
        checks = row["checks"]
        entry = {k: row[k] for k in ("kernel", "ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "library_max_rel_err")}
        entry["source"] = ("diff_qp_mpc_tpu_torch/csrc/riccati.cu"
                           if row["kernel"] == "riccati" else
                           "diff_qp_mpc_tpu_torch/csrc/riccati_horizon.cu")
        for dtype in ("torch.float32", "torch.float64"):
            mine = [c for c in checks if c["dtype"] == dtype]
            entry[f"max_rel_err_{dtype[6:]}"] = max(
                c.get("kernel_vs_f64", c["max_rel_err"]) for c in mine)
        if "horizon_kernel" in row:
            entry["horizon_kernel_ms"] = row["horizon_kernel"]["ms"]
        entry["launches"] = sum(n for _, n in runs_at.get(key, []))
        entry["launches_by_run"] = dict(runs_at.get(key, []))
        out[key] = entry
    worst = lambda rows: max(r.get("kernel_vs_f64", r["max_rel_err"])
                             for r in rows if r["dtype"] == "torch.float32")
    out["T5 nx6 nu1"]["checkpoint_systems_max_rel_err_f32_vs_f64"] = worst(
        cp2_qps["K3 checkpoint systems"])
    out["T10 nx6 nu1"]["expert_systems_max_rel_err_f32_vs_f64"] = worst(
        cp2_qps["K3 expert systems"])
    return out


def k4_by_shape(cp2_qps, cp2_runs, training):
    """The kernels line's K4 row at (5, 6, 1): float32 ms at B 64 with
    plain and bound, the errors of the random-QP and checkpoint-QP checks,
    and the launches of the cp2 ip checkpoint's fused runs."""
    t = cp2_qps["timing"]
    rand = cp2_qps["K4 random"]
    ckpt = cp2_qps["K4 checkpoint QPs"]
    closed = cp2_runs["cp2-ip-fused"]["launches"]["K4"]
    trained = training["cp2-ip-fused"]["launches_total"]["K4"]
    return {"T5 nx6 nu1": dict(
        {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")},
        max_scaled_err_float32=max(max(r["scaled_err"].values())
                                   for r in rand
                                   if r["dtype"] == "torch.float32"),
        max_scaled_err_float64=max(max(r["scaled_err"].values())
                                   for r in rand
                                   if r["dtype"] == "torch.float64"),
        checkpoint_qps_kernel_vs_f64=max(max(r["kernel_vs_f64"].values())
                                         for r in ckpt),
        checkpoint_qps_plain_vs_f64=max(max(r["plain_vs_f64"].values())
                                        for r in ckpt),
        launches=closed + trained,
        launches_by_run={"cp2-ip-fused closed loop": closed,
                         "cp2-ip-fused training": trained})}


def ptxas_summary(text):
    """One line per kernel and device function of an nvcc -Xptxas -v log:
    its name (cut), registers (kernels only), stack frame and spill
    stores."""
    rows, name = [], None
    for line in text.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name and "stack frame" in line:
            rows.append(dict(
                name=name[:110], regs="-",
                stack=line.split(" bytes stack frame")[0].split()[-1],
                spill=line.split(" bytes spill stores")[0].split()[-1]))
        elif name and "Used" in line and "registers" in line and rows:
            rows[-1]["regs"] = line.split("Used")[1].split(
                "registers")[0].strip()
            name = None
    return [f"{r['name']} {r['regs']} registers, {r['stack']} B stack, "
            f"{r['spill']} B spill stores" for r in rows]


def k2_by_model(k2_models, model_runs, training):
    """The kernels line's K2 rows per new (model, T): float32 ms, plain ms
    and bound at B 64 (and the ms at each other timed B), the largest error
    against the plain version at B 64 per dtype, and the launches of the
    main-path run (and the training run) that takes the instantiation."""
    runs_of = {v: k for k, v in MODEL_RUN_KERNEL.items()}
    out = {}
    for key, rows in k2_models.items():
        name, t_, dtype = key.split()
        entry = out.setdefault(f"{name} {t_}", dict(launches=0))
        for r in rows:
            if "ms" in r and r["B"] == EPISODES:
                entry.update({k: r[k] for k in (
                    "ms", "ms_events", "plain_ms", "bound_ms", "bound_by",
                    "group")})
            elif "ms" in r:
                entry[f"ms_B{r['B']}"] = r["ms"]
                entry[f"bound_ms_B{r['B']}"] = r["bound_ms"]
            elif r["B"] == EPISODES:
                entry[f"max_abs_err_{dtype}"] = r["max_abs_err_xu"]
                entry[f"tolerance_{dtype}"] = r["tol"]
        run = runs_of.get(key)
        if run is not None:
            entry["launches"] = model_runs[run]["launches"]["K2"]
            entry["launches_run"] = run
            if run in training:
                entry["launches_training"] = \
                    training[run]["launches_total"]["K2"]
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    from diff_qp_mpc_tpu_torch.utils import cuda_build
    from diff_qp_mpc_tpu_torch.utils.device import card_name_and_power_limit

    from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

    t0 = time.perf_counter()
    logs = cuda_build.build(["btsolve", *al_fused_cuda.LIBRARIES, "riccati",
                             "riccati_horizon", "trajqp_fused",
                             "sin_chain"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log("build seconds by source", json.dumps(cuda_build.build_seconds))
    for name, text in logs.items():
        for line in ptxas_summary(text):
            log(f"ptxas {name}: {line}")

    # the port (its __init__) turns TF32 off: the float32 products of the
    # linearization, the costs and the IPM residuals run in full float32,
    # as the JAX package pins Precision.HIGHEST on them
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: the port's float32 products must "
                           "run in full float32")
    k1 = timed("K1", phase_k1)
    k2 = timed("K2", phase_k2)
    k1_models = timed("K1 models", phase_k1_models)
    k2_models = timed("K2 models", phase_k2_models)
    k3 = timed("K3", phase_k3)
    k4 = timed("K4", phase_k4)
    k5 = timed("K5", phase_k5)
    timed("policy", phase_policy)
    runs = timed("main path", phase_main_path)
    timed("model policy", phase_model_policy)
    model_runs = timed("model main path", phase_model_main_path)
    roof = timed("roofline", phase_roofline)
    timed("K1 AL systems", phase_k1_al)
    timed("train grad", phase_train_grad)
    training = timed("train", phase_train)
    timed("model train grad", phase_model_train_grad)
    training["cp1-fused"] = timed(
        "cp1 train", phase_model_train, "cp1-fused", CP1_META,
        CP1_TRAIN_PRETRAIN, CP1_TRAIN_DEQMPC)
    training["quad-fused"] = timed(
        "quadrotor train", phase_model_train, "quad-fused", QUAD_META,
        QUAD_TRAIN_PRETRAIN, QUAD_TRAIN_DEQMPC)

    # the terminal-LQR ip path at cp2's shape and the MPC expert
    k3_horizon = timed("K3 horizon", phase_k3_horizon)
    cp2_qps = timed("cp2 QPs", phase_cp2_qps)
    timed("cp2 ip policy", phase_model_policy, CP2_IP_POLICY_PATHS)
    cp2_runs = timed("cp2 ip main path", phase_cp2_ip_main_path)
    timed("cp2 ip train grad", phase_model_train_grad, CP2_IP_POLICY_PATHS)
    training["cp2-ip-fused"] = timed(
        "cp2 ip train", phase_model_train, "cp2-ip-fused", CP2_IP_META,
        CP2_IP_TRAIN_PRETRAIN, CP2_IP_TRAIN_DEQMPC)
    experts = timed("experts", phase_experts)
    experts["dagger"] = timed("DAgger", phase_dagger)

    # the OptNet QP layer, SL1QP and the slew-rate option
    qp_layer = timed("QP layer", phase_qp_layer)
    sudoku = timed("sudoku", phase_sudoku)
    sl1qp = timed("SL1QP", phase_sl1qp)
    slew = timed("slew", phase_slew)

    # the RL experts, their datasets, and DEQ-MPC training on one
    rl = timed("RL", phase_rl)
    # the conv cell, NNMPCPolicy, DEQPolicy and the BC baseline
    deq = timed("DEQ family", phase_deq_family)
    log("phase seconds", json.dumps(PHASE_SECONDS))
    log("deq family summary", json.dumps(dict(
        conv_train_launches_per_deqmpc_step=deq["conv"]["train"][
            "launches_per_deqmpc_step"],
        conv_train_ms_per_step_median=deq["conv"]["train"][
            "ms_per_step_median"],
        conv_closed_loop={k: deq["conv"]["closed_loop"][k] for k in (
            "success_rate", "ms_per_step", "launches_per_step")},
        nnmpc_ms_per_call=deq["nnmpc"]["ms_per_call"],
        deq_policy_ms_per_call=deq["deq_policy"]["ms_per_call"],
        deq_policy_anderson_residuals=deq["deq_policy"][
            "anderson_residuals_f32"],
        bc_ms_per_step_median=deq["bc"]["ms_per_step_median"],
        launches_by_run=deq["launches_by_run"])))
    log("rl summary", json.dumps(dict(
        sac_ms_per_update=rl["sac"]["ms_per_update"],
        sac_ms_per_block=rl["sac"]["ms_per_block"],
        cgac_ms_per_update=rl["cgac"]["ms_per_update"],
        cgac_ms_per_block=rl["cgac"]["ms_per_block"],
        ppo_ms_per_iteration=rl["ppo"]["ms_per_iteration"],
        actors={k: v["upright_share"] for k, v in rl["actors"].items()},
        datagen_s=rl["datagen"]["seconds"],
        train_launches_per_deqmpc_step=rl["train"][
            "launches_per_deqmpc_step"],
        train_ms_per_step_median=rl["train"]["ms_per_step_median"])))
    log("solver layer", json.dumps(dict(
        qp_layer_timing=qp_layer["timing"],
        sudoku={k: sudoku[k] for k in ("ms_per_iteration", "loss0",
                                       "lossN", "val_cell_accuracy")},
        sl1qp_s_per_solve_with_grad={
            k: sl1qp[k]["s_per_solve_with_grad"] for k, *_ in SL1QP_RUNS})))
    # the training phases' launches of each kernel, all paths
    train_launches = {k: sum(row["launches_total"][k]
                             for row in training.values())
                      for k in kernel_wrappers()}

    main_b = EPISODES  # the batch the main paths hand every kernel
    kernels = []
    for name, rows, path, src, replaces in (
            ("btsolve (K1)", k1, "scan",
             "diff_qp_mpc_tpu_torch/csrc/btsolve.cu",
             "diff_qp_mpc_tpu/ops/btsolve_pallas.py:203"),
            ("al_fused (K2)", k2, "fused",
             "diff_qp_mpc_tpu_torch/csrc/al_fused.cu",
             "diff_qp_mpc_tpu/ops/al_fused_pallas.py:340"),
            ("riccati (K3)", k3, "ip-scan",
             "diff_qp_mpc_tpu_torch/csrc/riccati.cu",
             "diff_qp_mpc_tpu/ops/riccati_pallas.py:219"),
            ("trajqp_fused (K4)", k4, "ip-fused",
             "diff_qp_mpc_tpu_torch/csrc/trajqp_fused.cu",
             "diff_qp_mpc_tpu/ops/trajqp_fused_pallas.py:308")):
        r = rows[main_b]
        kid = name[-3:-1]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": runs[path]["launches"][kid],
            "launches_training": train_launches[kid],
            "launches_rl_training": rl["train"]["launches_total"][kid],
            "launches_deq_family": deq["launches_total"][kid],
            "max_abs_err": r.get("max_abs_err_xu", r.get("max_abs_err")),
            "tolerance": r["tol"][0] if kid == "K2" else r["tol"],
            "ms": r["ms"],
            "ms_events": r["ms_events"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "shape": f"B={main_b} T={T} nx={NX} nu={NU} float32"})
        if kid == "K1":
            kernels[-1]["layout"] = k1["layouts"][0]["chosen_layout"]
            kernels[-1]["ms_by_layout"] = {
                lr["B"]: lr["ms"] for lr in k1["layouts"]}
            f = k1["layouts"][-1]
            kernels[-1]["filled_card"] = dict(
                B=f["B"], ms=f["ms"], bound_ms=f["bound_ms"],
                bound_share=f["bound_share"])
            kernels[-1]["by_shape"] = k1_by_shape(k1_models, model_runs,
                                                  training)
        if kid == "K2":
            kernels[-1]["bound_ms_sin_as_one_op"] = r["bound_ms_sin_as_one_op"]
            kernels[-1]["group"] = k2["groups"][0]["chosen_group"]
            kernels[-1]["ms_by_group"] = {
                gr["B"]: dict(chosen=gr["chosen_group"], ms=gr["ms"])
                for gr in k2["groups"]}
            kernels[-1]["by_model"] = k2_by_model(
                k2_models, model_runs, training)
        if kid == "K3":
            f = rows["filled"]
            kernels[-1]["launch_floor_ms"] = r["launch_floor_ms"]
            kernels[-1]["filled_card"] = {
                k: f[k] for k in ("B", "ms", "ms_events", "bound_ms",
                                  "bound_share", "max_rel_err")}
            kernels[-1]["launches_horizon_kernel"] = sum(
                row["launches_total"].get("K3h", 0)
                for row in experts.values())
            kernels[-1]["by_shape"] = k3_by_shape(
                k3_horizon, cp2_qps, cp2_runs, training, experts)
        if kid == "K4":
            kernels[-1]["by_shape"] = k4_by_shape(cp2_qps, cp2_runs,
                                                  training)
    kernels.extend(slew_kernel_rows(slew))
    quad = kernels[1]["by_model"]["quadrotor T5"]
    kernels.append({
        "name": "al_fused quadrotor (K2, one warp per element)",
        "route": "cuda",
        "source": "diff_qp_mpc_tpu_torch/csrc/al_fused_warp.cuh",
        "replaces": "diff_qp_mpc_tpu/ops/al_fused_pallas.py:340",
        "launches": quad["launches"],
        "launches_training": quad["launches_training"],
        "max_abs_err": quad["max_abs_err_float32"],
        "tolerance": quad["tolerance_float32"],
        "max_abs_err_float64": quad["max_abs_err_float64"],
        "ms": quad["ms"], "ms_events": quad["ms_events"],
        "ms_B128": quad["ms_B128"], "plain_ms": quad["plain_ms"],
        "bound_ms": quad["bound_ms"], "bound_by": quad["bound_by"],
        "library_ms": None,
        "shared_memory": next(r["shared_memory"] for r in k2_models[
            "quadrotor T5 float32"] if "shared_memory" in r),
        "shape": f"B={main_b} T=5 nx=12 nu=4 float32"})
    kernels.append({
        "name": "sin_chain (K5)", "route": "cuda",
        "source": "diff_qp_mpc_tpu_torch/csrc/sin_chain.cu",
        "replaces": "benchmarks/roofline_fused.py:116",
        "launches": roof["launches"]["K5"],
        "launches_training": train_launches["K5"],
        "max_abs_err": k5["max_abs_err"], "tolerance": k5["tol"],
        "ms": k5["ms"],
        "ms_events": k5["ms_events"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None,
        "shape": "n_tiles={n_tiles} n_streams={n_streams} n_ops={n_ops} "
                 "float32".format(**K5_SHAPE)})
    log(json.dumps({"kernels": kernels}))
    log(card_name_and_power_limit())
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
