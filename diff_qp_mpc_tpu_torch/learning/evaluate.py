"""Closed-loop evaluation of a trained policy (port of
diff_qp_mpc_tpu.learning.evaluate).

Rolls the policy closed-loop in the environment, applying its first planned
action each step (receding horizon): the last DEQ-MPC iterate's, or without
``--deq`` the behaviour-cloning NNPolicy's (a state-only out_type cannot
act, and raises). Reports success rate, mean reward, episode length and
final goal error.

Usage:
    python -m diff_qp_mpc_tpu_torch.learning.evaluate --env pendulum --deq \\
        --ckpt logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack \\
        [--fused] [--device cpu]
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning import noise as noise_mod
from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy
from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

# policy-shaping training flags a checkpoint's meta.json sets unless the
# command line does; fused (a kernel choice) and x64 are not adopted
ADOPTED = ("env", "deq", "deq_iter", "T", "hdim", "qp_iter", "deq_out_type",
           "policy_out_type", "layer_type", "solver_type", "tracking_r",
           "stabilization", "ws_mode", "solver_carry", "rho_max", "al_reg",
           "terminal_lqr")


@torch.no_grad()
def evaluate_policy(env, policy, episodes: int = 64, max_steps: int = 200,
                    noise_type: int = 0, noise_std: float = 0.0,
                    noise_mean: float = 0.0, seed: int = 0,
                    device: Optional[torch.device] = None,
                    dtype=torch.float32,
                    x_init: Optional[torch.Tensor] = None,
                    deq: bool = True):
    """Batched closed-loop rollout of ``episodes`` episodes on ``device``
    (default cuda). Initial states and observation noise come from a
    ``torch.Generator`` seeded by ``seed``; ``x_init`` [episodes, nx]
    replaces the drawn initial states. ``deq`` False: the policy is an
    NNPolicy, acting on its first planned control."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    if x_init is None:
        state = env.reset(gen, episodes, dtype=dtype, device=device)
    else:
        state = EnvState.make(x_init.to(dtype=dtype, device=device))

    total_reward = np.zeros(episodes)
    done_at = np.full(episodes, max_steps, np.int32)
    ever_done = np.zeros(episodes, bool)
    ever_success = np.zeros(episodes, bool)
    final_goal_err = np.full(episodes, np.nan)
    steps_run = 0
    t_start = time.perf_counter()
    for t in range(max_steps):
        obs = noise_mod.corrupt_observation(
            gen, state.x[:, None, :], noise_type, noise_std, noise_mean)[:, 0]
        state, reward, done = env.step(state, _act(policy, obs, deq))
        steps_run += 1
        r = reward.double().cpu().numpy()
        # a diverging episode can emit a NaN reward on its last live step
        r = np.where(np.isfinite(r), r, 0.0)
        d = done.cpu().numpy()
        # success = the success-streak termination, not the step limit
        succ = (state.num_successes >= env.success_streak).cpu().numpy()
        total_reward += r * (~ever_done)
        done_at[d & ~ever_done] = t + 1
        ge = env.goal_error(state.x).double().cpu().numpy()
        final_goal_err = np.where(~ever_done, ge, final_goal_err)
        ever_success |= succ & ~ever_done
        ever_done |= d
        if ever_done.all():
            break
    seconds = time.perf_counter() - t_start  # ends in device->host copies

    return {
        "success_rate": float(ever_success.mean()),
        "mean_reward": float(total_reward.mean()),
        "mean_episode_len": float(done_at.mean()),
        "median_final_goal_err": float(np.nanmedian(final_goal_err)),
        "episodes": episodes,
        "noise_type": noise_type,
        "steps_run": steps_run,
        "ms_per_step": 1e3 * seconds / max(steps_run, 1),
    }


def _act(policy, obs, deq: bool):
    if deq:
        iterates, _ = policy(obs, qp_solve=True)
        return iterates[-1].actions[:, 0]
    _, actions = policy(obs)
    if actions is None:
        raise ValueError("state-only policy cannot act closed-loop")
    return actions[:, 0]


def parse_args(argv=None):
    """Flags, with the checkpoint's meta.json adopted for every
    policy-shaping field the command line does not set."""
    base = build_parser()
    base.add_argument("--episodes", type=int, default=64)
    base.add_argument("--max_steps", type=int, default=200)
    base.add_argument("--noise_type", type=int, default=0)
    base.add_argument("--noise_std", type=float, default=0.0)
    base.add_argument("--noise_mean", type=float, default=0.0)
    args = base.parse_args(argv)
    if args.ckpt is None:
        base.error("--ckpt is required for evaluation")
    raw = list(argv) if argv is not None else sys.argv[1:]
    provided = {a.dest for a in base._actions
                if any(opt in raw for opt in a.option_strings)}
    meta_path = args.ckpt + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        for k in ADOPTED:
            if k in meta and k not in provided and hasattr(args, k):
                setattr(args, k, meta[k])
        # Warm-start carry follows the TRAINING operator, not the kernel
        # that evaluates: checkpoints from before solver_carry were trained
        # with the per-path defaults (fused = fresh λ/ρ, scan = carried).
        # Re-inferring it from the evaluation path drifted cross-path
        # evaluations from 1.00 to 0.84.
        if "solver_carry" not in provided and \
                meta.get("solver_carry", "auto") == "auto":
            args.solver_carry = "off" if meta.get("fused") else "on"
    return args


def main(argv=None):
    """Evaluate a checkpoint; prints and returns the metrics."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    env_kwargs = {"stabilization": True} if args.stabilization else {}
    env = make_env(args.env, **env_kwargs)
    policy = make_policy(args, env)
    policy.load_state_dict(load_policy_params(args.ckpt,
                                              policy.flax_modules()))
    policy.to(device=device, dtype=dtype)
    metrics = evaluate_policy(
        env, policy, episodes=args.episodes, max_steps=args.max_steps,
        noise_type=args.noise_type, noise_std=args.noise_std,
        noise_mean=args.noise_mean, seed=args.seed, device=device,
        dtype=dtype, deq=args.deq)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
