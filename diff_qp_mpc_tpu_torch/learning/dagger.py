"""DAgger-style expert relabeling of policy-visited states (port of
diff_qp_mpc_tpu.learning.dagger).

Rolls a trained DEQ-MPC policy closed-loop, collects the states it visits,
subsamples them uniformly, and has the receding-horizon SQP-MPC expert
(``learning.datagen.mpc_expert_rollouts``, with the env's stabilize
planner) roll out from each; the relabeled trajectories are written in the
reference pickle format for fine-tuning with ``train --data
<orig>,<dagger-out> --load``.

Usage:
    python -m diff_qp_mpc_tpu_torch.learning.dagger --env cartpole1link \\
        --deq --deq_iter 6 --qp_solve --T 10 --qp_iter 4 --fused \\
        --ckpt logs/<run>/ckpt_best.msgpack --episodes 64 \\
        --num_relabel 200 --out build/dagger-Cartpole1l-v0.pkl [--device cpu]
"""
from __future__ import annotations

import json

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning.data import save_expert_pickle
from diff_qp_mpc_tpu_torch.learning.datagen import mpc_expert_rollouts
from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy
from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params
from diff_qp_mpc_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def collect_policy_states(env, policy, episodes: int = 64,
                          max_steps: int = 200, seed: int = 0,
                          device=None, dtype=torch.float32) -> np.ndarray:
    """Closed-loop rollout of the policy from the env's reset draw
    (``torch.Generator`` seeded by ``seed``); returns every state each
    episode reaches while it is alive, [N, nx]."""
    device = resolve_device(device)
    state = env.reset(torch.Generator().manual_seed(seed), episodes,
                      dtype=dtype, device=device)
    visited = []
    alive = np.ones(episodes, bool)
    for _ in range(max_steps):
        iterates, _ = policy(state.x, qp_solve=True)
        state, _, done = env.step(state, iterates[-1].actions[:, 0])
        visited.append(state.x.cpu().numpy()[alive])
        alive &= ~done.cpu().numpy()
        if not alive.any():
            break
    return np.concatenate(visited, axis=0)


def select_relabel_states(states: np.ndarray, num: int,
                          rng: np.random.RandomState) -> np.ndarray:
    """Uniform subsample of the visited set (the policy's own state
    distribution is the DAgger distribution)."""
    if len(states) <= num:
        return states
    idx = rng.choice(len(states), size=num, replace=False)
    return states[idx]


def main(argv=None, on_expert_step=None):
    """Collect, relabel and write; returns a summary dict. ``on_expert_step``
    is passed to the expert's rollouts as their ``on_step``."""
    p = build_parser()
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--num_relabel", type=int, default=200,
                   help="how many visited states the MPC expert relabels")
    p.add_argument("--relabel_steps", type=int, default=120,
                   help="length of each expert rollout from a visited state")
    p.add_argument("--filter_goal_dist", type=float, default=0.0,
                   help="keep only visited states within this distance of "
                        "the goal before subsampling")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)
    if args.ckpt is None:
        p.error("--ckpt (trained policy checkpoint) is required")
    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    env_kwargs = {"stabilization": True} if args.stabilization else {}
    env = make_env(args.env, **env_kwargs)
    policy = make_policy(args, env)
    policy.load_state_dict(load_policy_params(args.ckpt))
    policy.to(device=device, dtype=dtype)

    states = collect_policy_states(env, policy, episodes=args.episodes,
                                   max_steps=args.max_steps, seed=args.seed,
                                   device=device, dtype=dtype)
    print(f"collected {len(states)} policy-visited states")
    if args.filter_goal_dist > 0:
        if hasattr(env, "_delta_upright"):
            dist = env._delta_upright(torch.as_tensor(states)).numpy()
        else:
            goal = np.asarray(getattr(env, "goal", np.zeros(env.nx)))
            dist = np.linalg.norm(states - goal, axis=-1)
        states = states[dist < args.filter_goal_dist]
        print(f"{len(states)} within {args.filter_goal_dist} of the goal")
    rng = np.random.RandomState(args.seed)
    picked = select_relabel_states(states, args.num_relabel, rng)
    print(f"relabeling {len(picked)} states with the SQP-MPC expert")

    # the expert (float64) relabels with the env's stabilize planner
    # (corrective data is what closed-loop capture needs)
    stab_env = env if args.stabilization else make_env(args.env,
                                                       stabilization=True)
    trajs = mpc_expert_rollouts(
        stab_env, num_traj=len(picked), max_steps=args.relabel_steps,
        seed=args.seed, init_states=picked, device=device,
        on_step=on_expert_step)
    save_expert_pickle(args.out, trajs)
    lens = [len(t) for t in trajs]
    summary = {"out": args.out, "num_traj": len(trajs),
               "visited": len(states), "steps": int(np.sum(lens)),
               "mean_len": float(np.mean(lens)),
               "expert_env": stab_env.spec_id}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
