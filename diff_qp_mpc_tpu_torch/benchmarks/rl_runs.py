"""Full-length RL expert training on the card, judged as the committed
datasets are.

Trains CGAC and SAC on the pendulum from scratch at their default
configurations (``CGACConfig``: 256 envs, a window of 16, batch 1024, 4
updates an iteration; ``SACConfig``: 16 envs, a 200,000-transition buffer,
batch 256, 8 updates an iteration), seed 0, float32. Every ``log_every``
(2000) iterations the trainer prints its log line (the JAX package's
format: the last step reward, losses, α, the mean return of 64 evaluation
episodes) and this script rolls the actor's mean action out over 300
trajectories (``sac_expert_rollouts``, seed 0) and judges them by
tests/test_expert_data.py's criterion for the committed pendulum pickles:
the final |θ| < 0.1 on more than 0.95 of them. A run stops when the
criterion holds, at 30,000 iterations (the trainers' default), or after
``BUDGET_S`` (1200) seconds. Each run's pickle and checkpoint go
to ``build/rl_runs/``. Prints one JSON line per log point and per run
(iterations, seconds, ms per update and per iteration over the training:
its env steps and the trainer's own 64-episode evaluations included, the
300-rollout judging not; the return curve, the final upright share) and
writes them with the card's name and power limit to ``--out`` (default
``build/rl_runs.json``). Raises without a card.

    PYTHONPATH=$PWD python -m diff_qp_mpc_tpu_torch.benchmarks.rl_runs \\
        [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import rl
from diff_qp_mpc_tpu_torch.learning.data import save_expert_pickle
from diff_qp_mpc_tpu_torch.models import angle_normalize
from diff_qp_mpc_tpu_torch.utils.device import (
    card_name_and_power_limit,
    resolve_device,
)

ALGOS = ("cgac", "sac")
BUDGET_S = 1200.0  # card seconds a run may train, its judging included
ITERS = 30_000
LOG_EVERY = 2_000
NUM_TRAJ = 300
MIN_UPRIGHT = 0.95  # tests/test_expert_data.py, the pendulum's pickles
OUT_DIR = os.path.join("build", "rl_runs")


def upright_share(trajs) -> float:
    finals = torch.tensor(np.array([t[-1][0] for t in trajs]))
    return float((angle_normalize(finals[:, 0]).abs() < 0.1)
                 .double().mean())


def run(algo: str, device) -> dict:
    env = make_env("pendulum")
    trainer = (rl.SAC(env, rl.SACConfig(), device=device) if algo == "sac"
               else rl.CGAC(env, rl.CGACConfig(), device=device))
    cfg = trainer.cfg
    curve, last = [], {}
    t0 = time.perf_counter()
    judged_s = [0.0]  # seconds spent judging, not training

    def on_log(it, st, act, row):
        torch.cuda.synchronize()
        t_judge = time.perf_counter()
        trajs = rl.sac_expert_rollouts(env, act, NUM_TRAJ, device=device)
        judged_s[0] += time.perf_counter() - t_judge
        row.update(iterations=it + cfg.block, upright_share=upright_share(
            trajs), seconds=time.perf_counter() - t0)
        curve.append(row)
        last.update(trajs=trajs, row=row)
        print(f"rl run {algo}", json.dumps(row), flush=True)
        return (row["upright_share"] > MIN_UPRIGHT
                or row["seconds"] > BUDGET_S)

    ckpt = os.path.join(OUT_DIR, f"expert_traj_{algo}-{env.spec_id}_new.pkl")
    trainer.train(ITERS, seed=0, log_every=LOG_EVERY,
                  ckpt_path=f"{ckpt}.{algo}_ckpt.msgpack", on_log=on_log)
    seconds = time.perf_counter() - t0
    save_expert_pickle(ckpt, last["trajs"])
    iters = last["row"]["iterations"]
    train_s = seconds - judged_s[0]
    return dict(
        algo=algo, config={k: getattr(cfg, k)
                           for k in cfg.__dataclass_fields__},
        iterations=iters, updates=iters * cfg.updates_per_iter,
        seconds=seconds, seconds_judging=judged_s[0],
        ms_per_update=1e3 * train_s / (iters * cfg.updates_per_iter),
        ms_per_iteration=1e3 * train_s / iters,
        upright_share=last["row"]["upright_share"],
        passes=last["row"]["upright_share"] > MIN_UPRIGHT,
        stopped_by=("criterion" if last["row"]["upright_share"]
                    > MIN_UPRIGHT else "budget" if seconds > BUDGET_S
                    else "iterations"),
        curve=curve)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("build", "rl_runs.json"))
    args = p.parse_args(argv)
    device = resolve_device(None)  # raises without a card
    os.makedirs(OUT_DIR, exist_ok=True)
    rows = []
    for algo in ALGOS:
        rows.append(run(algo, device))
        print("rl run", json.dumps({k: v for k, v in rows[-1].items()
                                    if k != "curve"}), flush=True)
    card = card_name_and_power_limit()
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, runs=rows), f, indent=1)
    return rows


if __name__ == "__main__":
    main()
