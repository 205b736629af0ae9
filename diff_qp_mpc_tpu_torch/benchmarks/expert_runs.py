"""Full-size MPC expert regeneration on the card, judged as the committed
datasets are.

Regenerates the 2-link cartpole's stabilize set and the quadrotor's hover
set with the port's expert (``learning.datagen``, float64) into ``build/``
(never over ``data/``), with the flags the repo's records give for the
committed pickles:
- ``Cartpole2l-v0-stabilize``: 200 trajectories × 120 steps from the
  stabilize box widened 4× with goal-holding tails (``--init_scale 4
  --no_success_term``, the commit that regenerated the committed set);
  the planner is EXPERT_PLANNER's (T 10 with the terminal LQR cost);
- ``RexQuadrotor-v0``: 300 × 100 with goal-holding tails
  (``--no_success_term``; RESULTS.md's "300 trajs ×100 steps with
  goal-holding tails"), EXPERT_PLANNER's planner (T 20, hover u_goal).
Each pickle is judged by the criteria that tests/test_expert_data.py
applies to the committed one: cp2's final cumulative-angle error (median
< 0.05, share < 0.2 above 0.9); the quadrotor's count (300) and final
position error (mean < 0.05, share < 0.05 above 0.95). Prints one JSON
line per run (wall seconds, ms per MPC step, the criteria) and writes them
to ``--out`` (default ``build/expert_runs.json``). Raises without a card.

    PYTHONPATH=$PWD python -m diff_qp_mpc_tpu_torch.benchmarks.expert_runs \\
        [--out PATH] [--runs cp2,quad]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.learning import datagen
from diff_qp_mpc_tpu_torch.models import angle_normalize
from diff_qp_mpc_tpu_torch.utils.device import (
    card_name_and_power_limit,
    resolve_device,
)

RUNS = {
    "cp2": ["--env", "cartpole2link", "--stabilization", "--num_traj", "200",
            "--max_steps", "120", "--init_scale", "4", "--no_success_term",
            "--out", os.path.join("build", "expert_runs",
                                  "expert_traj_mpc-Cartpole2l-v0-stabilize"
                                  "_new.pkl")],
    "quad": ["--env", "rexquadrotor", "--num_traj", "300", "--max_steps",
             "100", "--no_success_term", "--out",
             os.path.join("build", "expert_runs",
                          "expert_traj_mpc-RexQuadrotor-v0_new.pkl")],
}


def judge(name, trajs) -> dict:
    """tests/test_expert_data.py's criteria for the committed pickle."""
    finals = np.array([t[-1][0] for t in trajs], np.float64)
    if name == "cp2":
        th_abs = np.cumsum(finals[:, 1:3], axis=-1)
        err = np.abs(angle_normalize(torch.as_tensor(th_abs - np.pi))
                     .numpy()).max(-1)
        out = dict(median_err=float(np.median(err)),
                   share_err_below_0_2=float((err < 0.2).mean()))
        out["passes"] = (out["median_err"] < 0.05
                         and out["share_err_below_0_2"] > 0.9)
    else:
        pos_err = np.linalg.norm(finals[:, :3], axis=1)
        out = dict(count=len(trajs), mean_pos_err=float(pos_err.mean()),
                   share_pos_err_below_0_05=float((pos_err < 0.05).mean()))
        out["passes"] = (len(trajs) == 300 and out["mean_pos_err"] < 0.05
                         and out["share_pos_err_below_0_05"] > 0.95)
    return out


def run(name: str) -> dict:
    argv = RUNS[name]
    os.makedirs(os.path.dirname(argv[-1]), exist_ok=True)
    stamps = []
    t0 = time.perf_counter()
    trajs = datagen.main(argv, on_step=lambda step: stamps.append(
        time.perf_counter()))
    seconds = time.perf_counter() - t0
    steps = np.diff([t0] + stamps) * 1e3
    row = dict(run=name, argv=argv, seconds=seconds, mpc_steps=len(stamps),
               ms_per_step_median=float(np.median(steps)),
               ms_first_step=float(steps[0]),
               trajectories=len(trajs),
               mean_len=float(np.mean([len(t) for t in trajs])),
               **judge(name, trajs))
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("build",
                                                 "expert_runs.json"))
    p.add_argument("--runs", default=",".join(sorted(RUNS)),
                   help="comma-separated runs of " + ", ".join(sorted(RUNS)))
    args = p.parse_args(argv)
    names = [n for n in args.runs.split(",") if n]
    unknown = set(names) - set(RUNS)
    if unknown:
        raise ValueError(f"unknown runs {sorted(unknown)}")
    resolve_device(None)  # raises without a card
    rows = []
    for name in names:
        rows.append(run(name))
        print("expert run", json.dumps(rows[-1]), flush=True)
    card = card_name_and_power_limit()
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, runs=rows), f, indent=1)
    return rows


if __name__ == "__main__":
    main()
