"""The pendulum's two scan closed loops, uncut, on the card, gated on success.

``chip_smoke.py`` runs the pendulum's AL scan path (K1) and ip scan path
(K3) only for a few steps (they are host-bound, ~0.2 and ~0.8 s a step) and
gates success on the fused paths. This script runs both scan paths at full
length from the committed checkpoints through the evaluate entry point: 64
episodes of up to 200 steps, float32, the launch counts set to 0 before
each run and read after. Each run must launch its kernel and no other,
exactly 48 K1 (AL scan: deq_iter 6 × al_iter 2 × n_newton 4) or 432 K3
(ip scan: 6 × (qp_iter 2 + 1) × max_iter 12 × 2) launches a step, and reach
a success rate of at least 0.95. Prints one JSON line per run (success, ms
per step, launches) and writes them with the card's name and power limit to
``--out`` (default ``build/closed_loop_runs.json``). Raises without a card
or on a failed gate.

    PYTHONPATH=$PWD python -m diff_qp_mpc_tpu_torch.benchmarks.closed_loop_runs \\
        [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from diff_qp_mpc_tpu_torch.learning import evaluate
from diff_qp_mpc_tpu_torch.ops import btsolve_cuda, riccati_cuda
from diff_qp_mpc_tpu_torch.utils.device import (
    card_name_and_power_limit,
    resolve_device,
)

MIN_SUCCESS = 0.95
# (name, checkpoint, launch-count module, launches per step)
RUNS = (("scan", "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack",
         btsolve_cuda, 6 * 2 * 4),
        ("ip-scan", "logs/deqmpc_pendulum_ip_fused_v2/ckpt.msgpack",
         riccati_cuda, 6 * 3 * 12 * 2))


def run(name: str, ckpt: str, counter, per_step: int) -> dict:
    counters = (btsolve_cuda, riccati_cuda)
    for module in counters:
        module.launches = 0
    riccati_cuda.horizon_launches = 0
    t0 = time.perf_counter()
    metrics = evaluate.main(["--env", "pendulum", "--deq", "--ckpt", ckpt,
                             "--episodes", "64", "--max_steps", "200"])
    row = dict(path=name, ckpt=ckpt, seconds=time.perf_counter() - t0,
               launches={m.__name__.rsplit(".", 1)[-1]: m.launches
                         for m in counters},
               horizon_launches=riccati_cuda.horizon_launches, **metrics)
    others = sum(m.launches for m in counters if m is not counter) \
        + riccati_cuda.horizon_launches
    if counter.launches != per_step * metrics["steps_run"] or others:
        raise RuntimeError(f"{name}: launches {row['launches']} over "
                           f"{metrics['steps_run']} steps, expected "
                           f"{per_step} a step of one kernel")
    row["passes"] = metrics["success_rate"] >= MIN_SUCCESS
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join("build",
                                                 "closed_loop_runs.json"))
    args = p.parse_args(argv)
    resolve_device(None)  # raises without a card
    rows = []
    for spec in RUNS:
        rows.append(run(*spec))
        print("closed loop", json.dumps(rows[-1]), flush=True)
    card = card_name_and_power_limit()
    print(card)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, runs=rows), f, indent=1)
    failed = [r["path"] for r in rows if not r["passes"]]
    if failed:
        raise RuntimeError(f"success below {MIN_SUCCESS} on {failed}")
    return rows


if __name__ == "__main__":
    main()
