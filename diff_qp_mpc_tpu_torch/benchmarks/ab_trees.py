"""The closed loops, trainings and expert runs that the warp layouts serve
(K1 at n 16, K2 on the cartpoles and the quadrotor, K3's horizon kernel at
the quadrotor's and the experts' shapes, K4 at cp2's), on two checkouts of
the repo in turns, on one card.

    PYTHONPATH=$PWD python -m diff_qp_mpc_tpu_torch.benchmarks.ab_trees \\
        --trees A_DIR B_DIR [--order ABBA] [--runs NAME,...] \\
        [--out build/ab_trees.json]

A and B are two checkouts (for example the parent commit, unpacked by
``git archive`` into a directory git ignores, and the working tree). Each
first builds the kernels these runs launch, both at once; then, for each
letter of ``--order`` (default ABBA, so that a drift of the host's speed
over the call falls on both), every run below goes through that checkout's
own entry point in a process of its own, with the checkout as its working
directory and on its PYTHONPATH:

  - ``CLOSED_LOOPS``: the evaluate entry point on a committed checkpoint
    (64 episodes): ms a step as evaluate reports it, and the success rate;
  - ``TRAININGS``: the train entry point with a checkpoint's flags (its
    meta.json, fused, then the run's own flags) on its data, cut to
    ``PRETRAIN`` + the run's DEQ-MPC steps: the median ms of a DEQ-MPC
    step (its first left out), as train's ``on_step`` reports each step;
  - ``EXPERTS``: the datagen entry point (the MPC expert, float64): the
    median ms of an MPC step (its first left out), as datagen's
    ``on_step`` marks each step.

``--runs`` takes a subset of the runs by name (default: all). Both
checkouts must have ``train.main(argv, on_step=...)`` and
``datagen.main(argv, on_step=...)``. Prints one JSON
line per (turn, checkout, run) and writes them, with the card's name and
power limit, to ``--out``. Raises without a card or where a run fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

CP1 = "logs/deqmpc_cp1_fused_v10_T10/ckpt_best.msgpack"
CP2_V8 = "logs/deqmpc_cp2_fused_v8_T10/ckpt_best.msgpack"
QUAD = "logs/deqmpc_quadrotor_fused_v8/ckpt_best.msgpack"
CP2_IP = "logs/deqmpc_cp2_ip_term_v1/ckpt_best.msgpack"
#: (run, evaluate's flags): cp1's, cp2 v8's and the quadrotor's fused paths
#: (K2 on the warp layout; the quadrotor over its env's 100 steps), the
#: quadrotor's scan path (K1 at n 16), the last cut to 3 steps (host-bound,
#: ~3 s a step); the cp2 ip checkpoint's fused path (18 K4 at (5, 6, 1) a
#: step), cut to 15 steps as chip_smoke.py cuts it
CLOSED_LOOPS = (
    ("cp1-fused", ["--ckpt", CP1, "--fused", "--episodes", "64",
                   "--max_steps", "200"]),
    ("cp2-v8-fused", ["--ckpt", CP2_V8, "--fused", "--episodes", "64",
                      "--max_steps", "200"]),
    ("quad-fused", ["--ckpt", QUAD, "--fused", "--episodes", "64",
                    "--max_steps", "100"]),
    ("quad-scan", ["--ckpt", QUAD, "--episodes", "64", "--max_steps", "3"]),
    ("cp2-ip-fused", ["--ckpt", CP2_IP, "--fused", "--episodes", "64",
                      "--max_steps", "15"]))
#: (run, checkpoint meta.json, extra train flags, DEQ-MPC steps): cp1 (24
#: K2 + 6 K1 a DEQ-MPC step), the quadrotor (12 K2 + 6 K1 at n 16), the
#: quadrotor on the ip path (18 K4 at (5, 12, 4) + 6 K3h at (12, 4) a step;
#: ~1.4-2 s a step) and the cp2 ip checkpoint (18 K4 at (5, 6, 1) + 6 K3)
TRAININGS = (("cp1-train", CP1 + ".meta.json", [], 30),
             ("quad-train", QUAD + ".meta.json", [], 30),
             ("quad-ip-train", QUAD + ".meta.json",
              ["--solver_type", "ip"], 10),
             ("cp2-ip-train", CP2_IP + ".meta.json", [], 20))
PRETRAIN = 5
#: (run, datagen's flags): the quadrotor's MPC expert (T 20, 144 K3h at
#: (20, 12, 4) an MPC step), 16 trajectories × 5 steps as chip_smoke.py;
#: the cp2 stabilize expert (T 10, terminal LQR, 120 K3h at (10, 6, 1) an
#: MPC step), 64 trajectories × 10 steps
EXPERTS = (("quad-expert", ["--env", "rexquadrotor", "--num_traj", "16",
                            "--max_steps", "5", "--out",
                            os.path.join("build", "ab_trees",
                                         "quad_expert.pkl")]),
           ("cp2-expert", ["--env", "cartpole2link", "--stabilization",
                           "--num_traj", "64", "--max_steps", "10", "--out",
                           os.path.join("build", "ab_trees",
                                        "cp2_expert.pkl")]))
#: the kernel sources whose libraries the runs launch (those a checkout has)
LIBRARIES = ("btsolve", "al_fused_cartpole1l", "al_fused_cartpole2l",
             "al_fused_quadrotor", "riccati", "riccati_horizon",
             "riccati_horizon_warp", "trajqp_fused", "trajqp_fused_warp")
#: the flags of a checkpoint's meta.json that a run sets itself
_SKIP = {"fused", "iters", "pretrain_iters", "ckpt_every", "name", "logdir",
         "save", "load", "ckpt", "data", "x64", "device"}
_MARK = "AB_ROW "


def _meta_argv(parser, meta) -> list:
    """The train flags that ``meta`` sets, but for those in _SKIP."""
    argv = []
    for a in parser._actions:
        if a.dest in _SKIP or a.dest not in meta or not a.option_strings:
            continue
        v = meta[a.dest]
        if a.nargs == 0:  # store_true
            argv += [a.option_strings[0]] if v else []
        elif v is not None:
            argv += [a.option_strings[0], str(v)]
    return argv


def _child(kind: str, spec: str) -> dict:
    """One run in this process, on the checkout that PYTHONPATH names."""
    if kind == "build":
        from diff_qp_mpc_tpu_torch.utils import cuda_build

        libs = [lib for lib in LIBRARIES
                if (cuda_build.CSRC / f"{lib}.cu").exists()]
        cuda_build.build(libs)
        return dict(built=libs)
    if kind == "evaluate":
        from diff_qp_mpc_tpu_torch.learning import evaluate

        m = evaluate.main(dict(CLOSED_LOOPS)[spec])
        return dict(ms_per_step=m["ms_per_step"],
                    success_rate=m["success_rate"], steps_run=m["steps_run"])
    if kind == "expert":
        import time

        from diff_qp_mpc_tpu_torch.learning import datagen

        argv = dict(EXPERTS)[spec]
        os.makedirs(os.path.dirname(argv[-1]), exist_ok=True)
        stamps = [time.perf_counter()]
        datagen.main(argv, on_step=lambda step: stamps.append(
            time.perf_counter()))
        ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        return dict(ms_per_step_median=statistics.median(ms[1:]),
                    ms_first_step=ms[0], mpc_steps=len(ms))
    from diff_qp_mpc_tpu_torch.learning import train

    meta_path, extra, deqmpc = {name: rest for name, *rest in
                                TRAININGS}[spec]
    with open(meta_path) as f:
        meta = json.load(f)
    iters = PRETRAIN + deqmpc
    argv = _meta_argv(train.build_parser(), meta) + [
        "--data", meta["data"], "--fused", "--iters", str(iters),
        "--pretrain_iters", str(PRETRAIN), "--ckpt_every", str(iters),
        "--logdir", os.path.join("build", "ab_trees"), "--name", spec,
        *extra]
    records = []
    train.main(argv, on_step=records.append)
    deq = [r["ms"] for r in records if r["mode"] == "deqmpc"]
    pre = [r["ms"] for r in records if r["mode"] == "deq"]
    return dict(ms_per_step_median=statistics.median(deq[1:]),
                ms_first_deqmpc_step=deq[0],
                ms_pretrain_median=statistics.median(pre[1:]),
                deqmpc_steps=len(deq))


def _spawn(tree: Path, kind: str, spec: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(tree))
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--child", kind,
         spec], cwd=tree, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, what: str) -> dict:
    out, err = proc.communicate()
    rows = [line[len(_MARK):] for line in out.splitlines()
            if line.startswith(_MARK)]
    if proc.returncode != 0 or not rows:
        raise RuntimeError(f"{what}: exit {proc.returncode}\n{err[-4000:]}")
    return json.loads(rows[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, type=Path, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--runs", default="",
                    help="comma-separated runs (default: all)")
    ap.add_argument("--out", type=Path,
                    default=Path("build/ab_trees.json"))
    ap.add_argument("--child", nargs=2, metavar=("KIND", "SPEC"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(_MARK + json.dumps(_child(*args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: these runs are of the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    trees = dict(zip("AB", (t.resolve() for t in args.trees)))
    builds = {k: _spawn(t, "build", "-") for k, t in trees.items()}
    for k, proc in builds.items():
        _result(proc, f"build of {trees[k]}")
    runs = [("evaluate", name) for name, _ in CLOSED_LOOPS] + [
        ("train", name) for name, *_ in TRAININGS] + [
        ("expert", name) for name, _ in EXPERTS]
    chosen = [r for r in args.runs.split(",") if r]
    unknown = set(chosen) - {name for _, name in runs}
    if unknown:
        raise ValueError(f"unknown runs {sorted(unknown)}")
    runs = [(kind, name) for kind, name in runs
            if not chosen or name in chosen]
    rows = []
    for turn, k in enumerate(args.order):
        for kind, name in runs:
            row = dict(turn=turn, tree=k, path=str(trees[k]), run=name,
                       **_result(_spawn(trees[k], kind, name),
                                 f"{name} on {trees[k]}"))
            rows.append(row)
            print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
