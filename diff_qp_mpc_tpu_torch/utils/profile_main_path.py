"""Where the main path's time goes on the card.

Runs the evaluate entry point's policy closed-loop on the pendulum (64
episodes) and traces a window of steps with torch.profiler, once per solver
path: the AL checkpoint on the scan (K1) and fused (K2) paths, the ip
checkpoint on the ip scan (K3) and ip fused (K4) paths. Prints one JSON line
per path: host ms per closed-loop step, device busy ms per step (kernels,
copies and memsets from the trace), the device's idle share, launches per
step, and the kernels that take the most device time.

    python -m diff_qp_mpc_tpu_torch.utils.profile_main_path [--steps 10]

Chrome traces go to --out (default build/profile/, which git ignores).
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time

import torch

from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import evaluate
from diff_qp_mpc_tpu_torch.learning.train import make_policy
from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

CKPT = "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack"
IP_CKPT = "logs/deqmpc_pendulum_ip_fused_v2/ckpt.msgpack"
# path name -> (checkpoint, --fused)
PATHS = {"scan": (CKPT, False), "fused": (CKPT, True),
         "ip-scan": (IP_CKPT, False), "ip-fused": (IP_CKPT, True)}
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _trace_device_time(path: str):
    """(busy µs by category, µs and count by kernel name) from a Chrome
    trace written by torch.profiler."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    busy = collections.Counter()
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in _DEVICE_CATS:
            busy[cat] += ev.get("dur", 0.0)
            if cat == "kernel":
                k = kernels[ev.get("name", "?")]
                k[0] += ev.get("dur", 0.0)
                k[1] += 1
    return busy, kernels


def profile_path(name: str, steps: int, warmup: int, episodes: int,
                 out: str, seed: int = 0):
    from torch.profiler import ProfilerActivity, profile

    ckpt, fused = PATHS[name]
    argv = ["--env", "pendulum", "--deq", "--ckpt", ckpt] + (
        ["--fused"] if fused else [])
    args = evaluate.parse_args(argv)
    device = torch.device("cuda")
    env = make_env(args.env)
    policy = make_policy(args, env)
    policy.load_state_dict(load_policy_params(args.ckpt,
                                              policy.flax_modules()))
    policy.to(device)
    state = env.reset(torch.Generator().manual_seed(seed), episodes,
                      device=device)

    def step(state):
        with torch.no_grad():
            iterates, _ = policy(state.x, qp_solve=True)
            state, _, _ = env.step(state, iterates[-1].actions[:, 0])
        torch.cuda.synchronize()
        return state

    for _ in range(warmup):
        state = step(state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = step(state)
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, f"trace_main_path_{name}.json")
    prof.export_chrome_trace(trace)
    busy, kernels = _trace_device_time(trace)
    busy_us = sum(busy.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
    return {
        "path": name, "episodes": episodes, "steps": steps,
        "host_ms_per_step": wall_us / steps / 1e3,
        "device_busy_ms_per_step": busy_us / steps / 1e3,
        "device_idle_share": 1.0 - busy_us / wall_us,
        "kernel_launches_per_step": sum(c for _, c in kernels.values())
        / steps,
        "busy_ms_per_step_by_category": {
            k: v / steps / 1e3 for k, v in busy.items()},
        "top_kernels": [{"name": k[:80], "ms_per_step": us / steps / 1e3,
                         "launches_per_step": c / steps}
                        for k, (us, c) in top],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--episodes", type=int, default=64)
    p.add_argument("--out", type=str, default=os.path.join("build",
                                                           "profile"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profiling the main path needs a CUDA device")
    for name in PATHS:
        print(json.dumps(profile_path(name, args.steps, args.warmup,
                                      args.episodes, args.out)), flush=True)


if __name__ == "__main__":
    main()
