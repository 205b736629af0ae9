#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (diff_qp_mpc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU fallback):
  1. build every CUDA kernel of the main path from diff_qp_mpc_tpu_torch/csrc
     (one nvcc per source, in parallel) into build/kernels/;
  2. K1 (block-tridiagonal Cholesky, csrc/btsolve.cu) against its plain
     PyTorch version on random SPD block-tridiagonal systems, T 5, n 3,
     B 64 (the main path's shape), 256 and 4096, float32 and float64;
  3. K2 (the fused AL-MPC solve, csrc/al_fused.cu) against its plain version
     at the main path's budget (pendulum, T 5, al_iter 2, n_newton 4, n_ls
     20, rho_max 1e6, reg 1e-7), B 64 and 256, float32 and float64;
  4. one DEQ-MPC policy forward on the card against the same forward on the
     CPU (float64, committed pendulum checkpoint), on both solver paths;
  5. the main path: closed-loop evaluation of the committed pendulum
     checkpoint through the evaluate entry point, 64 episodes of up to 200
     steps, on the scan path (K1) and the fused path (K2). The launch counts
     are set to 0 just before each run and read just after; each path must
     launch its kernel and reach a success rate of at least 0.95.
It prints one JSON line per kernel summary, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

CKPT = "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack"
EPISODES, MAX_STEPS = 64, 200
MIN_SUCCESS = 0.95
T, NX, NU = 5, 2, 1
N = NX + NU
# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
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
# float32 is held to twice that.
K1_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# float64 policy forward, card vs CPU: six K1- or K2-backed solves, each with
# the line-search near-ties above
POLICY_TOL = 1e-6
K2_TOL = {torch.float32: (1e-2, 1e-3), torch.float64: (1e-6, 1e-6)}


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=2):
    """Milliseconds per call: CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_ms(fn, reps, name):
    """Device time per launch of the CUDA kernel whose name contains
    ``name``, from torch.profiler; None if the profiler saw no such kernel
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total += ev.device_time_total
            count += ev.count
    if count == 0 or total <= 0:
        return None
    return total / count / 1e3


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- K1 ----
def k1_ops(T_, n):
    """Floating-point operations of one element's factor + solve, counted
    from csrc/btsolve.cu (a multiply-subtract is 2, a divide or sqrt 1)."""
    chol = sum(2 * j + 1 for i in range(n) for j in range(i + 1))
    lower_mat = n ** 3
    schur = n * n * (n + 1) + n
    tri = n * n  # one triangular vector solve
    stage0 = n + chol + tri
    stage = lower_mat + schur + chol + 2 * n * n + tri
    backward = tri + (T_ - 1) * (2 * n * n + tri)
    return stage0 + (T_ - 1) * stage + backward


def random_bt_spd(B, T_, n, dtype, seed):
    """SPD block-tridiagonal H = L Lᵀ, L block lower bidiagonal with
    well-conditioned diagonal blocks; returns D, O, b on the card."""
    rng = np.random.RandomState(seed)
    Ld = np.tril(0.3 * rng.randn(B, T_, n, n), -1) + np.eye(n) * (
        1.0 + rng.rand(B, T_, n, 1))
    Ls = 0.3 * rng.randn(B, T_, n, n)  # Ls[:, t] couples t to t-1
    D = Ld @ Ld.transpose(0, 1, 3, 2)
    D[:, 1:] += Ls[:, 1:] @ Ls[:, 1:].transpose(0, 1, 3, 2)
    O = Ls[:, 1:] @ Ld[:, :-1].transpose(0, 1, 3, 2)
    b = rng.randn(B, T_, n)
    to = lambda a: torch.tensor(a, dtype=dtype, device="cuda")
    return to(D), to(O), to(b)


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
                row["ms_events"] = cuda_ms(kern, 200)
                row["ms"] = device_kernel_ms(kern, 50, "btsolve_kernel")
                row["plain_ms"] = cuda_ms(
                    lambda: btsolve.batched_factor_solve(D, O, b, reg), 20)
                row["library_ms"] = cuda_ms(library, 50)
                nbytes = 4 * B * (T * N * N + (T - 1) * N * N + 2 * T * N)
                row["bound_ms"], row["bound_by"] = bound(nbytes,
                                                         B * k1_ops(T, N))
                rows[B] = row
            log("K1", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K1 disagrees with its plain version: "
                                   f"{row}")
    return rows


# ---------------------------------------------------------------- K2 ----
def k2_ops(T_, nx, nu, al_iter, n_newton, n_ls):
    """Floating-point operations of one element's solve, counted from
    csrc/al_fused.cu with the pendulum functor (step 8 incl. one sin,
    Jacobian 9 incl. one cos; a multiply-add is 2, a compare or select 0)."""
    n = nx + nu
    step, jac = 8, 9
    dyn_terms = (T_ - 1) * (step + nx * 7)  # r, λr, ρ/2 r²
    bound_terms = T_ * nu * 14
    constraints = dyn_terms + bound_terms
    cost_terms = T_ * n * 5
    grad = ((T_ - 1) * (step + jac + nx * 3) + T_ * n * 2
            + (T_ - 1) * (2 * nx * nx + 2 * nu * nx + nx) + T_ * nu * 10)
    gtg = n * (n + 1) // 2 * (2 * nx + 2)
    build = T_ * (n + nx + 2 * nu) + (T_ - 1) * (gtg + 2 * nx * n)
    newton = (grad + build + k1_ops(T_, n) + T_ * n + T_ * n * 11
              + n_ls * (2 * T_ * n + constraints + 5) + 2 * T_ * n)
    al_update = (T_ - 1) * (step + nx * 3) + T_ * nu * 6 + 2
    per_al = constraints + cost_terms + n_newton * newton + al_update
    residual = (T_ - 1) * (step + nx * 3) + T_ * nu * 6 + 1
    return al_iter * per_al + residual


def k2_inputs(B, dtype, seed):
    """Tracking problems like the policy's: x0 in the pendulum env's range,
    a reference that drifts from x0, Cd = (Q, R), c = −Cd·τ_ref."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    x_ref[:, 0] = x0
    u_ref = np.zeros((B, T, NU))
    Cd = np.broadcast_to(np.array([10.0, 1.0, 0.01]), (B, T, N))
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    to = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device="cuda")
    return to(Cd), to(c), to(x0), to(x_ref), to(u_ref)


def phase_k2():
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
                row["ms_events"] = cuda_ms(kern, 20)
                row["ms"] = device_kernel_ms(kern, 10, "al_fused_kernel")
                row["plain_ms"] = cuda_ms(
                    lambda: al_fused_cuda.fused_al_solve_reference(
                        *args, **AL_BUDGET), 3, warmup=1)
                ins = (2 * T * N + NX + T * NX + T * NU + (T - 1) * NX
                       + 2 * T * NU + 1)
                outs = T * N + (T - 1) * NX + 2 * T * NU + 1
                budget = {k: AL_BUDGET[k] for k in
                          ("al_iter", "n_newton", "n_ls")}
                row["bound_ms"], row["bound_by"] = bound(
                    4 * B * (ins + outs), B * k2_ops(T, NX, NU, **budget))
                rows[B] = row
            log("K2", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K2 disagrees with its plain version: "
                                   f"{row}")
    return rows


# ------------------------------------------------------------ policy ----
def phase_policy():
    """One policy forward, float64, on the card vs on the CPU."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import evaluate
    from diff_qp_mpc_tpu_torch.learning.train import make_policy
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    rng = np.random.RandomState(0)
    x = torch.tensor(rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (8, NX)),
                     dtype=torch.float64)
    for fused in (False, True):
        argv = ["--env", "pendulum", "--deq", "--ckpt", CKPT] + (
            ["--fused"] if fused else [])
        args = evaluate.parse_args(argv)
        env = make_env(args.env)
        outs = []
        for device in ("cpu", "cuda"):
            policy = make_policy(args, env)
            policy.load_state_dict(load_policy_params(CKPT))
            policy.to(device=device, dtype=torch.float64)
            with torch.no_grad():
                its, _ = policy(x.to(device))
            outs.append(torch.cat([its[-1].states, its[-1].actions],
                                  -1).cpu())
        err = float((outs[0] - outs[1]).abs().max())
        log("policy", json.dumps(dict(fused=fused, max_abs_err=err,
                                      tol=POLICY_TOL)))
        if not err <= POLICY_TOL:
            raise RuntimeError(f"policy on the card disagrees with the CPU "
                               f"(fused={fused}): {err}")


# --------------------------------------------------------- main path ----
def phase_main_path():
    from diff_qp_mpc_tpu_torch.learning import evaluate
    from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve_cuda

    runs = {}
    for path, flags in (("scan", []), ("fused", ["--fused"])):
        argv = ["--env", "pendulum", "--deq", "--ckpt", CKPT, "--episodes",
                str(EPISODES), "--max_steps", str(MAX_STEPS)] + flags
        btsolve_cuda.launches = 0
        al_fused_cuda.launches = 0
        metrics = evaluate.main(argv)
        counts = {"K1": btsolve_cuda.launches, "K2": al_fused_cuda.launches}
        runs[path] = dict(metrics, launches=counts)
        log("main_path", path, json.dumps(runs[path]))
        need = "K1" if path == "scan" else "K2"
        if counts[need] <= 0:
            raise RuntimeError(f"{path} path launched {need} no time")
        if not np.isfinite(metrics["mean_reward"]):
            raise RuntimeError(f"{path} path: non-finite reward")
        if metrics["success_rate"] < MIN_SUCCESS:
            raise RuntimeError(f"{path} path: success rate "
                               f"{metrics['success_rate']} < {MIN_SUCCESS}")
    return runs


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    from diff_qp_mpc_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    logs = cuda_build.build(["btsolve", "al_fused"])
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "stack" in line:
                log(f"ptxas {name}: {line.strip()}")

    k1 = phase_k1()
    k2 = phase_k2()
    phase_policy()
    runs = phase_main_path()

    main_b = EPISODES  # the batch the main path hands both kernels
    kernels = []
    for name, rows, path, src, replaces in (
            ("btsolve (K1)", k1, "scan",
             "diff_qp_mpc_tpu_torch/csrc/btsolve.cu",
             "diff_qp_mpc_tpu/ops/btsolve_pallas.py:202"),
            ("al_fused (K2)", k2, "fused",
             "diff_qp_mpc_tpu_torch/csrc/al_fused.cu",
             "diff_qp_mpc_tpu/ops/al_fused_pallas.py:340")):
        r = rows[main_b]
        kid = name[-3:-1]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": runs[path]["launches"][kid],
            "max_abs_err": r.get("max_abs_err_xu", r.get("max_abs_err")),
            "tolerance": r["tol"] if kid == "K1" else r["tol"][0],
            "ms": r["ms"] if r["ms"] is not None else r["ms_events"],
            "ms_events": r["ms_events"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"),
            "shape": f"B={main_b} T={T} n={N} float32"})
    log(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
