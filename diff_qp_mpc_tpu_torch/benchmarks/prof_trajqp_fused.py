"""The fused trajectory-QP IPM kernel K4 against the scan IPM (Riccati
solves by K3) on the card (port of benchmarks/prof_trajqp_fused.py).

The JAX script's problem (numpy seed 0; float32, T 5, 12 Mehrotra
iterations, reg 1e-7, box ±1.5) and cases: B 4096 and 16384 at
(nx, nu) = (2, 1), B 4096 at (4, 1). Each path is timed with the shared
protocol (``benchmarks.timing.steady_state``): the scan IPM and the fused
path as ``trajqp.solve`` calls (as the JAX script times them), and K4's own
call without the cold start's preparation around it. Per case it prints
the max |u| disagreement of the two paths (the JAX script saw ≤ 1.4e-3 on
its chip), ms per solve, solves/s, the speedup, and K4's bound with its
share of K4's own time.

    python -m diff_qp_mpc_tpu_torch.benchmarks.prof_trajqp_fused

It measures the card and has no CPU mode: without a CUDA device it raises.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks import flops
from diff_qp_mpc_tpu_torch.benchmarks.roofline_fused import check_frac
from diff_qp_mpc_tpu_torch.benchmarks.timing import steady_state
from diff_qp_mpc_tpu_torch.core.types import Bounds
from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda
from diff_qp_mpc_tpu_torch.solvers import trajqp
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

#: (B, T, nx, nu)
CASES = ((4096, 5, 2, 1), (16384, 5, 2, 1), (4096, 5, 4, 1))
MAX_ITER, REG, BOX = 12, 1e-7, 1.5


def problem_arrays(B, T, nx, nu):
    """(C, c, A, Bm, f, x0) as numpy arrays, drawn as the JAX script draws
    them (seed 0)."""
    n = nx + nu
    rng = np.random.RandomState(0)
    Cd = np.concatenate([np.full(nx, 10.0), np.full(nu, 0.1)])
    C = np.broadcast_to(np.diag(Cd), (B, T, n, n))
    c = 0.3 * rng.randn(B, T, n)
    A = np.broadcast_to(np.eye(nx) + 0.05, (B, T - 1, nx, nx))
    Bm = 0.2 * rng.randn(B, T - 1, nx, nu)
    f = 0.05 * rng.randn(B, T - 1, nx)
    x0 = 0.4 * rng.randn(B, nx)
    return C, c, A, Bm, f, x0


def problem(B, T, nx, nu, dtype=torch.float32, device="cuda"):
    """(C, c, A, Bm, f, x0) as tensors on the card (or ``device``), and
    the box."""
    return ([torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
             for a in problem_arrays(B, T, nx, nu)],
            Bounds(u_lo=(-BOX,) * nu, u_hi=(BOX,) * nu))


def cold_start(C, c, A, Bm, f, x0):
    """(x_init, u_init) as ``trajqp.solve`` hands them to K4 without a warm
    start: u at the box midpoint (0), x its affine rollout."""
    u = torch.zeros(Bm.shape[0], Bm.shape[1] + 1, Bm.shape[3],
                    dtype=C.dtype, device=C.device)
    return trajqp._affine_rollout(A, Bm, f, x0, u), u


def solve_u(args, bounds, kernel, max_iter=MAX_ITER):
    """u of ``trajqp.solve`` on the scan IPM or the fused path."""
    cfg = trajqp.TrajQPConfig(max_iter=max_iter, reg=REG, kernel=kernel)
    return trajqp.solve(*args, bounds, cfg).u


def bench(B, T, nx, nu, max_iter=MAX_ITER, n_rep=10, n_outer=5):
    """One case on the card, float32: both paths and K4's own call timed,
    their u compared, K4's bound. Returns the case's record."""
    args, bounds = problem(B, T, nx, nu)
    runs = {kern: lambda kern=kern: solve_u(args, bounds, kern, max_iter)
            for kern in ("scan", "fused")}
    x_init, u_init = cold_start(*args)
    runs["k4"] = lambda: trajqp_fused_cuda.fused_trajqp_solve(
        *args, x_init, u_init, bounds.u_lo, bounds.u_hi, max_iter=max_iter,
        reg=REG)[1]
    st, u = {}, {}
    for name, run in runs.items():
        u[name] = run()
        st[name] = steady_state(run, n_rep=n_rep, n_outer=n_outer)
    t = {name: s["per_call_s_median"] for name, s in st.items()}
    bound_ms, bound_by = flops.bound(
        B * flops.k4_bytes(T, nx, nu), B * flops.k4_ops(T, nx, nu, max_iter))
    return {"B": B, "T": T, "nx": nx, "nu": nu, "max_iter": max_iter,
            "max_abs_u_diff": float((u["fused"] - u["scan"]).abs().max()),
            "scan_ms": t["scan"] * 1e3, "fused_ms": t["fused"] * 1e3,
            "k4_ms": t["k4"] * 1e3, "scan_solves_per_s": B / t["scan"],
            "fused_solves_per_s": B / t["fused"],
            "k4_solves_per_s": B / t["k4"], "speedup": t["scan"] / t["fused"],
            "k4_bound_ms": bound_ms, "k4_bound_by": bound_by,
            "k4_bound_share": check_frac("k4_bound_share",
                                         bound_ms / (t["k4"] * 1e3)),
            "spread_max_over_min": max(s["spread_max_over_min"]
                                       for s in st.values())}


def main(argv=None):
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    resolve_device()
    rows = []
    for case in CASES:
        row = bench(*case)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
