"""Dense vs Q-prefactored PDIPM of the OptNet QP layer at the reference's
profiling size (port of benchmarks/prof_qp_sizes.py; qpth's
prof-gurobi.py:37-50: nz = 100, nineq = 100, neq = 0, bsz ∈ {1, 64, 128}).

Per batch size and solver ("dense": one LU of the 300×300 KKT matrix per
IPM iteration; "prefactor": Q's Cholesky once and a 100×100 Schur
Cholesky per iteration): ms per solve (``qp_solve``) and per forward plus
backward (``qp_layer`` and the gradients of all six inputs), each from
CUDA events queued behind a spin kernel (``timing.queued_events_ms``:
device time where the device is the bottleneck, the host's enqueue time
where that is longer), and the mean residual total. The problems are the
JAX script's distribution (Q = LLᵀ + 1e-3·I with L uniform, h = G z0 + s0)
drawn from numpy (seed 0 folded with the batch size), float64 by default.

    python -m diff_qp_mpc_tpu_torch.benchmarks.prof_qp_sizes [--dtype float32]

Prints one JSON line. It measures the card: without one (or with
``--device cpu``) it raises.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks.timing import queued_events_ms
from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig, qp_layer, qp_solve
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

BATCHES = (1, 64, 128)
SOLVERS = ("dense", "prefactor")


def problem(bsz, nz=100, nineq=100, neq=0, dtype=torch.float64,
            device="cpu", seed=0):
    """(Q, p, G, h, A, b) of the reference's profiling distribution, with
    ``neq`` equality rows through the same feasible point (b = A z0)."""
    rng = np.random.RandomState(seed + bsz)
    L = rng.uniform(size=(bsz, nz, nz))
    Q = L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(nz)
    G = rng.randn(bsz, nineq, nz)
    z0 = rng.randn(bsz, nz)
    s0 = rng.uniform(size=(bsz, nineq))
    p = rng.randn(bsz, nz)
    A = rng.randn(bsz, neq, nz)
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in (
        Q, p, G, np.einsum("bij,bj->bi", G, z0) + s0, A,
        np.einsum("bij,bj->bi", A, z0)))


def forward_backward(args, cfg):
    """z of the layer and the gradients of Σ z w.r.t. all six inputs."""
    ins = [a.detach().requires_grad_(True) for a in args]
    z = qp_layer(*ins, cfg)
    return (z,) + torch.autograd.grad(z.sum(), ins)


def measure(device, dtype=torch.float64, batches=BATCHES, nz=100,
            nineq=100, reps=5) -> dict:
    """ms per solve and per forward plus backward, by solver and batch."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("prof_qp_sizes times the card; it has no CPU "
                           "mode")
    out = dict(nz=nz, nineq=nineq, neq=0, dtype=str(dtype),
               device=torch.cuda.get_device_name(device))
    for bsz in batches:
        args = problem(bsz, nz, nineq, 0, dtype, device)
        for solver in SOLVERS:
            cfg = QPConfig(solver=solver)
            key = f"{solver}_bsz{bsz}"
            out[f"{key}_ms"] = queued_events_ms(lambda: qp_solve(*args, cfg),
                                                reps)
            out[f"{key}_fwd_bwd_ms"] = queued_events_ms(
                lambda: forward_backward(args, cfg), reps)
            out[f"{key}_resid"] = float(qp_solve(*args, cfg).resids.mean())
        out[f"speedup_bsz{bsz}"] = (out[f"dense_bsz{bsz}_ms"]
                                    / out[f"prefactor_bsz{bsz}_ms"])
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", choices=("float64", "float32"),
                   default="float64")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--nz", type=int, default=100)
    p.add_argument("--nineq", type=int, default=100)
    p.add_argument("--device", type=str, default=None,
                   help="default: the GPU (the timing raises without one)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out = measure(device, getattr(torch, args.dtype), nz=args.nz,
                  nineq=args.nineq, reps=args.reps)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
