"""OptNet-style demo: learn a QP layer's parameters by gradient descent
(port of examples/optnet_qp_layer.py).

A differentiable QP layer whose linear cost p = W x is trained so that its
argmin matches targets made by a ground-truth W*: the implicit backward
through the interior-point solve (``solvers.qp.qp_layer``) at every step.
bsz 64, nz 4, nineq 6 (a fixed strictly feasible polytope), neq 0, d_in 3,
QP max_iter 15, Adam at 5e-2 for 150 steps.

    python -m diff_qp_mpc_tpu_torch.examples.optnet_qp_layer [--device cpu]

It runs on the card unless ``--device cpu`` is given (without a card it
raises), in float64 unless ``--dtype float32``, and fails unless the final
loss is below 1e-3.
"""
from __future__ import annotations

import argparse
import time

import torch

from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig, qp_layer
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

BSZ, NZ, NINEQ, D_IN = 64, 4, 6, 3
CFG = QPConfig(max_iter=15)
LR = 5e-2


def make_problem(seed: int = 0, dtype=torch.float64, device="cpu"):
    """(the QP's fixed (Q, G, h, A, b), the inputs x_in, the targets
    z_target = argmin with p = W* x, the initial W) from a seeded
    torch.Generator."""
    gen = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)
    G1, W_true, x_in, W0 = (randn(NINEQ, NZ), randn(NZ, D_IN),
                            randn(BSZ, D_IN), 0.1 * randn(NZ, D_IN))
    kw = dict(dtype=dtype, device=device)
    qp = (torch.eye(NZ, **kw).expand(BSZ, NZ, NZ),
          G1.to(**kw).expand(BSZ, NINEQ, NZ),
          torch.full((BSZ, NINEQ), 2.0, **kw),
          torch.zeros(BSZ, 0, NZ, **kw), torch.zeros(BSZ, 0, **kw))
    x_in = x_in.to(**kw)
    with torch.no_grad():
        z_target = qp_layer(qp[0], x_in @ W_true.to(**kw).T, *qp[1:], CFG)
    return qp, x_in, z_target, W0.to(**kw)


def loss_fn(W, qp, x_in, z_target):
    """mean (z(W) − z_target)², z(W) the argmin with p = W x."""
    Q, G, h, A, b = qp
    z = qp_layer(Q, x_in @ W.T, G, h, A, b, CFG)
    return ((z - z_target) ** 2).mean()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float64", "float32"),
                    default="float64")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    qp, x_in, z_target, W0 = make_problem(args.seed, dtype, device)
    W = W0.clone().requires_grad_(True)
    opt = torch.optim.Adam([W], lr=LR)
    t0 = time.perf_counter()
    for i in range(args.iters):
        opt.zero_grad()
        loss = loss_fn(W, qp, x_in, z_target)
        loss.backward()
        opt.step()
        if i % 25 == 0:
            print(f"iter {i:4d} loss {float(loss.detach()):.6f}", flush=True)
    final = float(loss.detach())
    seconds = time.perf_counter() - t0
    print(f"final loss {final:.6f} (target scale "
          f"{float((z_target ** 2).mean()):.3f}); "
          f"{1e3 * seconds / args.iters:.2f} ms per step", flush=True)
    if not final < 1e-3:
        raise RuntimeError(f"did not learn the QP layer mapping: loss "
                           f"{final}")
    print("OK: learned argmin mapping through the implicit QP backward")
    return dict(final_loss=final, ms_per_step=1e3 * seconds / args.iters)


if __name__ == "__main__":
    main()
