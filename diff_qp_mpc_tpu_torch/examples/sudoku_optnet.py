"""OptNet Sudoku: learn the rules of 4×4 Sudoku as QP constraints (port of
examples/sudoku_optnet.py).

Puzzles are one-hot encoded z ∈ R^{4·4·4}; the layer solves

    min ½ε‖z‖² − inputᵀ z   s.t.  A z = b,  0 ≤ z ≤ 1

and A, b (neq 40 learned rows, shared by the batch) are LEARNED from
solved puzzles by differentiating through the QP solution: the dA and db
of the implicit backward (``solvers.qp.qp_layer``), reduced over the
batch by autograd since A and b are broadcast to it. The JAX example's
sizes: nz 64, nineq 128, bsz 24 puzzles with 8 hints each (16 held out),
QP max_iter 18, ε 0.1, Adam at 2e-3 for 200 steps, float32. The puzzles
come from numpy's RandomState(0) as in the JAX example (the same boards);
the initial A from a seeded torch.Generator.

    python -m diff_qp_mpc_tpu_torch.examples.sudoku_optnet [--device cpu]

It runs on the card unless ``--device cpu`` is given (without a card it
raises) and fails unless the last loss is below half the first.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig, qp_layer
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

N = 4  # 4x4 sudoku, 2x2 boxes
NZ = N * N * N  # one-hot cube
EPS = 0.1
CFG = QPConfig(max_iter=18)
LR = 2e-3


def random_solved_sudoku(rng: np.random.RandomState) -> np.ndarray:
    """A random solved 4×4 sudoku: the shifted-base pattern with digit,
    band-row and stack-column permutations."""
    base = np.array([[0, 1, 2, 3], [2, 3, 0, 1], [1, 0, 3, 2], [3, 2, 1, 0]])
    grid = rng.permutation(N)[base]
    rows = np.concatenate([rng.permutation(2), 2 + rng.permutation(2)])
    cols = np.concatenate([rng.permutation(2), 2 + rng.permutation(2)])
    return grid[rows][:, cols]


def one_hot(grid: np.ndarray) -> np.ndarray:
    z = np.zeros((N, N, N), np.float32)
    for i in range(N):
        for j in range(N):
            z[i, j, grid[i, j]] = 1.0
    return z.reshape(-1)


def make_dataset(n_samples: int, n_hints: int, rng: np.random.RandomState):
    """(hints, solutions) [n_samples, NZ] float32 numpy arrays."""
    inputs, targets = [], []
    for _ in range(n_samples):
        grid = random_solved_sudoku(rng)
        mask = np.zeros((N, N), bool)
        idx = rng.choice(N * N, n_hints, replace=False)
        mask[np.unravel_index(idx, (N, N))] = True
        inputs.append(one_hot(grid) * np.repeat(mask.reshape(-1), N))
        targets.append(one_hot(grid))
    return np.stack(inputs), np.stack(targets)


def box_rows(dtype=torch.float32, device="cpu"):
    """G, h of 0 ≤ z ≤ 1: [2·NZ, NZ], [2·NZ]."""
    eye = torch.eye(NZ, dtype=dtype, device=device)
    return (torch.cat([eye, -eye]),
            torch.cat([torch.ones(NZ, dtype=dtype, device=device),
                       torch.zeros(NZ, dtype=dtype, device=device)]))


def solve_batch(A_p, b_p, inputs, G1, h1):
    """The layer's z [bsz, NZ] for hints ``inputs`` under the learned
    (A_p, b_p), every QP parameter broadcast to the batch."""
    bsz, neq = inputs.shape[0], A_p.shape[0]
    Q = (EPS * torch.eye(NZ, dtype=inputs.dtype,
                         device=inputs.device)).expand(bsz, NZ, NZ)
    return qp_layer(Q, -inputs, G1.expand(bsz, *G1.shape),
                    h1.expand(bsz, *h1.shape), A_p.expand(bsz, neq, NZ),
                    b_p.expand(bsz, neq), CFG)


def loss_fn(A_p, b_p, X, Z, G1, h1):
    return ((solve_batch(A_p, b_p, X, G1, h1) - Z) ** 2).mean()


def cell_accuracy(A_p, b_p, X, Z, G1, h1) -> float:
    with torch.no_grad():
        z = solve_batch(A_p, b_p, X, G1, h1)
    pred = z.reshape(-1, N * N, N).argmax(-1)
    true = Z.reshape(-1, N * N, N).argmax(-1)
    return float((pred == true).to(torch.float64).mean())


def initial_params(neq: int, seed: int = 0):
    """A_p = 0.1·randn(neq, NZ) from a seeded torch.Generator, b_p = 0.5,
    float64 (cast by the caller)."""
    gen = torch.Generator().manual_seed(seed)
    return (0.1 * torch.randn(neq, NZ, generator=gen, dtype=torch.float64),
            torch.full((neq,), 0.5, dtype=torch.float64))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--bsz", type=int, default=24)
    ap.add_argument("--neq", type=int, default=40,
                    help="learned constraint rows")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kw = dict(dtype=torch.float32, device=device)

    rng = np.random.RandomState(0)
    X, Z = (torch.tensor(a, **kw) for a in make_dataset(args.bsz, 8, rng))
    Xv, Zv = (torch.tensor(a, **kw) for a in make_dataset(16, 8, rng))
    G1, h1 = box_rows(**kw)
    A_p, b_p = (a.to(**kw).requires_grad_(True)
                for a in initial_params(args.neq, args.seed))
    opt = torch.optim.Adam([A_p, b_p], lr=LR)

    loss0 = None
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(args.iters):
        opt.zero_grad()
        loss = loss_fn(A_p, b_p, X, Z, G1, h1)
        loss.backward()
        opt.step()
        if loss0 is None:
            loss0 = float(loss.detach())
        if i % 25 == 0:
            acc = cell_accuracy(A_p, b_p, Xv, Zv, G1, h1)
            print(f"iter {i:4d} loss {float(loss.detach()):.5f} val "
                  f"cell-accuracy {acc:.3f}", flush=True)
    lossN = float(loss.detach())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ms = 1e3 * (time.perf_counter() - t0) / args.iters
    acc = cell_accuracy(A_p, b_p, Xv, Zv, G1, h1)
    print(f"loss {loss0:.5f} -> {lossN:.5f}; held-out cell accuracy "
          f"{acc:.3f}; {ms:.2f} ms per iteration", flush=True)
    if not lossN < 0.5 * loss0:
        raise RuntimeError(f"the loss did not halve: {loss0} -> {lossN}")
    print("OK: learned sudoku constraints through dA/db implicit gradients")
    return dict(loss0=loss0, lossN=lossN, val_cell_accuracy=acc,
                ms_per_iteration=ms, iters=args.iters)


if __name__ == "__main__":
    main()
