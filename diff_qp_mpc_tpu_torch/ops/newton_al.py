"""Damped Newton solver on the AL merit (port of
diff_qp_mpc_tpu.ops.newton_al): a fixed number of Newton steps, each a
block-tridiagonal Cholesky solve and a batched 2⁻ᵏ line search."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from diff_qp_mpc_tpu_torch.core.types import Bounds, Lambdas
from diff_qp_mpc_tpu_torch.ops import almerit, btsolve_cuda

Tensor = torch.Tensor


def kkt_solver(kernel: str = "auto"):
    """The block-tridiagonal solve D, O, g, reg -> x. "auto" (the only
    choice): kernel K1 for CUDA tensors, its plain PyTorch version for CPU
    tensors (the wrapper decides by the tensors' device)."""
    if kernel != "auto":
        raise ValueError(f"kernel must be 'auto', got {kernel!r}")
    return btsolve_cuda.batched_factor_solve


class NewtonResult(NamedTuple):
    xu: Tensor  # [bsz, T, n]
    merit: Tensor  # [bsz]
    status: Tensor  # [bsz] 1.0 where the last line search improved the merit
    step_size: Tensor  # [bsz] last accepted step size
    # the pinned GN Hessian blocks at the solution (for the implicit
    # backward), only when asked for
    D: Optional[Tensor] = None  # [bsz, T, n, n]
    O: Optional[Tensor] = None  # [bsz, T-1, n, n]


def _merit_at(cost, dynamics, xu, x0, bounds, lam, rho):
    nx = x0.shape[-1]
    res = almerit.residuals(dynamics, xu[..., :nx], xu[..., nx:], x0, bounds)
    return almerit.merit_value(cost, res, lam, rho, xu)


def line_search(cost, dynamics, xu, update, merit, x0, bounds, lam, rho,
                n_ls: int = 20):
    """Batched 2⁻ᵏ sweep over n_ls candidates with x₀ pinned.

    Returns (xu_new, merit_new, step_size, status). NaN merits lose the
    argmin (they become +inf) and the incumbent is kept exactly unless the
    best candidate strictly improves the merit; the first minimum wins.
    """
    bsz, T, n = xu.shape
    nx = x0.shape[-1]
    steps = 2.0 ** (-torch.arange(n_ls, dtype=xu.dtype, device=xu.device))
    cand = xu[None] + steps[:, None, None, None] * update[None]
    cand[:, :, 0, :nx] = x0[None]
    merits = _merit_at(
        _tile_cost(cost, n_ls), dynamics, cand.reshape(n_ls * bsz, T, n),
        x0.repeat(n_ls, 1), bounds, lam.map(lambda a: a.repeat(
            (n_ls,) + (1,) * (a.ndim - 1))), rho.repeat(n_ls, 1),
    ).reshape(n_ls, bsz)
    merits = torch.where(torch.isnan(merits), float("inf"), merits)
    merit_best, best = merits.min(dim=0)
    xu_best = cand[best, torch.arange(bsz, device=xu.device)]
    step = steps[best]
    improved = merit_best < merit
    xu_new = torch.where(improved[:, None, None], xu_best, xu)
    merit_new = torch.where(improved, merit_best, merit)
    return xu_new, merit_new, step, improved.to(xu.dtype)


def _tile_cost(cost, k: int):
    return type(cost)(Cd=cost.Cd.repeat(k, 1, 1), c=cost.c.repeat(k, 1, 1))


def pin_first_state(grad: Tensor, D: Tensor, O: Tensor, nx: int):
    """Project the x₀ coordinates out of the Newton system: zero their
    gradient rows and Hessian rows/columns, identity on their diagonal, so
    the direction has d_{x₀} = 0 exactly."""
    grad = grad.clone()
    D = D.clone()
    O = O.clone()
    grad[:, 0, :nx] = 0.0
    D[:, 0, :nx, :] = 0.0
    D[:, 0, :, :nx] = 0.0
    idx = torch.arange(nx, device=D.device)
    D[:, 0, idx, idx] = 1.0
    O[:, 0, :, :nx] = 0.0
    return grad, D, O


def newton_al(cost, dynamics, dynamics_jac, xu0: Tensor, x0: Tensor,
              bounds: Bounds, lam: Lambdas, rho: Tensor,
              n_newton: int = 4, n_ls: int = 20, reg: float = 1e-8,
              final_blocks: bool = False) -> NewtonResult:
    """n_newton damped Newton steps on the AL merit. xu0: [bsz, T, n].
    With ``final_blocks`` the result also holds the pinned Hessian blocks
    D, O at the solution (one more ``merit_grad_hess`` with the same λ, ρ),
    which the implicit backward solves with."""
    bsz = xu0.shape[0]
    nx = x0.shape[-1]
    solve_fn = kkt_solver()
    xu = xu0.clone()
    xu[:, 0, :nx] = x0  # enforce the initial-state equality from the start
    merit = _merit_at(cost, dynamics, xu, x0, bounds, lam, rho)
    step = status = xu.new_ones(bsz)
    for _ in range(n_newton):
        grad, D, O, _ = almerit.merit_grad_hess(
            cost, dynamics_jac, xu[..., :nx], xu[..., nx:], x0, bounds, lam,
            rho)
        grad, D, O = pin_first_state(grad, D, O, nx)
        update = -solve_fn(D, O, grad, reg)
        xu, merit, step, status = line_search(
            cost, dynamics, xu, update, merit, x0, bounds, lam, rho, n_ls)
    D = O = None
    if final_blocks:
        D, O = final_pinned_blocks(cost, dynamics_jac, xu, x0, bounds, lam,
                                   rho)
    return NewtonResult(xu=xu, merit=merit, status=status, step_size=step,
                        D=D, O=O)


def final_pinned_blocks(cost, dynamics_jac, xu: Tensor, x0: Tensor,
                        bounds: Bounds, lam: Lambdas, rho: Tensor):
    """The pinned GN Hessian blocks (D, O) of the merit at ``xu``."""
    nx = x0.shape[-1]
    g, D, O, _ = almerit.merit_grad_hess(
        cost, dynamics_jac, xu[..., :nx], xu[..., nx:], x0, bounds, lam, rho)
    _, D, O = pin_first_state(g, D, O, nx)
    return D.contiguous(), O.contiguous()
