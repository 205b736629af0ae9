"""Augmented-Lagrangian merit numerics, block-structured (port of
diff_qp_mpc_tpu.ops.almerit: the diagonal-cost merit, and the trajectory
cost of a diagonal or dense quadratic).

Problem:
    min_{x,u}  Σₜ ½ τₜᵀ diag(Cdₜ) τₜ + cₜᵀ τₜ
    s.t.       r_dyn[t] = x[t+1] − f(x[t], u[t]) = 0,  r_init = x[0] − x0 = 0,
               r_hi[t] = u[t] − u_hi ≤ 0,  r_lo[t] = u_lo − u[t] ≤ 0
Merit: M = cost + λᵀ r + (ρ/2)‖r_clamp‖², inequality residuals clamped at 0
inside the penalty. The Gauss-Newton Hessian Q + ρ JᵀJ is assembled
directly as block-tridiagonal D [bsz, T, n, n] / O [bsz, T-1, n, n].
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from diff_qp_mpc_tpu_torch.core.types import (
    Bounds,
    DiagQuadCost,
    Lambdas,
    QuadCost,
)

Tensor = torch.Tensor


class Residuals(NamedTuple):
    r_dyn: Tensor  # [bsz, T-1, nx]
    r_init: Tensor  # [bsz, nx]
    r_hi: Tensor  # [bsz, T, nu]
    r_lo: Tensor  # [bsz, T, nu]

    def clamped(self) -> "Residuals":
        return Residuals(self.r_dyn, self.r_init,
                         torch.clamp(self.r_hi, min=0.0),
                         torch.clamp(self.r_lo, min=0.0))

    def flat_norm(self) -> Tensor:
        bsz = self.r_init.shape[0]
        return torch.linalg.vector_norm(
            torch.cat([p.reshape(bsz, -1) for p in self], dim=-1), dim=-1)


def _bound(v, like: Tensor) -> Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def residuals_from_rollout(x: Tensor, u: Tensor, x0: Tensor, x_next: Tensor,
                           bounds: Bounds) -> Residuals:
    """Residuals when f(x, u) along the trajectory was already evaluated."""
    return Residuals(x[:, 1:] - x_next, x[:, 0] - x0,
                     u - _bound(bounds.u_hi, u), _bound(bounds.u_lo, u) - u)


def residuals(dynamics, x: Tensor, u: Tensor, x0: Tensor,
              bounds: Bounds) -> Residuals:
    """All constraint residuals in one batched dynamics call."""
    bsz, T, nx = x.shape
    nu = u.shape[-1]
    x_next = dynamics(x[:, :-1].reshape(-1, nx), u[:, :-1].reshape(-1, nu))
    return residuals_from_rollout(x, u, x0, x_next.reshape(bsz, T - 1, nx),
                                  bounds)


def compute_cost(cost: Union[DiagQuadCost, QuadCost], xu: Tensor) -> Tensor:
    """Σₜ ½ τᵀCτ + cᵀτ (C = diag(Cd) for a DiagQuadCost). xu: [..., T, n]
    -> [...]; the cost broadcasts against xu's leading axes."""
    if isinstance(cost, QuadCost):
        quad = 0.5 * torch.einsum("...ti,...tij,...tj->...", xu, cost.C, xu)
    else:
        quad = 0.5 * (xu * cost.Cd * xu).sum(dim=(-1, -2))
    return quad + (cost.c * xu).sum(dim=(-1, -2))


def _penalty_and_lagrangian(res: Residuals, lam: Lambdas, rho: Tensor):
    """([bsz] (ρ/2)‖r_clamp‖², [bsz] λᵀr)."""
    bsz = res.r_init.shape[0]
    rc = res.clamped()
    pen = sum((p.reshape(bsz, -1) ** 2).sum(-1) for p in rc)
    lag = ((lam.lam_dyn * res.r_dyn).sum(dim=(-1, -2))
           + (lam.lam_init * res.r_init).sum(-1)
           + (lam.lam_hi * res.r_hi).sum(dim=(-1, -2))
           + (lam.lam_lo * res.r_lo).sum(dim=(-1, -2)))
    return 0.5 * rho[:, 0] * pen, lag


def merit_value(cost: DiagQuadCost, res: Residuals, lam: Lambdas,
                rho: Tensor, xu: Tensor) -> Tensor:
    """[bsz] merit."""
    pen, lag = _penalty_and_lagrangian(res, lam, rho)
    return compute_cost(cost, xu) + pen + lag


def constraint_merit(res: Residuals, lam: Lambdas, rho: Tensor) -> Tensor:
    """[bsz] merit without the cost term."""
    pen, lag = _penalty_and_lagrangian(res, lam, rho)
    return pen + lag


def _jac_T_apply(A: Tensor, B: Tensor, v_dyn: Tensor, v_init: Tensor,
                 v_hi: Tensor, v_lo: Tensor):
    """Jᵀ v without materializing J. Returns (g_x [bsz, T, nx],
    g_u [bsz, T, nu])."""
    bsz, Tm1, nx, _ = A.shape
    nu = B.shape[-1]
    g_x = A.new_zeros(bsz, Tm1 + 1, nx)
    g_u = A.new_zeros(bsz, Tm1 + 1, nu)
    g_x[:, :-1] -= torch.einsum("btji,btj->bti", A, v_dyn)
    g_u[:, :-1] -= torch.einsum("btji,btj->bti", B, v_dyn)
    g_x[:, 1:] += v_dyn
    g_x[:, 0] += v_init
    return g_x, g_u + v_hi - v_lo


def merit_grad_hess(cost: DiagQuadCost, dynamics_jac, x: Tensor, u: Tensor,
                    x0: Tensor, bounds: Bounds, lam: Lambdas, rho: Tensor):
    """Merit gradient [bsz, T, n] and Gauss-Newton Hessian blocks
    D [bsz, T, n, n], O [bsz, T-1, n, n]; also the residuals.

    dynamics_jac(x_flat, u_flat) -> (x_next, (J_x, J_u)) batched.
    """
    bsz, T, nx = x.shape
    nu = u.shape[-1]
    n = nx + nu
    xu = torch.cat([x, u], dim=-1)
    x_next_f, (A_f, B_f) = dynamics_jac(
        x[:, :-1].reshape(-1, nx), u[:, :-1].reshape(-1, nu))
    A = A_f.reshape(bsz, T - 1, nx, nx)
    B = B_f.reshape(bsz, T - 1, nx, nu)
    res = residuals_from_rollout(x, u, x0, x_next_f.reshape(bsz, T - 1, nx),
                                 bounds)
    rc = res.clamped()
    m_hi = (res.r_hi > 0).to(x.dtype)
    m_lo = (res.r_lo > 0).to(x.dtype)

    # gradient: cost' + Jᵀλ + ρ J_clampᵀ r_clamp
    gx_l, gu_l = _jac_T_apply(A, B, lam.lam_dyn, lam.lam_init, lam.lam_hi,
                              lam.lam_lo)
    gx_p, gu_p = _jac_T_apply(A, B, rc.r_dyn, rc.r_init, m_hi * rc.r_hi,
                              m_lo * rc.r_lo)
    grad = (cost.Cd * xu + cost.c + torch.cat([gx_l, gu_l], dim=-1)
            + rho[:, :, None] * torch.cat([gx_p, gu_p], dim=-1))

    # GN Hessian: cost Hessian + ρ J_clampᵀ J_clamp; GᵀG with G = [-A, -B]
    G = torch.cat([A, B], dim=-1)  # [bsz, T-1, nx, n]
    JtJ = x.new_zeros(bsz, T, n, n)
    JtJ[:, :-1] += G.transpose(-1, -2) @ G
    idx_x = torch.arange(nx, device=x.device)
    idx_u = torch.arange(nx, n, device=x.device)
    # one [I 0; 0 0] per stage: r_dyn[t-1] on x_t (t ≥ 1), r_init on x_0
    JtJ[:, :, idx_x, idx_x] += 1.0
    JtJ[:, :, idx_u, idx_u] += m_hi + m_lo  # active bound rows
    D = torch.diag_embed(cost.Cd) + rho[:, :, None, None] * JtJ

    # subdiagonal (JᵀJ)[t+1, t]: rows x: [-A, -B], rows u: 0
    O = torch.cat([-G, x.new_zeros(bsz, T - 1, nu, n)], dim=-2)
    O = rho[:, :, None, None] * O
    return grad, D, O, res


def lambda_update(lam: Lambdas, res: Residuals, rho: Tensor) -> Lambdas:
    """λ ← λ + ρ·r, inequality multipliers clamped ≥ 0."""
    r = rho[:, :, None]
    return Lambdas(
        lam_dyn=lam.lam_dyn + r * res.r_dyn,
        lam_init=lam.lam_init + rho * res.r_init,
        lam_hi=torch.clamp(lam.lam_hi + r * res.r_hi, min=0.0),
        lam_lo=torch.clamp(lam.lam_lo + r * res.r_lo, min=0.0),
    )
