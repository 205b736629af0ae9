"""SQP MPC with a rollout line search (port of
diff_qp_mpc_tpu.solvers.sqp_mpc, forward solves).

Outer loop: linearize the dynamics along the current trajectory, solve one
box-constrained trajectory QP in absolute variables (``solvers.trajqp``),
and accept the step by a rollout line search: u ← u + αΔu, x ← rollout(x0,
u) under the true nonlinear dynamics, every α = decay^j candidate rolled out
in one batched call and the largest improving one taken. A final QP at the
best iterate gives the direction of one last line search, whose rollout is
the returned value. The SQP iterations and line searches run without
autograd; the gradient is the final QP's implicit sensitivity
(``trajqp.traj_qp_layer``) w.r.t. the cost and x0, passed straight through
onto the returned value: w_value + (w_hat − w_hat.detach()), which is NaN
wherever the final QP's w_hat is not finite, as in the JAX package.

A slew-rate penalty s·‖u_t − u_{t−1}‖² is solved over the augmented state
x̃ = [x, u_prev] (``models.base.SlewAugmented``), which keeps the cost
stage-separable: the trajectory QP then runs at (T, nx + nu, nu).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from diff_qp_mpc_tpu_torch.core.types import (
    Bounds,
    DiagQuadCost,
    LinDx,
    QuadCost,
)
from diff_qp_mpc_tpu_torch.models.base import DynamicsModel, SlewAugmented
from diff_qp_mpc_tpu_torch.ops import almerit
from diff_qp_mpc_tpu_torch.ops.riccati import mv
from diff_qp_mpc_tpu_torch.solvers import trajqp
from diff_qp_mpc_tpu_torch.solvers.trajqp import TrajQPConfig

Tensor = torch.Tensor
Cost = Union[QuadCost, DiagQuadCost]


@dataclasses.dataclass(frozen=True)
class SQPConfig:
    """Reference defaults: qp_iter 10, line-search decay 0.2, 10 steps."""

    qp_iter: int = 10
    ls_decay: float = 0.2
    max_ls: int = 10
    qp: TrajQPConfig = TrajQPConfig()


class SQPResult(NamedTuple):
    x: Tensor
    u: Tensor
    cost: Tensor  # [bsz] final trajectory cost
    alpha: Tensor  # [bsz] last accepted line-search step of the SQP loop
    qp_resid: Tensor  # [bsz] last QP residual of the SQP loop


def _dense_cost(cost: Cost, bsz: int, T: int, n: int) -> QuadCost:
    if isinstance(cost, DiagQuadCost):
        return QuadCost(C=torch.diag_embed(cost.Cd.expand(bsz, T, n)),
                        c=cost.c.expand(bsz, T, n))
    return QuadCost(C=cost.C.expand(bsz, T, n, n), c=cost.c.expand(bsz, T, n))


def _linearize(dynamics, x: Tensor, u: Tensor):
    """(A, B, f) with f the affine offset at the linearization point:
    x_{t+1} ≈ A x_t + B u_t + f_t, f = f(x̄, ū) − A x̄ − B ū."""
    if isinstance(dynamics, LinDx):
        nx = dynamics.F.shape[-2]
        return dynamics.F[..., :nx], dynamics.F[..., nx:], dynamics.f
    x_next, A, B = dynamics.linearize(x, u)
    return A, B, x_next - mv(A, x[:, :-1]) - mv(B, u[:, :-1])


def _rollout(dynamics, x0: Tensor, u: Tensor) -> Tensor:
    if isinstance(dynamics, LinDx):
        xs = [x0]
        for t in range(dynamics.F.shape[1]):
            xs.append(mv(dynamics.F[:, t], torch.cat([xs[-1], u[:, t]], -1))
                      + dynamics.f[:, t])
        return torch.stack(xs, dim=1)
    return dynamics.rollout(x0, u)


def line_search(dynamics, cost: QuadCost, x: Tensor, u: Tensor, dx: Tensor,
                du: Tensor, x0: Tensor, cost_cur: Tensor, decay: float,
                max_ls: int):
    """All candidates α = decay^j, j < max_ls, rolled out in one batch; the
    largest α whose cost beats ``cost_cur`` wins, and if none does, the last
    (smallest) candidate is taken. Returns (x, u, α, cost) [bsz, ...]."""
    bsz, T, nx = x.shape
    nu = u.shape[-1]
    alphas = decay ** torch.arange(max_ls, dtype=x.dtype, device=x.device)
    u_cand = u[None] + alphas[:, None, None, None] * du[None]  # [L,bsz,T,nu]
    x_cand = _rollout_candidates(dynamics, x0, u_cand)
    costs = almerit.compute_cost(cost, torch.cat([x_cand, u_cand], dim=-1))
    improving = costs < cost_cur[None]  # [L, bsz]
    first_improving = torch.argmax(improving.to(torch.int8), dim=0)
    idx = torch.where(improving.any(dim=0), first_improving, max_ls - 1)
    pick = lambda a: torch.gather(
        a, 0, idx.reshape((1, bsz) + (1,) * (a.ndim - 2)).expand(
            (1,) + a.shape[1:]))[0]
    return pick(x_cand), pick(u_cand), alphas[idx], pick(costs)


def _rollout_candidates(dynamics, x0: Tensor, u_cand: Tensor) -> Tensor:
    """Rollouts of [L, bsz, T, nu] candidate controls, folded into one
    batch of L·bsz trajectories."""
    L, bsz, T, nu = u_cand.shape
    if isinstance(dynamics, LinDx):
        rep = lambda a: a.repeat((L,) + (1,) * (a.ndim - 1))
        dynamics = LinDx(F=rep(dynamics.F), f=rep(dynamics.f))
    x = _rollout(dynamics, x0.repeat(L, 1), u_cand.reshape(L * bsz, T, nu))
    return x.reshape(L, bsz, T, -1)


def _augment_slew(dynamics, dcost: QuadCost, x0: Tensor, u_init: Tensor,
                  x_init: Optional[Tensor], slew: float,
                  prev_ctrl: Optional[Tensor]):
    """The problem over x̃ = [x, u_prev]: the slew penalty s·‖u_t − u_{t−1}‖²
    as a stage quadratic of [x, u_prev, u] (the reference's SlewRateCost /
    slew_rate_penalty, qp_wrapper.py:30-57,442-457), none at t = 0 unless
    ``prev_ctrl`` is given (u_prev then starts at it, else at 0). Returns
    (SlewAugmented(dynamics), the augmented QuadCost, x̃0, x̃_init, whose
    u_prev history is u_init shifted by one)."""
    bsz, T, nu = u_init.shape
    nx = x0.shape[-1]
    na = nx + 2 * nu  # [x, u_prev, u]
    xs, up, us = slice(0, nx), slice(nx, nx + nu), slice(nx + nu, na)
    kw = dict(dtype=dcost.C.dtype, device=dcost.C.device)
    C = torch.zeros(bsz, T, na, na, **kw)
    C[:, :, xs, xs] = dcost.C[:, :, :nx, :nx]
    C[:, :, xs, us] = dcost.C[:, :, :nx, nx:]
    C[:, :, us, xs] = dcost.C[:, :, nx:, :nx]
    C[:, :, us, us] = dcost.C[:, :, nx:, nx:]
    s_t = torch.full((T,), slew, **kw)
    if prev_ctrl is None:
        s_t[0] = 0.0
    sI = s_t[:, None, None] * torch.eye(nu, **kw)  # [T, nu, nu]
    C[:, :, up, up] += sI
    C[:, :, us, us] += sI
    C[:, :, up, us] += -sI
    C[:, :, us, up] += -sI
    c = torch.zeros(bsz, T, na, **kw)
    c[:, :, xs] = dcost.c[:, :, :nx]
    c[:, :, us] = dcost.c[:, :, nx:]

    u_prev0 = (torch.as_tensor(prev_ctrl, dtype=x0.dtype,
                               device=x0.device).expand(bsz, nu)
               if prev_ctrl is not None else x0.new_zeros(bsz, nu))
    x0_a = torch.cat([x0, u_prev0], dim=-1)
    x_init_a = None
    if x_init is not None:
        up_hist = torch.cat([u_prev0[:, None], u_init[:, :-1]], dim=1)
        x_init_a = torch.cat([x_init, up_hist], dim=-1)
    return SlewAugmented(dynamics), QuadCost(C=C, c=c), x0_a, x_init_a


def solve(dynamics: Union[DynamicsModel, LinDx], cost: Cost, x0: Tensor,
          bounds: Bounds, u_init: Tensor, x_init: Optional[Tensor] = None,
          cfg: SQPConfig = SQPConfig(), differentiable: bool = True,
          slew_rate_penalty: Optional[float] = None,
          prev_ctrl: Optional[Tensor] = None,
          x_goal: Optional[Tensor] = None, goal_weight: float = 1e6
          ) -> SQPResult:
    """Batched SQP MPC solve. u_init [bsz, T, nu] warm start; x_init
    optional, the first linearization point only (the line search's
    incumbent is always the feasible rollout of u_init). ``x_goal`` adds
    the terminal penalty goal_weight·‖x_T − g‖². ``differentiable`` selects
    the JAX package's final-QP branch: True solves the final QP cold through
    the differentiable layer (gradients to the cost and x0); False
    warm-starts it from the best iterate, without a gradient. The
    linearizations are detached. ``slew_rate_penalty`` (with ``prev_ctrl``
    the control before u_0) adds s·‖u_t − u_{t−1}‖² by state augmentation
    (``_augment_slew``; the goal term is applied first and rides along in
    the augmented x-block); affine (LinDx) dynamics ignore it, as in the
    JAX package.
    """
    bsz, T, nu = u_init.shape
    nx = x0.shape[-1]
    dcost = _dense_cost(cost, bsz, T, nx + nu)
    if x_goal is not None:
        g = torch.as_tensor(x_goal, dtype=dcost.c.dtype,
                            device=dcost.c.device).expand(bsz, nx)
        C, c = dcost.C.clone(), dcost.c.clone()
        C[:, -1, :nx, :nx] += goal_weight * torch.eye(nx, dtype=C.dtype,
                                                      device=C.device)
        c[:, -1, :nx] -= goal_weight * g
        dcost = QuadCost(C=C, c=c)
    if slew_rate_penalty is not None and not isinstance(dynamics, LinDx):
        dyn_a, dcost_a, x0_a, x_init_a = _augment_slew(
            dynamics, dcost, x0, u_init, x_init, slew_rate_penalty,
            prev_ctrl)
        res = solve(dyn_a, dcost_a, x0_a, bounds, u_init, x_init_a, cfg,
                    differentiable)
        return SQPResult(x=res.x[..., :nx], u=res.u, cost=res.cost,
                         alpha=res.alpha, qp_resid=res.qp_resid)
    with torch.no_grad():
        best_x, best_u, lin, alpha_last, resid_last = _iterate(
            dynamics, dcost, x0, bounds, u_init, x_init, cfg)
        A, B, f = _linearize(dynamics, *lin)
    if differentiable:
        if cfg.qp.kernel == "fused":
            bounds_static = Bounds(u_lo=tuple(float(v) for v in bounds.u_lo),
                                   u_hi=tuple(float(v) for v in bounds.u_hi))
            w_hat = trajqp.traj_qp_layer_static(
                dcost.C, dcost.c, A, B, f, x0, bounds_static, cfg.qp)
        else:
            w_hat = trajqp.traj_qp_layer(dcost.C, dcost.c, A, B, f, x0,
                                         bounds, cfg.qp)
    else:
        with torch.no_grad():
            sol = trajqp.solve(dcost.C, dcost.c, A, B, f, x0, bounds, cfg.qp,
                               x_init=best_x, u_init=best_u)
        w_hat = torch.cat([sol.x, sol.u], dim=-1)
    with torch.no_grad():
        cost_best = almerit.compute_cost(
            dcost, torch.cat([best_x, best_u], dim=-1))
        # the value is the line search's accepted candidate (u = best_u +
        # α·du and its feasible rollout), not the QP solution
        x_ls, u_ls, _, cost_final = line_search(
            dynamics, dcost, best_x, best_u, w_hat[..., :nx] - best_x,
            w_hat[..., nx:] - best_u, x0, cost_best, cfg.ls_decay,
            cfg.max_ls)
    w_out = torch.cat([x_ls, u_ls], dim=-1) + (w_hat - w_hat.detach())
    return SQPResult(x=w_out[..., :nx], u=w_out[..., nx:], cost=cost_final,
                     alpha=alpha_last, qp_resid=resid_last)


def _iterate(dynamics, dcost: QuadCost, x0: Tensor, bounds: Bounds,
             u_init: Tensor, x_init: Optional[Tensor], cfg: SQPConfig):
    """The SQP iterations from the detached warm starts. Returns (best_x,
    best_u, the final QP's linearization point (x, u), the last accepted
    α, the last QP residual)."""
    bsz = u_init.shape[0]
    u = u_init.detach()
    x_init = x_init.detach() if x_init is not None else None
    # the line search's baseline is the FEASIBLE rollout of u_init, never a
    # caller-supplied (infeasible) proposal
    x_feas = _rollout(dynamics, x0, u)
    x = x_init if x_init is not None else x_feas
    cost_cur = almerit.compute_cost(dcost, torch.cat([x_feas, u], dim=-1))

    best_x, best_u, best_cost = x_feas, u, cost_cur
    alpha_last = torch.ones(bsz, dtype=x0.dtype, device=x0.device)
    resid_last = torch.zeros(bsz, dtype=x0.dtype, device=x0.device)
    for _ in range(cfg.qp_iter):
        A, B, f = _linearize(dynamics, x, u)
        sol = trajqp.solve(dcost.C, dcost.c, A, B, f, x0, bounds, cfg.qp,
                           x_init=x, u_init=u)
        x, u, alpha_last, cost_cur = line_search(
            dynamics, dcost, x, u, sol.x - x, sol.u - u, x0, cost_cur,
            cfg.ls_decay, cfg.max_ls)
        resid_last = sol.resids
        better = (cost_cur <= best_cost)[:, None, None]
        best_x = torch.where(better, x, best_x)
        best_u = torch.where(better, u, best_u)
        best_cost = torch.minimum(cost_cur, best_cost)

    # the final QP is linearized at the best iterate (with no SQP
    # iteration, at the first linearization point)
    lin = (best_x, best_u) if cfg.qp_iter else (x, u)
    return best_x, best_u, lin, alpha_last, resid_last
