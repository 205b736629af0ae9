"""SL1QP MPC — elastic-slack (ℓ1-penalty) SQP (port of
diff_qp_mpc_tpu.solvers.sl1qp_mpc, rebuild of qpth/sl1qp_mpc.py).

The SQP skeleton of ``solvers.sqp_mpc``, but every trajectory QP is made
elastic so it is always feasible (sl1qp_mpc.py:703-752 sl1qpify):

    min ½zᵀQz + qᵀz + μ·Σ(v + w) + μ·Σt
    s.t. Az − b = v − w,  Gz − h ≤ t,  v, w, t ≥ 0

Two backends:
- "riccati" (default): the elastic pairs eliminate per IPM iteration into
  a diagonal relaxation Θ of the dynamics rows, solved by the elastic
  Riccati recursion (``trajqp.solve_elastic``) in O(T);
- "dense": the reference-style expanded QP through the batched PDIPM
  (``solvers.qp.qp_solve``), which validates the structured backend.

Neither runs a kernel of this repository: the JAX package runs no Pallas
kernel on this path either (the elastic recursion is a vmapped scan there,
the dense QP jax.scipy.linalg), so on the card both are plain PyTorch and
torch.linalg.

The reference sizes the v/w blocks with ``nineq`` where ``neq`` is meant
(sl1qp_mpc.py:735-739 works only because its trajectory QPs happen to have
compatible sizes); the assembly here uses the correct dimensions, as the
JAX package's does.
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
from diff_qp_mpc_tpu_torch.models.base import DynamicsModel
from diff_qp_mpc_tpu_torch.ops import almerit
from diff_qp_mpc_tpu_torch.solvers import qp as qp_mod
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp
from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig

Tensor = torch.Tensor
Cost = Union[QuadCost, DiagQuadCost]


@dataclasses.dataclass(frozen=True)
class SL1QPConfig:
    qp_iter: int = 10
    mu: float = 10.0  # ℓ1 penalty weight (reference self.mu)
    ls_decay: float = 0.2
    max_ls: int = 10
    qp: QPConfig = QPConfig(max_iter=20)
    # "riccati": the structured elastic IPM (trajqp.solve_elastic);
    # "dense": the reference-style expanded QP through the batched PDIPM
    backend: str = "riccati"

    def __post_init__(self):
        if self.backend not in ("riccati", "dense"):
            raise ValueError(f"unknown SL1QP backend {self.backend!r} "
                             "(have 'riccati', 'dense')")


class SL1QPResult(NamedTuple):
    x: Tensor
    u: Tensor
    cost: Tensor
    slack_l1: Tensor  # [bsz] Σ(v+w+t) at the last QP — violation proxy


def _assemble_traj_qp(C, c, A, B, f, x0, bounds):
    """Flatten the trajectory QP to dense (Q, q, G, h, Aeq, beq)
    (reference compute_Qq/Ab/Gh_dense, qp_wrapper.py:638-679)."""
    bsz, Tm1, nx, nu = B.shape
    T = Tm1 + 1
    n = nx + nu
    nw = T * n
    kw = dict(dtype=C.dtype, device=C.device)

    Q = torch.zeros(bsz, nw, nw, **kw)
    for t in range(T):
        Q[:, t * n:(t + 1) * n, t * n:(t + 1) * n] = C[:, t]
    q = c.reshape(bsz, nw)

    neq = T * nx
    Aeq = torch.zeros(bsz, neq, nw, **kw)
    beq = torch.zeros(bsz, neq, **kw)
    eye_x = torch.eye(nx, **kw)
    for t in range(Tm1):
        r = slice(t * nx, (t + 1) * nx)
        Aeq[:, r, t * n:t * n + nx] = -A[:, t]
        Aeq[:, r, t * n + nx:(t + 1) * n] = -B[:, t]
        Aeq[:, r, (t + 1) * n:(t + 1) * n + nx] = eye_x
        beq[:, r] = f[:, t]
    Aeq[:, Tm1 * nx:, :nx] = eye_x
    beq[:, Tm1 * nx:] = x0

    nineq = 2 * T * nu
    G = torch.zeros(bsz, nineq, nw, **kw)
    h = torch.zeros(bsz, nineq, **kw)
    u_hi = torch.as_tensor(bounds.u_hi, **kw).expand(bsz, T, nu)
    u_lo = torch.as_tensor(bounds.u_lo, **kw).expand(bsz, T, nu)
    for t in range(T):
        for j in range(nu):
            row = 2 * (t * nu + j)
            G[:, row, t * n + nx + j] = 1.0
            h[:, row] = u_hi[:, t, j]
            G[:, row + 1, t * n + nx + j] = -1.0
            h[:, row + 1] = -u_lo[:, t, j]
    return Q, q, G, h, Aeq, beq


def sl1qpify(Q, q, G, h, A, mu: float):
    """Expand with elastic slacks [z, v, w, t] (sl1qp_mpc.py:703-752,
    dimension-corrected). Returns the expanded (Q, q, G, h, A); b is
    unchanged."""
    bsz, neq, nz = A.shape
    nineq = G.shape[1]
    kw = dict(dtype=Q.dtype, device=Q.device)
    Ie = torch.eye(neq, **kw).expand(bsz, neq, neq)
    Ii = torch.eye(nineq, **kw).expand(bsz, nineq, nineq)
    Z = lambda r, c_: torch.zeros(bsz, r, c_, **kw)

    # A [z, v, w, t]: Az − v + w = b
    A2 = torch.cat([A, -Ie, Ie, Z(neq, nineq)], dim=2)
    # G rows: Gz − t ≤ h; −v ≤ 0; −w ≤ 0; −t ≤ 0
    G2 = torch.cat([
        torch.cat([G, Z(nineq, neq), Z(nineq, neq), -Ii], dim=2),
        torch.cat([Z(neq, nz), -Ie, Z(neq, neq), Z(neq, nineq)], dim=2),
        torch.cat([Z(neq, nz), Z(neq, neq), -Ie, Z(neq, nineq)], dim=2),
        torch.cat([Z(nineq, nz), Z(nineq, neq), Z(nineq, neq), -Ii], dim=2),
    ], dim=1)
    n_slack = 2 * neq + nineq
    h2 = torch.cat([h, torch.zeros(bsz, n_slack, **kw)], dim=1)
    # a tiny quadratic on the slacks keeps Q ≻ 0 for the PDIPM
    Q2 = torch.zeros(bsz, nz + n_slack, nz + n_slack, **kw)
    Q2[:, :nz, :nz] = Q
    idx = torch.arange(nz, nz + n_slack, device=Q.device)
    Q2[:, idx, idx] = 1e-6
    q2 = torch.cat([q, torch.full((bsz, n_slack), mu, **kw)], dim=1)
    return Q2, q2, G2, h2, A2


def solve(dynamics: Union[DynamicsModel, LinDx], cost: Cost, x0: Tensor,
          bounds: Bounds, u_init: Tensor, x_init: Optional[Tensor] = None,
          cfg: SL1QPConfig = SL1QPConfig(), differentiable: bool = True
          ) -> SL1QPResult:
    """Batched SL1QP MPC solve (sl1qp_mpc.py MPC.forward → solve_nonlin).

    The SQP iterations run without autograd over ``sqp_mpc``'s
    linearization, rollout line search and dense cost, keeping the best
    iterate by cost. With ``differentiable``, one final elastic QP at the
    best iterate (``trajqp.elastic_traj_qp_layer``, whatever the backend)
    carries the gradient w.r.t. the cost (C, c) and x0, straight through
    onto the value, which is the line search's accepted rollout along that
    QP's direction (the reference carries gradients through its final
    elastic QP, sl1qp_mpc.py:301-331). ``slack_l1`` is the last SQP
    iteration's QP's.
    """
    bsz, T, nu = u_init.shape
    nx = x0.shape[-1]
    n = nx + nu
    nw = T * n
    dcost = sqp_mpc._dense_cost(cost, bsz, T, n)
    dcost_ng = QuadCost(C=dcost.C.detach(), c=dcost.c.detach())
    x0_ng = x0.detach()
    tq_cfg = trajqp.TrajQPConfig(max_iter=cfg.qp.max_iter)

    def one_qp(x, u):
        A, B, f = sqp_mpc._linearize(dynamics, x, u)
        if cfg.backend == "riccati":
            sol = trajqp.solve_elastic(dcost_ng.C, dcost_ng.c, A, B, f,
                                       x0_ng, bounds, cfg.mu, cfg=tq_cfg,
                                       x_init=x, u_init=u)
            return sol.x, sol.u, sol.slack_l1
        Qd, qd, Gd, hd, Aeq, beq = _assemble_traj_qp(
            dcost_ng.C, dcost_ng.c, A, B, f, x0_ng, bounds)
        Q2, q2, G2, h2, A2 = sl1qpify(Qd, qd, Gd, hd, Aeq, cfg.mu)
        sol = qp_mod.qp_solve(Q2, q2, G2, h2, A2, beq, cfg.qp)
        w = sol.z[:, :nw].reshape(bsz, T, n)
        return w[..., :nx], w[..., nx:], sol.z[:, nw:].sum(dim=1)

    with torch.no_grad():
        u = u_init.detach()
        x = (x_init.detach() if x_init is not None
             else sqp_mpc._rollout(dynamics, x0_ng, u))
        cost_cur = almerit.compute_cost(dcost_ng, torch.cat([x, u], -1))
        best_x, best_u, best_cost = x, u, cost_cur
        slack = torch.zeros(bsz, dtype=x.dtype, device=x.device)
        for _ in range(cfg.qp_iter):
            x_hat, u_hat, slack = one_qp(x, u)
            x, u, _, cost_cur = sqp_mpc.line_search(
                dynamics, dcost_ng, x, u, x_hat - x, u_hat - u, x0_ng,
                cost_cur, cfg.ls_decay, cfg.max_ls)
            better = (cost_cur <= best_cost)[:, None, None]
            best_x = torch.where(better, x, best_x)
            best_u = torch.where(better, u, best_u)
            best_cost = torch.minimum(cost_cur, best_cost)
    if not differentiable:
        return SL1QPResult(x=best_x, u=best_u, cost=best_cost,
                           slack_l1=slack)

    # the final differentiable elastic QP at the best iterate
    with torch.no_grad():
        A, B, f = sqp_mpc._linearize(dynamics, best_x, best_u)
    w_hat = trajqp.elastic_traj_qp_layer(dcost.C, dcost.c, A, B, f, x0,
                                         bounds, cfg.mu, tq_cfg, best_x,
                                         best_u)
    with torch.no_grad():
        cost_best = almerit.compute_cost(
            dcost_ng, torch.cat([best_x, best_u], dim=-1))
        x_ls, u_ls, _, cost_final = sqp_mpc.line_search(
            dynamics, dcost_ng, best_x, best_u, w_hat[..., :nx] - best_x,
            w_hat[..., nx:] - best_u, x0_ng, cost_best, cfg.ls_decay,
            cfg.max_ls)
    # straight-through: the VALUE is the line search's accepted rollout,
    # the GRADIENT the elastic QP's implicit sensitivity
    w_out = torch.cat([x_ls, u_ls], dim=-1) + (w_hat - w_hat.detach())
    return SL1QPResult(x=w_out[..., :nx], u=w_out[..., nx:],
                       cost=cost_final, slack_l1=slack)
