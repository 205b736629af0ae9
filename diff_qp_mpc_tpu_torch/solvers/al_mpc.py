"""Augmented-Lagrangian MPC, forward solves (port of
diff_qp_mpc_tpu.solvers.al_mpc).

Solves::

    min_{x,u} Σₜ ½ τₜᵀ diag(Cdₜ) τₜ + cₜᵀ τₜ
    s.t. x_{t+1} = f(x_t, u_t), x_0 = x0, u_lo ≤ u ≤ u_hi

Two paths: ``solve`` runs the AL outer loop in Python around
``ops.newton_al`` (whose Newton step is kernel K1 on CUDA tensors), and
``solve_fused`` / ``solve_fused_stateful`` hand the solve to kernel K2
(``ops.al_fused_cuda``). Warm-start state is an explicit ``ALState`` the
caller threads through. Everything here runs under ``torch.no_grad``: the
implicit backward through the solution is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from diff_qp_mpc_tpu_torch.core.types import (
    ALState,
    Bounds,
    DiagQuadCost,
    Lambdas,
    SolveStats,
)
from diff_qp_mpc_tpu_torch.models.base import DynamicsModel, step_with_jac
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, almerit, newton_al

Tensor = torch.Tensor


@dataclasses.dataclass
class ALConfig:
    """Solver budget (reference defaults: al_iter 2, ≤4 Newton steps, a
    20-candidate line search, ρ ← 10ρ capped at rho_max)."""

    al_iter: int = 2
    n_newton: int = 4
    n_ls: int = 20
    rho_factor: float = 10.0
    # without the cap, warm-started receding-horizon use grows ρ by
    # rho_factor^al_iter per call and overflows within a few calls
    rho_max: float = 1e6
    reg: float = 1e-7


def warm_start(lam: Lambdas, rho: Tensor, cost_start: Tensor,
               state: ALState) -> Tuple[Lambdas, Tensor]:
    """History-based AL warm start: pick the most recent history entry whose
    cost beats the incoming cost (entry 0, the most recent, when none does),
    rescale λ to that entry's magnitude, take its ρ."""
    hist_cost = state.hist_cost.flip(0)  # most recent first
    hist_rho = state.hist_rho.flip(0)
    hist_lam = state.hist_lam.map(lambda a: a.flip(0))
    mask = hist_cost < cost_start[None]  # [H, bsz]
    idx = torch.argmax(mask.to(torch.int32), dim=0)  # first True, else 0
    cols = torch.arange(idx.shape[0], device=idx.device)
    sel = lambda a: a[idx, cols]
    lam_sel = hist_lam.map(sel)
    norm_sel = torch.linalg.vector_norm(lam_sel.flat(), dim=-1)
    norm_cur = torch.linalg.vector_norm(lam.flat(), dim=-1)
    scale = norm_sel / (norm_cur + 1e-12)
    lam_new = lam.map(lambda a: a * scale.reshape((-1,) + (1,) * (a.ndim - 1)))
    return lam_new, sel(hist_rho)


def _push_hist(hist: Tensor, entry: Tensor) -> Tensor:
    """Roll a [H, ...] history buffer, appending ``entry`` at the end."""
    return torch.cat([hist[1:], entry[None]], dim=0)


def _start(dynamics, cfg, cost, x0, state, x_init, u_init):
    """Entry logic shared by both paths: initial trajectory, warm-started
    λ/ρ, and the history with the starting point pushed."""
    u = u_init if u_init is not None else state.u
    if x_init is not None:
        x = x_init
    elif state.just_initialized:
        x = dynamics.rollout(x0, u)
    else:
        x = state.x
    xu = torch.cat([x, u], dim=-1)
    cost_start = almerit.compute_cost(cost, xu)
    lam, rho = state.lam, state.rho
    if not state.just_initialized:
        lam, rho = warm_start(lam, rho, cost_start, state)
    rho = torch.clamp(rho, 1e-3, cfg.rho_max)
    hist = (_push_hist(state.hist_cost, cost_start),
            state.hist_lam.map(_push_hist, lam),
            _push_hist(state.hist_rho, rho))
    return xu, lam, rho, hist


def _end_state(state, xu, nx, lam, rho, hist, al_iter) -> ALState:
    hist_cost, hist_lam, hist_rho = hist
    return ALState(
        x=xu[..., :nx], u=xu[..., nx:], lam=lam, rho=rho,
        hist_cost=hist_cost, hist_lam=hist_lam, hist_rho=hist_rho,
        hist_filled=min(state.hist_filled + al_iter + 1,
                        state.hist_cost.shape[0]),
        just_initialized=False)


def _al_core(dynamics: DynamicsModel, cfg: ALConfig, cost: DiagQuadCost,
             x0: Tensor, bounds: Bounds, state: ALState,
             x_init: Optional[Tensor], u_init: Optional[Tensor]):
    """Forward AL solve. Returns (xu, new_state, stats)."""
    nx = x0.shape[-1]
    xu, lam, rho, hist = _start(dynamics, cfg, cost, x0, state, x_init,
                                u_init)
    hist_cost, hist_lam, hist_rho = hist
    dyn_jac = step_with_jac(dynamics)
    stats = None
    for _ in range(cfg.al_iter):
        result = newton_al.newton_al(
            cost, dynamics, dyn_jac, xu, x0, bounds, lam, rho,
            n_newton=cfg.n_newton, n_ls=cfg.n_ls, reg=cfg.reg)
        xu = result.xu
        res = almerit.residuals(dynamics, xu[..., :nx], xu[..., nx:], x0,
                                bounds)
        lam = almerit.lambda_update(lam, res, rho)
        cost_now = almerit.compute_cost(cost, xu)
        rho = torch.clamp(rho * cfg.rho_factor, max=cfg.rho_max)
        hist_cost = _push_hist(hist_cost, cost_now)
        hist_lam = hist_lam.map(_push_hist, lam)
        hist_rho = _push_hist(hist_rho, rho)
        stats = SolveStats(dyn_res=res.clamped().flat_norm(), cost=cost_now,
                           merit=result.merit,
                           newton_steps=cfg.al_iter * cfg.n_newton,
                           step_size=result.step_size)
    new_state = _end_state(state, xu, nx, lam, rho,
                           (hist_cost, hist_lam, hist_rho), cfg.al_iter)
    return xu, new_state, stats


@torch.no_grad()
def solve(dynamics: DynamicsModel, cost: DiagQuadCost, x0: Tensor,
          bounds: Bounds, state: ALState, cfg: ALConfig = ALConfig(),
          x_init: Optional[Tensor] = None, u_init: Optional[Tensor] = None):
    """AL-MPC solve. Returns (x, u, new_state, stats).

    ``state`` carries warm starts across receding-horizon calls; build a
    fresh one with ``ALState.init``.
    """
    nx = x0.shape[-1]
    xu, new_state, stats = _al_core(dynamics, cfg, cost, x0, bounds, state,
                                    x_init, u_init)
    return xu[..., :nx], xu[..., nx:], new_state, stats


def shift(state: ALState, keep_multipliers: bool = False) -> ALState:
    """Advance warm-start state by one step for receding-horizon control:
    shift x/u left by one (repeating the tail); reset multipliers, penalty
    and history unless ``keep_multipliers``."""
    roll = lambda a: torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    x, u = roll(state.x), roll(state.u)
    if keep_multipliers:
        lam = Lambdas(lam_dyn=roll(state.lam.lam_dyn),
                      lam_init=torch.zeros_like(state.lam.lam_init),
                      lam_hi=roll(state.lam.lam_hi),
                      lam_lo=roll(state.lam.lam_lo))
        # just_initialized skips the cost-history warm start
        return dataclasses.replace(state, x=x, u=u, lam=lam,
                                   just_initialized=True)
    bsz, T, nx = x.shape
    fresh = ALState.init(bsz, T, nx, u.shape[-1],
                         hist_len=state.hist_cost.shape[0], dtype=x.dtype,
                         device=x.device)
    # just_initialized=False so the shifted x/u are used; the fresh (inf-cost)
    # history makes the warm-start selection a no-op (λ stays 0, ρ returns
    # to 1)
    return dataclasses.replace(fresh, x=x, u=u, just_initialized=False)


def _bounds_tuple(bounds: Bounds):
    as_t = lambda v: tuple(float(a) for a in torch.as_tensor(v).reshape(-1))
    return as_t(bounds.u_lo), as_t(bounds.u_hi)


def _kernel_kwargs(cfg: ALConfig):
    return dict(n_newton=cfg.n_newton, n_ls=cfg.n_ls,
                rho_factor=cfg.rho_factor, rho_max=cfg.rho_max, reg=cfg.reg)


@torch.no_grad()
def solve_fused(dynamics: DynamicsModel, cost: DiagQuadCost, x0: Tensor,
                bounds: Bounds, cfg: ALConfig = ALConfig(),
                x_init: Optional[Tensor] = None,
                u_init: Optional[Tensor] = None):
    """Whole-solver AL-MPC on kernel K2, fresh λ/ρ each call. Returns
    (x, u, dyn_res)."""
    nx = x0.shape[-1]
    bsz, T = cost.Cd.shape[:2]
    if u_init is None:
        u_init = x0.new_zeros(bsz, T, dynamics.nu)
    if x_init is None:
        x_init = dynamics.rollout(x0, u_init)
    u_lo, u_hi = _bounds_tuple(bounds)
    xu, _, _, _, res = al_fused_cuda.fused_al_solve(
        dynamics, cost.Cd.contiguous(), cost.c.contiguous(), x0.contiguous(),
        u_lo, u_hi, x_init.contiguous(), u_init.contiguous(),
        al_iter=cfg.al_iter, **_kernel_kwargs(cfg))
    return xu[..., :nx], xu[..., nx:], res


@torch.no_grad()
def solve_fused_stateful(dynamics: DynamicsModel, cost: DiagQuadCost,
                         x0: Tensor, bounds: Bounds, state: ALState,
                         cfg: ALConfig = ALConfig(),
                         x_init: Optional[Tensor] = None,
                         u_init: Optional[Tensor] = None):
    """Kernel K2 with the scan path's full warm-start carry: the kernel runs
    one AL iteration per launch, and the history pushes and λ/ρ selection
    happen here exactly as in ``solve``. Returns (x, u, new_state, stats)."""
    nx = x0.shape[-1]
    xu, lam, rho, hist = _start(dynamics, cfg, cost, x0, state, x_init,
                                u_init)
    hist_cost, hist_lam, hist_rho = hist
    u_lo, u_hi = _bounds_tuple(bounds)
    Cd, c, x0c = cost.Cd.contiguous(), cost.c.contiguous(), x0.contiguous()
    res = None
    for _ in range(cfg.al_iter):
        xu, lamd, lamh, laml, res = al_fused_cuda.fused_al_solve(
            dynamics, Cd, c, x0c, u_lo, u_hi, xu[..., :nx].contiguous(),
            xu[..., nx:].contiguous(), al_iter=1,
            lam_dyn=lam.lam_dyn.contiguous(), lam_hi=lam.lam_hi.contiguous(),
            lam_lo=lam.lam_lo.contiguous(), rho0=rho[:, 0].contiguous(),
            **_kernel_kwargs(cfg))
        lam = Lambdas(lam_dyn=lamd, lam_init=torch.zeros_like(lam.lam_init),
                      lam_hi=lamh, lam_lo=laml)
        # the kernel applies ρ ← min(ρ·factor, rho_max) after its λ update
        rho = torch.clamp(rho * cfg.rho_factor, max=cfg.rho_max)
        hist_cost = _push_hist(hist_cost, almerit.compute_cost(cost, xu))
        hist_lam = hist_lam.map(_push_hist, lam)
        hist_rho = _push_hist(hist_rho, rho)
    new_state = _end_state(state, xu, nx, lam, rho,
                           (hist_cost, hist_lam, hist_rho), cfg.al_iter)
    stats = SolveStats(dyn_res=res, cost=almerit.compute_cost(cost, xu),
                       merit=torch.zeros_like(res),
                       newton_steps=cfg.al_iter * cfg.n_newton,
                       step_size=torch.zeros_like(res))
    return xu[..., :nx], xu[..., nx:], new_state, stats
