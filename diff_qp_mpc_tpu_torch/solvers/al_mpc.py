"""Augmented-Lagrangian MPC, forward solves (port of
diff_qp_mpc_tpu.solvers.al_mpc).

Solves::

    min_{x,u} Σₜ ½ τₜᵀ diag(Cdₜ) τₜ + cₜᵀ τₜ
    s.t. x_{t+1} = f(x_t, u_t), x_0 = x0, u_lo ≤ u ≤ u_hi

Two paths: ``solve`` runs the AL outer loop in Python around
``ops.newton_al`` (whose Newton step is kernel K1 on CUDA tensors), and
``solve_fused`` / ``solve_fused_stateful`` hand the solve to kernel K2
(``ops.al_fused_cuda``). Warm-start state is an explicit ``ALState`` the
caller threads through.

Differentiation: every solve runs without autograd. When a gradient is
wanted (``differentiable``, grad mode on, and the cost requiring grad), the
pinned Gauss-Newton Hessian blocks D, O at the solution are computed once
more and the solution passes through ``_ImplicitCostGrad``, whose backward
is one block-tridiagonal solve H g = −ḡ (kernel K1 on CUDA tensors), then
dCd = g ⊙ τ and dc = g. Gradients flow to the cost only, as in the JAX
package's custom VJPs; the returned ``ALState`` carries no graph.
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
             x_init: Optional[Tensor], u_init: Optional[Tensor],
             blocks: bool = False):
    """Forward AL solve. Returns (xu, new_state, stats, D, O): D, O are the
    last Newton solve's pinned Hessian blocks at the solution when
    ``blocks``, else None."""
    nx = x0.shape[-1]
    xu, lam, rho, hist = _start(dynamics, cfg, cost, x0, state, x_init,
                                u_init)
    hist_cost, hist_lam, hist_rho = hist
    dyn_jac = step_with_jac(dynamics)
    stats = None
    for k in range(cfg.al_iter):
        result = newton_al.newton_al(
            cost, dynamics, dyn_jac, xu, x0, bounds, lam, rho,
            n_newton=cfg.n_newton, n_ls=cfg.n_ls, reg=cfg.reg,
            final_blocks=blocks and k == cfg.al_iter - 1)
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
    return xu, new_state, stats, result.D, result.O


#: batch elements whose implicit gradient ``_sanitize_implicit_grad``
#: changed since a reader set the count to 0 (a tensor on the gradient's
#: device once a backward ran; reading it synchronizes). None, the default,
#: counts nothing.
guard_drops = None


def _sanitize_implicit_grad(g: Tensor) -> Tensor:
    """Drop batch elements whose implicit H⁻¹ solve is numerically garbage.

    ρ at rho_max makes cond(H) ≈ ρ/reg; the float32 Cholesky then emits
    NaN/inf, or finite but meaningless huge values shortly before it emits
    inf. A legitimate solve is bounded by ‖ct‖/λ_min(H) ≤ ‖ct‖/reg; anything
    orders beyond that is breakdown, and one singular element must not
    poison the batch gradient. Non-finite entries become 0, and elements
    with max|g| > 1e8 become 0 whole.
    """
    global guard_drops
    finite = torch.isfinite(g)
    g = torch.where(finite, g, 0.0)
    bad = g.abs().amax(dim=(1, 2), keepdim=True) > 1e8
    if guard_drops is not None:
        guard_drops = guard_drops + (bad[:, 0, 0] | ~finite.all(dim=2).all(
            dim=1)).sum()
    return torch.where(bad, 0.0, g)


class _ImplicitCostGrad(torch.autograd.Function):
    """Identity on the solution τ = xu forward. Backward: the implicit-
    function-theorem gradient w.r.t. the diagonal cost at the stationary
    point, H g = −ḡ with H the final pinned GN Hessian (D, O), one K1 solve
    on CUDA tensors; dCd = g ⊙ τ, dc = g. The x₀ cotangent is dropped
    before the solve (x₀ is pinned, dx₀/dθ = 0). The three AL solves share
    it."""

    @staticmethod
    def forward(ctx, Cd, c, xu, D, O, reg: float, nx: int):
        ctx.save_for_backward(xu, D, O)
        ctx.reg, ctx.nx = reg, nx
        return xu.clone()

    @staticmethod
    def backward(ctx, ct):
        xu, D, O = ctx.saved_tensors
        ct = ct.clone(memory_format=torch.contiguous_format)
        ct[:, 0, :ctx.nx] = 0.0
        g = -newton_al.kkt_solver()(D, O, ct, ctx.reg)
        g = _sanitize_implicit_grad(g)
        return g * xu, g, None, None, None, None, None


def _wants_grad(differentiable: bool, cost: DiagQuadCost) -> bool:
    return (differentiable and torch.is_grad_enabled()
            and (cost.Cd.requires_grad or cost.c.requires_grad))


def solve(dynamics: DynamicsModel, cost: DiagQuadCost, x0: Tensor,
          bounds: Bounds, state: ALState, cfg: ALConfig = ALConfig(),
          x_init: Optional[Tensor] = None, u_init: Optional[Tensor] = None,
          differentiable: bool = True):
    """AL-MPC solve. Returns (x, u, new_state, stats).

    ``state`` carries warm starts across receding-horizon calls; build a
    fresh one with ``ALState.init``. Gradients flow to ``cost`` only.
    """
    nx = x0.shape[-1]
    grad = _wants_grad(differentiable, cost)
    with torch.no_grad():
        xu, new_state, stats, D, O = _al_core(
            dynamics, cfg, cost, x0, bounds, state, x_init, u_init,
            blocks=grad)
    if grad:
        xu = _ImplicitCostGrad.apply(cost.Cd, cost.c, xu, D, O, cfg.reg, nx)
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


def _fused_DO(dynamics, cost, x0, bounds_t, xu, lamd, lamh, laml, rho):
    """Final pinned GN Hessian blocks for the implicit backward of a K2
    solve: λ as the kernel returned it (after the final update; one update
    beyond the last Newton solve only moves the GN Hessian through the
    active-set masks), ρ [bsz, 1] the one of the last Newton solve."""
    lam = Lambdas(lam_dyn=lamd, lam_init=x0.new_zeros(x0.shape),
                  lam_hi=lamh, lam_lo=laml)
    return newton_al.final_pinned_blocks(
        cost, step_with_jac(dynamics), xu, x0,
        Bounds(u_lo=bounds_t[0], u_hi=bounds_t[1]), lam, rho)


def solve_fused(dynamics: DynamicsModel, cost: DiagQuadCost, x0: Tensor,
                bounds: Bounds, cfg: ALConfig = ALConfig(),
                x_init: Optional[Tensor] = None,
                u_init: Optional[Tensor] = None,
                differentiable: bool = True):
    """Whole-solver AL-MPC on kernel K2, fresh λ/ρ each call. Returns
    (x, u, dyn_res). Gradients flow to ``cost`` only; the backward's ρ is
    min(rho_factor^(al_iter−1), rho_max), the one of the last Newton
    solve."""
    nx = x0.shape[-1]
    bsz, T = cost.Cd.shape[:2]
    grad = _wants_grad(differentiable, cost)
    with torch.no_grad():
        if u_init is None:
            u_init = x0.new_zeros(bsz, T, dynamics.nu)
        if x_init is None:
            x_init = dynamics.rollout(x0, u_init)
        bounds_t = _bounds_tuple(bounds)
        xu, lamd, lamh, laml, res = al_fused_cuda.fused_al_solve(
            dynamics, cost.Cd.contiguous(), cost.c.contiguous(),
            x0.contiguous(), *bounds_t, x_init.contiguous(),
            u_init.contiguous(), al_iter=cfg.al_iter, **_kernel_kwargs(cfg))
        if grad:
            rho = min(cfg.rho_factor ** (cfg.al_iter - 1), cfg.rho_max)
            D, O = _fused_DO(dynamics, cost, x0, bounds_t, xu, lamd, lamh,
                             laml, x0.new_full((bsz, 1), rho))
    if grad:
        xu = _ImplicitCostGrad.apply(cost.Cd, cost.c, xu, D, O, cfg.reg, nx)
    return xu[..., :nx], xu[..., nx:], res


def solve_fused_stateful(dynamics: DynamicsModel, cost: DiagQuadCost,
                         x0: Tensor, bounds: Bounds, state: ALState,
                         cfg: ALConfig = ALConfig(),
                         x_init: Optional[Tensor] = None,
                         u_init: Optional[Tensor] = None,
                         differentiable: bool = True):
    """Kernel K2 with the scan path's full warm-start carry: the kernel runs
    one AL iteration per launch, and the history pushes and λ/ρ selection
    happen here exactly as in ``solve``. Returns (x, u, new_state, stats).
    Gradients flow to ``cost`` only; the backward's ρ is the one the last
    launch started from."""
    grad = _wants_grad(differentiable, cost)
    with torch.no_grad():
        xu, new_state, stats, rho_last = _fused_stateful_core(
            dynamics, cfg, cost, x0, bounds, state, x_init, u_init)
        if grad:
            lam = new_state.lam
            D, O = _fused_DO(dynamics, cost, x0, _bounds_tuple(bounds), xu,
                             lam.lam_dyn, lam.lam_hi, lam.lam_lo, rho_last)
    nx = x0.shape[-1]
    if grad:
        xu = _ImplicitCostGrad.apply(cost.Cd, cost.c, xu, D, O, cfg.reg, nx)
    return xu[..., :nx], xu[..., nx:], new_state, stats


def _fused_stateful_core(dynamics, cfg, cost, x0, bounds, state, x_init,
                         u_init):
    """Returns (xu, new_state, stats, rho_last): ρ [bsz, 1] that the last
    launch started from, before its ×rho_factor."""
    nx = x0.shape[-1]
    xu, lam, rho, hist = _start(dynamics, cfg, cost, x0, state, x_init,
                                u_init)
    hist_cost, hist_lam, hist_rho = hist
    u_lo, u_hi = _bounds_tuple(bounds)
    Cd, c, x0c = cost.Cd.contiguous(), cost.c.contiguous(), x0.contiguous()
    res = rho_last = None
    for _ in range(cfg.al_iter):
        rho_last = rho
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
    return xu, new_state, stats, rho_last
