"""Box-constrained trajectory QP by interior point and Riccati KKT solves
(port of diff_qp_mpc_tpu.solvers.trajqp, forward solves).

Solves batches of

    min_{x,u}  Σₜ ½ wₜᵀ Cₜ wₜ + cₜᵀ wₜ          (w = (x, u))
    s.t.       x_{t+1} = Aₜ xₜ + Bₜ uₜ + fₜ,  x₀ = x0,  u_lo ≤ u ≤ u_hi

with a Mehrotra predictor-corrector in which the box block is eliminated
analytically each iteration (the slack/dual pairs fold into a diagonal
modification of Cuu and the u-gradient) and the remaining equality-
constrained Newton system is solved by the Riccati recursion. A fixed trip
count with best-iterate tracking keeps the cost of a solve known.

Two paths: the scan IPM (``kernel="scan"``) runs the iteration in
Python around ``ops.riccati_cuda`` (kernel K3 on CUDA tensors, two launches
per iteration); ``kernel="fused"`` hands the whole solve to kernel K4
(``ops.trajqp_fused_cuda``). ``solve`` runs under ``torch.no_grad``;
``traj_qp_layer`` differentiates its solution w.r.t. (C, c, x0) by the
OptNet implicit backward: one more Riccati solve (kernel K3 on CUDA
tensors, on both paths) with the box duals folded into Cuu.

Elimination algebra (per bound side, per (t, j)):
    Z ds + S dz = −r_s           (linearized complementarity)
    ±du + ds    = −r_p           (primal feasibility rows)
  ⇒ dz = (Z/S)·(±du) + (Z r_p − r_s)/S
so the u-stationarity row gains diag(z_hi/s_hi + z_lo/s_lo) and the
gradient gains (Z r_p − r_s)/S terms.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from diff_qp_mpc_tpu_torch.core.types import Bounds
from diff_qp_mpc_tpu_torch.ops import (
    riccati,
    riccati_cuda,
    trajqp_fused_cuda,
)
from diff_qp_mpc_tpu_torch.ops.riccati import mv

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrajQPConfig:
    max_iter: int = 12
    reg: float = 1e-9  # Levenberg damping on Quu in the Riccati pass
    min_slack: float = 1e-8
    # "scan": the IPM in Python, Riccati solves by K3 on CUDA tensors;
    # "fused": the whole IPM as kernel K4. The JAX spelling "auto" reads as
    # "scan".
    kernel: str = "scan"

    def __post_init__(self):
        if self.kernel == "auto":
            object.__setattr__(self, "kernel", "scan")
        if self.kernel == "pprefix":
            raise NotImplementedError(
                "the associative-scan Riccati (pprefix) is not ported yet")
        if self.kernel not in ("scan", "fused"):
            raise ValueError(f"unknown trajectory-QP kernel {self.kernel!r} "
                             "(have 'scan', 'fused')")


def riccati_solver(kernel: str = "scan"):
    """(Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0, reg) -> (dx, du, lam), the
    scan IPM's Riccati solve."""
    if kernel != "scan":
        raise ValueError(f"the Riccati solve serves the scan IPM only, "
                         f"got kernel {kernel!r}")
    return riccati_cuda.batched_lqr_kkt_solve


class TrajQPSolution(NamedTuple):
    x: Tensor  # [bsz, T, nx]
    u: Tensor  # [bsz, T, nu]
    lam: Tensor  # [bsz, T, nx] costates (Riccati convention)
    z_hi: Tensor  # [bsz, T, nu]
    z_lo: Tensor
    s_hi: Tensor
    s_lo: Tensor
    resids: Tensor  # [bsz]


class _CostBlocks(NamedTuple):
    Cxx: Tensor  # [bsz, T, nx, nx]
    Cxu: Tensor  # [bsz, T, nx, nu]
    Cuu: Tensor  # [bsz, T, nu, nu]
    cx: Tensor  # [bsz, T, nx]
    cu: Tensor  # [bsz, T, nu]


def split_cost(C: Tensor, c: Tensor, nx: int) -> _CostBlocks:
    """C [bsz, T, n, n], c [bsz, T, n] -> per-variable blocks, each
    contiguous (the Riccati kernel takes contiguous tensors)."""
    return _CostBlocks(*(a.contiguous() for a in (
        C[..., :nx, :nx], C[..., :nx, nx:], C[..., nx:, nx:], c[..., :nx],
        c[..., nx:])))


def _stationarity(cb: _CostBlocks, x, u, lam, z_hi, z_lo, A, B):
    """(r_x, r_u) stationarity residuals; the multiplier of dynamics row t
    is lam[t+1], of the initial-state row lam[0]."""
    nu_dyn = lam[:, 1:]
    r_x = mv(cb.Cxx, x) + mv(cb.Cxu, u) + cb.cx
    r_x[:, :-1] -= mv(A.transpose(-1, -2), nu_dyn)
    r_x[:, 1:] += nu_dyn
    r_x[:, 0] += lam[:, 0]
    r_u = mv(cb.Cxu.transpose(-1, -2), x) + mv(cb.Cuu, u) + cb.cu \
        + z_hi - z_lo
    r_u[:, :-1] -= mv(B.transpose(-1, -2), nu_dyn)
    return r_x, r_u


def _affine_rollout(A, B, f, x0, u):
    """x of the linearized dynamics from x0 under u (u[:, T-1] unused)."""
    xs = [x0]
    for t in range(A.shape[1]):
        xs.append(mv(A[:, t], xs[-1]) + mv(B[:, t], u[:, t]) + f[:, t])
    return torch.stack(xs, dim=1)


@torch.no_grad()
def solve(C: Tensor, c: Tensor, A: Tensor, B: Tensor, f: Tensor, x0: Tensor,
          bounds: Bounds, cfg: TrajQPConfig = TrajQPConfig(),
          x_init: Optional[Tensor] = None, u_init: Optional[Tensor] = None
          ) -> TrajQPSolution:
    """Batched IPM solve. C [bsz,T,n,n], c [bsz,T,n], A [bsz,T-1,nx,nx],
    B [bsz,T-1,nx,nu], f [bsz,T-1,nx], x0 [bsz,nx]; bounds tensors [nu] or
    python float tuples. Without ``x_init`` x starts from the affine rollout
    of u, and without ``u_init`` u starts at the box midpoint."""
    bsz, Tm1, nx, nu = B.shape
    T = Tm1 + 1
    kw = dict(dtype=C.dtype, device=C.device)
    u_hi = torch.as_tensor(bounds.u_hi, **kw).expand(bsz, T, nu)
    u_lo = torch.as_tensor(bounds.u_lo, **kw).expand(bsz, T, nu)
    A, B, f, x0 = (a.contiguous() for a in (A, B, f, x0))
    u = (torch.clamp(u_init, u_lo + 1e-3, u_hi - 1e-3)
         if u_init is not None else 0.5 * (u_hi + u_lo))
    x = x_init if x_init is not None else _affine_rollout(A, B, f, x0, u)

    if cfg.kernel == "fused":
        out = trajqp_fused_cuda.fused_trajqp_solve(
            C.contiguous(), c.contiguous(), A, B, f, x0, x.contiguous(),
            u.contiguous(), bounds.u_lo, bounds.u_hi, max_iter=cfg.max_iter,
            reg=cfg.reg, min_slack=cfg.min_slack)
        return TrajQPSolution(*out)

    cb = split_cost(C, c, nx)
    solve_fn = riccati_solver(cfg.kernel)
    lam = torch.zeros(bsz, T, nx, **kw)
    s_hi = torch.clamp(u_hi - u, min=0.1)
    s_lo = torch.clamp(u - u_lo, min=0.1)
    z_hi = torch.ones(bsz, T, nu, **kw)
    z_lo = torch.ones(bsz, T, nu, **kw)
    n_comp = 2 * T * nu
    nrm = lambda a: torch.linalg.vector_norm(a.reshape(bsz, -1), dim=1)
    col = lambda m: m.reshape(bsz, 1, 1)

    def full_residuals(x, u, lam, z_hi, z_lo, s_hi, s_lo):
        r_x, r_u = _stationarity(cb, x, u, lam, z_hi, z_lo, A, B)
        r_dyn = x[:, 1:] - (mv(A, x[:, :-1]) + mv(B, u[:, :-1]) + f)
        return (r_x, r_u, r_dyn, x[:, 0] - x0, u - u_hi + s_hi,
                u_lo - u + s_lo, s_hi * z_hi, s_lo * z_lo)

    def resid_norm(rs):
        r_x, r_u, r_dyn, r_init, r_p_hi, r_p_lo, r_s_hi, r_s_lo = rs
        mu = (r_s_hi.sum(dim=(1, 2)) + r_s_lo.sum(dim=(1, 2))) / n_comp
        pri = nrm(r_dyn) + nrm(r_init) + nrm(r_p_hi) + nrm(r_p_lo)
        return pri + nrm(r_x) + nrm(r_u) + n_comp * mu.abs(), mu

    def kkt_step(z_hi, z_lo, s_hi, s_lo, r_x, r_u, r_dyn, r_init,
                 r_p_hi, r_p_lo, r_s_hi, r_s_lo):
        """Eliminate bound rows → Riccati solve → recover (ds, dz)."""
        gu_extra = (z_hi * r_p_hi - r_s_hi) / s_hi \
            - (z_lo * r_p_lo - r_s_lo) / s_lo
        Cuu_eff = cb.Cuu + torch.diag_embed(z_hi / s_hi + z_lo / s_lo)
        dx, du, dlam = solve_fn(cb.Cxx, cb.Cxu, Cuu_eff, r_x, r_u + gu_extra,
                                A, B, -r_dyn, -r_init, cfg.reg)
        ds_hi = -r_p_hi - du
        ds_lo = -r_p_lo + du
        dz_hi = -(r_s_hi + z_hi * ds_hi) / s_hi
        dz_lo = -(r_s_lo + z_lo * ds_lo) / s_lo
        return dx, du, dlam, ds_hi, ds_lo, dz_hi, dz_lo

    def max_step(vs, dvs):
        """min over the four (v, dv) pairs of the largest step in (0, 1]."""
        big = torch.finfo(C.dtype).max
        v = torch.cat([a.reshape(bsz, -1) for a in vs], dim=1)
        dv = torch.cat([a.reshape(bsz, -1) for a in dvs], dim=1)
        neg = dv < 0
        steps = torch.where(neg, -v / torch.where(neg, dv, -1.0), big)
        return torch.clamp(steps.amin(dim=1), max=1.0)

    state = (x, u, lam, z_hi, z_lo, s_hi, s_lo)
    best = state
    b_tot = torch.full((bsz,), float("inf"), **kw)
    for _ in range(cfg.max_iter):
        x, u, lam, z_hi, z_lo, s_hi, s_lo = state
        rs = full_residuals(*state)
        total, mu = resid_norm(rs)
        # best-iterate tracking
        better = col(total < b_tot)
        best = tuple(torch.where(better, a, b) for a, b in zip(state, best))
        b_tot = torch.minimum(total, b_tot)

        # affine (predictor)
        dx_a, du_a, dl_a, dsh_a, dsl_a, dzh_a, dzl_a = kkt_step(
            z_hi, z_lo, s_hi, s_lo, *rs)
        a = col(max_step((s_hi, s_lo, z_hi, z_lo),
                         (dsh_a, dsl_a, dzh_a, dzl_a)))
        mu_aff = (((s_hi + a * dsh_a) * (z_hi + a * dzh_a)).sum(dim=(1, 2))
                  + ((s_lo + a * dsl_a) * (z_lo + a * dzl_a)).sum(dim=(1, 2))
                  ) / n_comp
        ratio = mu_aff / torch.clamp(mu, min=1e-300)
        smu = col(ratio * ratio * ratio * mu)

        # centering-corrector (zero other residuals)
        zr = torch.zeros_like
        d_c = kkt_step(z_hi, z_lo, s_hi, s_lo, *(zr(r) for r in rs[:6]),
                       dsh_a * dzh_a - smu, dsl_a * dzl_a - smu)
        dx, du, dl, dsh, dsl, dzh, dzl = (
            p + q for p, q in zip((dx_a, du_a, dl_a, dsh_a, dsl_a, dzh_a,
                                   dzl_a), d_c))
        alpha = col(0.99 * max_step((s_hi, s_lo, z_hi, z_lo),
                                    (dsh, dsl, dzh, dzl)))
        ms = cfg.min_slack
        state = (x + alpha * dx, u + alpha * du, lam + alpha * dl,
                 torch.clamp(z_hi + alpha * dzh, min=ms),
                 torch.clamp(z_lo + alpha * dzl, min=ms),
                 torch.clamp(s_hi + alpha * dsh, min=ms),
                 torch.clamp(s_lo + alpha * dsl, min=ms))

    total, _ = resid_norm(full_residuals(*state))
    better = col(total < b_tot)
    out = (torch.where(better, a, b) for a, b in zip(state, best))
    return TrajQPSolution(*out, resids=torch.minimum(total, b_tot))


class _QPImplicitGrad(torch.autograd.Function):
    """Identity on the QP solution w = (x, u) forward. Backward: the OptNet
    system K [dw; dν] = −[∂L/∂w; 0] with the box block eliminated, i.e. one
    LQR-KKT solve with gradient rhs ∂L/∂w, zero dynamics and initial-state
    rhs, and Cuu + diag(z_hi/s_hi + z_lo/s_lo) (duals and slacks clamped
    at 1e-8); then dC = ½(dw wᵀ + w dwᵀ), dc = dw, dx0 = −λ₀. A, B, f get
    no gradient."""

    @staticmethod
    def forward(ctx, C, c, x0, w, A, B, f, d_box, reg: float):
        ctx.save_for_backward(C, w, A, B, f, d_box)
        ctx.reg = reg
        return w.clone()

    @staticmethod
    def backward(ctx, dl_dw):
        C, w, A, B, f, d_box = ctx.saved_tensors
        nx = A.shape[-1]
        Cxx, Cxu, Cuu_eff, gx, gu = (a.contiguous() for a in (
            C[..., :nx, :nx], C[..., :nx, nx:],
            C[..., nx:, nx:] + torch.diag_embed(d_box), dl_dw[..., :nx],
            dl_dw[..., nx:]))
        rdx, rdu, rlam = riccati_cuda.batched_lqr_kkt_solve(
            Cxx, Cxu, Cuu_eff, gx, gu, A, B, torch.zeros_like(f),
            w.new_zeros(w.shape[0], nx), ctx.reg)
        dw = torch.cat([rdx, rdu], dim=-1)
        dC = 0.5 * (dw[..., :, None] * w[..., None, :]
                    + w[..., :, None] * dw[..., None, :])
        return dC, dw, -rlam[:, 0], None, None, None, None, None, None


def traj_qp_layer(C: Tensor, c: Tensor, A: Tensor, B: Tensor, f: Tensor,
                  x0: Tensor, bounds: Bounds,
                  cfg: TrajQPConfig = TrajQPConfig()) -> Tensor:
    """w = [x, u] [bsz, T, n] of the QP, solved cold (u from the box
    midpoint, x from its affine rollout), differentiable w.r.t. C, c and
    x0 (see ``_QPImplicitGrad``); A, B and f are treated as constants."""
    sol = solve(C, c, A, B, f, x0, bounds, cfg)
    w = torch.cat([sol.x, sol.u], dim=-1)
    if not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (C, c, x0))):
        return w
    with torch.no_grad():
        lo = lambda a: torch.clamp(a, min=1e-8)
        d_box = lo(sol.z_hi) / lo(sol.s_hi) + lo(sol.z_lo) / lo(sol.s_lo)
    return _QPImplicitGrad.apply(C, c, x0, w, A.detach().contiguous(),
                                 B.detach().contiguous(),
                                 f.detach().contiguous(), d_box, cfg.reg)


def traj_qp_layer_static(C: Tensor, c: Tensor, A: Tensor, B: Tensor,
                         f: Tensor, x0: Tensor, bounds: Bounds,
                         cfg: TrajQPConfig) -> Tensor:
    """traj_qp_layer for the fused kernel, whose box bounds are python
    float tuples (run-time scalars of K4, static constants of the JAX
    kernel) and never an autograd input; tensor bounds raise."""
    if isinstance(bounds.u_lo, Tensor) or isinstance(bounds.u_hi, Tensor):
        raise TypeError("traj_qp_layer_static takes the box bounds as "
                        "python float tuples")
    return traj_qp_layer(C, c, A, B, f, x0, bounds, cfg)


# ---------------------------------------------------------------------------
# Elastic (SL1QP) trajectory QP: ℓ1-penalty slack pairs on the dynamics
# rows, solved structurally. The box block eliminates as above, and the
# elastic pairs (v, w ≥ 0, cost μ each, duals z_v, z_w) eliminate into a
# per-stage diagonal relaxation Θₜ = v/z_v + w/z_w of the dynamics rows,
# which the elastic Riccati recursion (ops.riccati with theta, plain
# PyTorch on every device) solves in O(T). The initial-state row stays hard.
# ---------------------------------------------------------------------------


class ElasticTrajQPSolution(NamedTuple):
    x: Tensor
    u: Tensor
    lam: Tensor
    v: Tensor  # [bsz, T-1, nx] positive-violation slacks
    w_s: Tensor  # [bsz, T-1, nx] negative-violation slacks
    slack_l1: Tensor  # [bsz] Σ(v + w) — total constraint relaxation
    resids: Tensor
    # final duals and slacks, for the elastic layer's implicit backward
    z_hi: Tensor
    z_lo: Tensor
    s_hi: Tensor
    s_lo: Tensor
    zv: Tensor
    zw: Tensor


@torch.no_grad()
def solve_elastic(C: Tensor, c: Tensor, A: Tensor, B: Tensor, f: Tensor,
                  x0: Tensor, bounds: Bounds, mu: float,
                  cfg: TrajQPConfig = TrajQPConfig(),
                  x_init: Optional[Tensor] = None,
                  u_init: Optional[Tensor] = None) -> ElasticTrajQPSolution:
    """Batched elastic IPM solve: the inputs of ``solve`` plus the penalty
    μ. The 11-part state (x, u, λ, z_hi, z_lo, s_hi, s_lo, v, w, z_v,
    z_w) runs ``cfg.max_iter`` Mehrotra iterations and the last iterate is
    returned (no best-iterate tracking, as in the JAX package); ``resids``
    is the sum of the stationarity, elastic-dynamics and initial-row
    residual norms. ``cfg.kernel`` is not read: the elastic recursion has
    no kernel."""
    bsz, Tm1, nx, nu = B.shape
    T = Tm1 + 1
    kw = dict(dtype=C.dtype, device=C.device)
    cb = split_cost(C, c, nx)
    u_hi = torch.as_tensor(bounds.u_hi, **kw).expand(bsz, T, nu)
    u_lo = torch.as_tensor(bounds.u_lo, **kw).expand(bsz, T, nu)
    u = (torch.clamp(u_init, u_lo + 1e-3, u_hi - 1e-3)
         if u_init is not None else 0.5 * (u_hi + u_lo))
    x = x_init if x_init is not None else _affine_rollout(A, B, f, x0, u)
    lam = torch.zeros(bsz, T, nx, **kw)
    s_hi = torch.clamp(u_hi - u, min=0.1)
    s_lo = torch.clamp(u - u_lo, min=0.1)
    z_hi = torch.ones(bsz, T, nu, **kw)
    z_lo = torch.ones(bsz, T, nu, **kw)
    ev = torch.full((bsz, Tm1, nx), 0.1, **kw)
    ew = torch.full((bsz, Tm1, nx), 0.1, **kw)
    zv = torch.full((bsz, Tm1, nx), mu, **kw)
    zw = torch.full((bsz, Tm1, nx), mu, **kw)
    n_comp = 2 * T * nu + 2 * Tm1 * nx
    nrm = lambda a: torch.linalg.vector_norm(a.reshape(bsz, -1), dim=1)
    col = lambda m: m.reshape(bsz, 1, 1)
    tot = lambda a: a.sum(dim=(1, 2))

    def residuals(x, u, lam, z_hi, z_lo, s_hi, s_lo, ev, ew, zv, zw):
        r_x, r_u = _stationarity(cb, x, u, lam, z_hi, z_lo, A, B)
        nu_dyn = lam[:, 1:]
        e_dyn = x[:, 1:] - (mv(A, x[:, :-1]) + mv(B, u[:, :-1]) + f)
        return (r_x, r_u, e_dyn - ev + ew, x[:, 0] - x0, u - u_hi + s_hi,
                u_lo - u + s_lo, s_hi * z_hi, s_lo * z_lo, mu - nu_dyn - zv,
                mu + nu_dyn - zw, ev * zv, ew * zw)

    def max_step(vs, dvs):
        """min over the (v, dv) pairs of the largest step in (0, 1]."""
        big = torch.finfo(C.dtype).max
        v = torch.cat([a.reshape(bsz, -1) for a in vs], dim=1)
        dv = torch.cat([a.reshape(bsz, -1) for a in dvs], dim=1)
        neg = dv < 0
        steps = torch.where(neg, -v / torch.where(neg, dv, -1.0), big)
        return torch.clamp(steps.amin(dim=1), max=1.0)

    def kkt_step(state, rs):
        (x, u, lam, z_hi, z_lo, s_hi, s_lo, ev, ew, zv, zw) = state
        (r_x, r_u, r_el, r_init, r_p_hi, r_p_lo, r_s_hi, r_s_lo,
         r_sv, r_sw, r_cv, r_cw) = rs
        gu_extra = (z_hi * r_p_hi - r_s_hi) / s_hi \
            - (z_lo * r_p_lo - r_s_lo) / s_lo
        Cuu_eff = cb.Cuu + torch.diag_embed(z_hi / s_hi + z_lo / s_lo)
        theta = ev / zv + ew / zw
        # the dynamics rows' rhs after the elastic elimination (the
        # recursion's convention: E dw − Θ dν = r)
        r_arg = -r_el + (-r_cv - ev * r_sv) / zv - (-r_cw - ew * r_sw) / zw
        sol = riccati.batched_lqr_kkt_solve_elastic(
            cb.Cxx, cb.Cxu, Cuu_eff, r_x, r_u + gu_extra, A, B, r_arg,
            -r_init, cfg.reg, theta)
        dnu = sol.lam[:, 1:]
        dzv = r_sv - dnu
        dzw = r_sw + dnu
        ds_hi = -r_p_hi - sol.du
        ds_lo = -r_p_lo + sol.du
        return (sol.dx, sol.du, sol.lam, -(r_s_hi + z_hi * ds_hi) / s_hi,
                -(r_s_lo + z_lo * ds_lo) / s_lo, ds_hi, ds_lo,
                (-r_cv - ev * dzv) / zv, (-r_cw - ew * dzw) / zw, dzv, dzw)

    # positions of (z_hi, z_lo, s_hi, s_lo, v, w, z_v, z_w) in the state
    # and in a direction
    cone = (3, 4, 5, 6, 7, 8, 9, 10)
    state = (x, u, lam, z_hi, z_lo, s_hi, s_lo, ev, ew, zv, zw)
    for _ in range(cfg.max_iter):
        (x, u, lam, z_hi, z_lo, s_hi, s_lo, ev, ew, zv, zw) = state
        rs = residuals(*state)
        mu_bar = (tot(rs[6]) + tot(rs[7]) + tot(rs[10]) + tot(rs[11])) \
            / n_comp

        d_aff = kkt_step(state, rs)
        a = col(max_step([state[i] for i in cone], [d_aff[i] for i in cone]))
        mu_aff = (tot((s_hi + a * d_aff[5]) * (z_hi + a * d_aff[3]))
                  + tot((s_lo + a * d_aff[6]) * (z_lo + a * d_aff[4]))
                  + tot((ev + a * d_aff[7]) * (zv + a * d_aff[9]))
                  + tot((ew + a * d_aff[8]) * (zw + a * d_aff[10]))) / n_comp
        ratio = mu_aff / torch.clamp(mu_bar, min=1e-300)
        smu = col(ratio * ratio * ratio * mu_bar)

        rs_corr = list(rs)
        rs_corr[6] = rs[6] + d_aff[5] * d_aff[3] - smu
        rs_corr[7] = rs[7] + d_aff[6] * d_aff[4] - smu
        rs_corr[10] = rs[10] + d_aff[7] * d_aff[9] - smu
        rs_corr[11] = rs[11] + d_aff[8] * d_aff[10] - smu
        d = kkt_step(state, rs_corr)

        a = col(0.99 * max_step([state[i] for i in cone],
                                [d[i] for i in cone]))
        ms = cfg.min_slack
        state = tuple(s_ + a * d_ if i < 3 else torch.clamp(s_ + a * d_,
                                                             min=ms)
                      for i, (s_, d_) in enumerate(zip(state, d)))

    (x, u, lam, z_hi, z_lo, s_hi, s_lo, ev, ew, zv, zw) = state
    rs = residuals(*state)
    total = nrm(rs[0]) + nrm(rs[1]) + nrm(rs[2]) + nrm(rs[3])
    return ElasticTrajQPSolution(
        x=x, u=u, lam=lam, v=ev, w_s=ew, slack_l1=tot(ev + ew),
        resids=total, z_hi=z_hi, z_lo=z_lo, s_hi=s_hi, s_lo=s_lo, zv=zv,
        zw=zw)


class _ElasticImplicitGrad(torch.autograd.Function):
    """Identity on the elastic QP's solution w = (x, u) forward. Backward:
    one elastic Riccati solve with gradient rhs ∂L/∂w, zero dynamics and
    initial-state rhs, Cuu + diag(z_hi/s_hi + z_lo/s_lo) and Θ = v/z_v +
    w/z_w (every dual and slack clamped at 1e-8); then dC = ½(dw wᵀ +
    w dwᵀ), dc = dw, dx0 = −λ₀. A, B, f get no gradient."""

    @staticmethod
    def forward(ctx, C, c, x0, w, A, B, d_box, theta, reg: float):
        ctx.save_for_backward(C, w, A, B, d_box, theta)
        ctx.reg = reg
        return w.clone()

    @staticmethod
    def backward(ctx, dl_dw):
        C, w, A, B, d_box, theta = ctx.saved_tensors
        bsz, Tm1, nx, _ = B.shape
        out = riccati.batched_lqr_kkt_solve_elastic(
            C[..., :nx, :nx], C[..., :nx, nx:],
            C[..., nx:, nx:] + torch.diag_embed(d_box), dl_dw[..., :nx],
            dl_dw[..., nx:], A, B, w.new_zeros(bsz, Tm1, nx),
            w.new_zeros(bsz, nx), ctx.reg, theta)
        dw = torch.cat([out.dx, out.du], dim=-1)
        dC = 0.5 * (dw[..., :, None] * w[..., None, :]
                    + w[..., :, None] * dw[..., None, :])
        return dC, dw, -out.lam[:, 0], None, None, None, None, None, None


def elastic_traj_qp_layer(C: Tensor, c: Tensor, A: Tensor, B: Tensor,
                          f: Tensor, x0: Tensor, bounds: Bounds, mu: float,
                          cfg: TrajQPConfig = TrajQPConfig(),
                          x_init: Optional[Tensor] = None,
                          u_init: Optional[Tensor] = None) -> Tensor:
    """w = [x, u] [bsz, T, n] of the elastic QP (``solve_elastic`` from the
    given warm starts), differentiable w.r.t. C, c and x0 (see
    ``_ElasticImplicitGrad``, the reference's QPFunction.backward through
    its final elastic QP); A, B and f are treated as constants."""
    sol = solve_elastic(C, c, A, B, f, x0, bounds, mu, cfg, x_init, u_init)
    w = torch.cat([sol.x, sol.u], dim=-1)
    if not (torch.is_grad_enabled() and any(
            a.requires_grad for a in (C, c, x0))):
        return w
    with torch.no_grad():
        lo = lambda a: torch.clamp(a, min=1e-8)
        d_box = lo(sol.z_hi) / lo(sol.s_hi) + lo(sol.z_lo) / lo(sol.s_lo)
        theta = lo(sol.v) / lo(sol.zv) + lo(sol.w_s) / lo(sol.zw)
    return _ElasticImplicitGrad.apply(C, c, x0, w, A.detach(), B.detach(),
                                      d_box, theta, cfg.reg)
