"""Differentiable dense QP layer, the OptNet QPFunction (port of
diff_qp_mpc_tpu.solvers.qp).

Solves batches of

    min_z ½ zᵀQz + pᵀz   s.t.  Gz ≤ h,  Az = b

with a Mehrotra predictor-corrector interior-point method and
differentiates implicitly: the backward pass is ONE extra KKT solve with
∂L/∂z* as the right-hand side, followed by the outer-product assembly of
the six gradients (qpth qp.py:128-183).

- A fixed ``max_iter`` trip count with per-element best-iterate tracking
  (no host sync, no early exit).
- ``solver="dense"``: one LU factorization of the regularized KKT matrix K̃
  per iteration, shared by the predictor and the corrector, plus
  ``refine_steps`` of iterative refinement against the unregularized K.
- ``solver="prefactor"``: Q factored once, then an m×m Cholesky of the
  Schur complement over the constraint rows each iteration.
- ``ry_fn``/``rx_fn`` override the equality residual and the cost-gradient
  term (the reference's dyn_res/cost_grad callbacks).

The factorizations are ``lu_factor_ex``/``cholesky_ex`` without error
checks, so a singular K̃ or a Q that is not positive definite gives
non-finite values, as in the JAX package, instead of an exception, and the
card is not synchronized once per factorization. A failed Cholesky is set
to NaN (as JAX's is); a singular LU is used as it stands. The QP layer has
no TPU kernel (the JAX package computes it with jax.scipy.linalg), so on
either device these are the port's own linear algebra calls.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from diff_qp_mpc_tpu_torch.ops.riccati import mv

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class QPConfig:
    """Reference defaults: qp.py:19-20, batch_LU.py:29-30."""

    max_iter: int = 20
    kkt_reg: float = 1e-7  # K̃ regularization (batch_LU.py:42 KKTeps)
    refine_steps: int = 1
    eps: float = 1e-12  # kept for API parity; exit is via best-iterate
    # "dense": full-KKT LU per iteration; "prefactor": Q factored once and
    # a Schur-complement Cholesky over the constraint rows per iteration
    # (the reference's pre_factor_kkt scheme, batch.py:377-469, SPD form)
    solver: str = "dense"

    def __post_init__(self):
        if self.solver not in ("dense", "prefactor"):
            raise ValueError(f"unknown QP solver {self.solver!r} (have "
                             "'dense', 'prefactor')")


class QPSolution(NamedTuple):
    z: Tensor  # [bsz, nz] primal
    lam: Tensor  # [bsz, nineq] inequality duals
    nu: Tensor  # [bsz, neq] equality duals
    s: Tensor  # [bsz, nineq] slacks
    resids: Tensor  # [bsz] residual at the returned (best) iterate


def _build_kkt(Q, G, A, z, s, reg: float):
    """K(z, s) = [[Q, 0, Gᵀ, Aᵀ], [0, Z, S, 0], [G, I, 0, 0], [A, 0, 0, 0]]
    (variables ordered (x, s, z, y)) and K̃ = K + reg·diag(1, …, 1, −1, …)
    (+1 on the x and s rows, −1 on the z and y rows)."""
    bsz, nineq, nz = G.shape
    neq = A.shape[1]
    kw = dict(dtype=Q.dtype, device=Q.device)
    zeros = lambda r, c: torch.zeros(bsz, r, c, **kw)
    eye = torch.eye(nineq, **kw).expand(bsz, nineq, nineq)
    K = torch.cat([
        torch.cat([Q, zeros(nz, nineq), G.transpose(-1, -2),
                   A.transpose(-1, -2)], dim=-1),
        torch.cat([zeros(nineq, nz), torch.diag_embed(z), torch.diag_embed(s),
                   zeros(nineq, neq)], dim=-1),
        torch.cat([G, eye, zeros(nineq, nineq), zeros(nineq, neq)], dim=-1),
        torch.cat([A, zeros(neq, nineq), zeros(neq, nineq), zeros(neq, neq)],
                  dim=-1)], dim=-2)
    if not reg:
        return K, K
    sign = torch.cat([torch.ones(nz + nineq, **kw),
                      -torch.ones(nineq + neq, **kw)])
    return K, K + reg * torch.diag(sign)


def _split(l, nz, nineq):
    return (l[:, :nz], l[:, nz:nz + nineq], l[:, nz + nineq:nz + 2 * nineq],
            l[:, nz + 2 * nineq:])


def _lu_solver(K, K_tilde, refine_steps: int):
    """solve(rx, rs, rz, ry) -> (dx, ds, dz, dy) of K l = −[rx, rs, rz, ry]
    by one LU of K̃ plus ``refine_steps`` refinements against K
    (batch_LU.py:212-244)."""
    LU, piv, _ = torch.linalg.lu_factor_ex(K_tilde, check_errors=False)

    def solve(rx, rs, rz, ry):
        r = -torch.cat([rx, rs, rz, ry], dim=1)
        l = torch.linalg.lu_solve(LU, piv, r[..., None])[..., 0]
        for _ in range(refine_steps):
            res = r - mv(K, l)
            l = l + torch.linalg.lu_solve(LU, piv, res[..., None])[..., 0]
        return _split(l, rx.shape[1], rs.shape[1])

    return solve


def _kkt_solve(K, K_tilde, rx, rs, rz, ry, refine_steps: int):
    """Solve K l = −[rx, rs, rz, ry] (one LU of K̃, refined against K)."""
    return _lu_solver(K, K_tilde, refine_steps)(rx, rs, rz, ry)


def _cholesky(M):
    """Lower Cholesky factor, NaN where M is not positive definite (as
    jax.scipy.linalg.cholesky gives), without an error check."""
    L, info = torch.linalg.cholesky_ex(M, check_errors=False)
    return torch.where((info == 0)[..., None, None], L, float("nan"))


def _make_schur_solver(Q, G, A, reg: float):
    """Pre-factored KKT solver (the reference pre_factor_kkt scheme,
    batch.py:377-428, SPD form): factor Q once, precompute
    R = [G; A] Q⁻¹ [G; A]ᵀ; each iteration only Cholesky-factors the m×m
    Schur system M = R + blkdiag(diag(s/z), 0) + reg·I.

    Returns solve(rx, rs, rz, ry, z, s) -> (dx, ds, dz, dy) solving the
    same system as _kkt_solve (K l = −r)."""
    bsz, nineq, nz = G.shape
    neq = A.shape[1]
    kw = dict(dtype=Q.dtype, device=Q.device)
    m = nineq + neq
    Lq = _cholesky(Q + reg * torch.eye(nz, **kw))
    Mrows = torch.cat([G, A], dim=1)  # [bsz, m, nz]
    QiMT = torch.cholesky_solve(Mrows.transpose(-1, -2), Lq)  # [bsz, nz, m]
    R = Mrows @ QiMT  # [bsz, m, m]
    R = 0.5 * (R + R.transpose(-1, -2))
    eye_m = torch.eye(m, **kw)

    def solve(rx, rs, rz, ry, z, s):
        Qirx = torch.cholesky_solve(rx[..., None], Lq)[..., 0]
        rhs_G = rz - rs / z - mv(G, Qirx)
        rhs_A = ry - mv(A, Qirx) if neq > 0 else ry
        rhs = torch.cat([rhs_G, rhs_A], dim=1)
        d = torch.cat([s / z, torch.zeros(bsz, neq, **kw)], dim=1)
        M = R + torch.diag_embed(d) + reg * eye_m
        sol = torch.cholesky_solve(rhs[..., None], _cholesky(M))[..., 0]
        dz, dy = sol[:, :nineq], sol[:, nineq:]
        dx = -(Qirx + mv(QiMT, sol))
        ds = -rz - mv(G, dx)
        return dx, ds, dz, dy

    return solve


def _get_step(v: Tensor, dv: Tensor) -> Tensor:
    """Largest α ≤ 1 keeping v + α·dv ≥ 0 (per batch element)."""
    neg = dv < 0
    steps = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                        torch.finfo(v.dtype).max)
    return torch.clamp(steps.amin(dim=1), max=1.0)


@torch.no_grad()
def qp_solve(Q: Tensor, p: Tensor, G: Tensor, h: Tensor, A: Tensor,
             b: Tensor, cfg: QPConfig = QPConfig(),
             ry_fn: Optional[Callable[[Tensor], Tensor]] = None,
             rx_fn: Optional[Callable[[Tensor], Tensor]] = None
             ) -> QPSolution:
    """Batched PDIPM forward (batch_LU.py:29-201), without autograd (the
    gradient is ``qp_layer``'s).

    Q [bsz, nz, nz], p [bsz, nz], G [bsz, nineq, nz], h [bsz, nineq],
    A [bsz, neq, nz] (neq may be 0), b [bsz, neq].
    ry_fn(x) -> [bsz, neq] overrides the equality residual Ax − b;
    rx_fn(x) -> [bsz, nz] overrides the cost-gradient term Qx + p.
    """
    bsz, nineq, nz = G.shape
    neq = A.shape[1]
    kw = dict(dtype=Q.dtype, device=Q.device)
    GT, AT = G.transpose(-1, -2), A.transpose(-1, -2)

    use_schur = cfg.solver == "prefactor"
    schur = _make_schur_solver(Q, G, A, cfg.kkt_reg) if use_schur else None

    # initialization: solve with S = Z = I, then shift into the cone
    ones = torch.ones(bsz, nineq, **kw)
    zeros_i = torch.zeros(bsz, nineq, **kw)
    if use_schur:
        x, s, z, y = schur(p, zeros_i, -h, -b, ones, ones)
    else:
        K, K_tilde = _build_kkt(Q, G, A, ones, ones, cfg.kkt_reg)
        x, s, z, y = _kkt_solve(K, K_tilde, p, zeros_i, -h, -b,
                                cfg.refine_steps)
    s_min = s.amin(dim=1, keepdim=True)
    s = torch.where(s_min < 0, s - s_min + 1.0, s)
    z_min = z.amin(dim=1, keepdim=True)
    z = torch.where(z_min < 0, z - z_min + 1.0, z)

    def residuals(x, s, z, y):
        rx = mv(GT, z) + (mv(AT, y) if neq > 0 else 0.0)
        rx = rx + (rx_fn(x) if rx_fn is not None else mv(Q, x) + p)
        rs = s * z
        rz = mv(G, x) + s - h
        ry = ry_fn(x) if ry_fn is not None else (
            mv(A, x) - b if neq > 0 else torch.zeros(bsz, 0, **kw))
        return rx, rs, rz, ry

    nrm = lambda a: torch.linalg.vector_norm(a, dim=1)

    def resid_total(rx, rz, ry, mu):
        return (nrm(rz) + (nrm(ry) if neq > 0 else 0.0) + nrm(rx)
                + nineq * mu)

    col = lambda m: m[:, None]
    best = (torch.full((bsz,), float("inf"), **kw), x, s, z, y)
    for _ in range(cfg.max_iter):
        rx, rs, rz, ry = residuals(x, s, z, y)
        mu = (s * z).sum(dim=1).abs() / nineq
        resids = resid_total(rx, rz, ry, mu)
        # best-iterate bookkeeping (batch_LU.py:119-148)
        better = col(resids < best[0])
        best = (torch.minimum(resids, best[0]),
                *(torch.where(better, new, old)
                  for new, old in zip((x, s, z, y), best[1:])))

        if use_schur:
            solve = lambda rx, rs, rz, ry, z=z, s=s: schur(rx, rs, rz, ry,
                                                           z, s)
        else:
            K, K_tilde = _build_kkt(Q, G, A, z, s, cfg.kkt_reg)
            solve = _lu_solver(K, K_tilde, cfg.refine_steps)

        # affine (predictor) direction
        dx_a, ds_a, dz_a, dy_a = solve(rx, rs, rz, ry)
        alpha = torch.minimum(_get_step(z, dz_a), _get_step(s, ds_a))
        t1 = s + col(alpha) * ds_a
        t2 = z + col(alpha) * dz_a
        ratio = (t1 * t2).sum(dim=1) / (s * z).sum(dim=1)
        sig = ratio * ratio * ratio

        # centering-corrector direction (batch_LU.py:169-179)
        rs_c = col(-(mu * sig)) + ds_a * dz_a
        zr = torch.zeros_like
        dx_c, ds_c, dz_c, dy_c = solve(zr(rx), rs_c, zr(rz), zr(ry))

        dx, ds, dz, dy = dx_a + dx_c, ds_a + ds_c, dz_a + dz_c, dy_a + dy_c
        alpha = col(torch.clamp(0.999 * torch.minimum(
            _get_step(z, dz), _get_step(s, ds)), max=1.0))
        x, s, z = x + alpha * dx, s + alpha * ds, z + alpha * dz
        if neq > 0:
            y = y + alpha * dy

    # final best update with the last iterate
    rx, rs, rz, ry = residuals(x, s, z, y)
    mu = (s * z).sum(dim=1).abs() / nineq
    resids = resid_total(rx, rz, ry, mu)
    better = col(resids < best[0])
    x, s, z, y = (torch.where(better, new, old)
                  for new, old in zip((x, s, z, y), best[1:]))
    return QPSolution(z=x, lam=z, nu=y, s=s,
                      resids=torch.minimum(resids, best[0]))


class _QPLayer(torch.autograd.Function):
    """The OptNet layer: forward ``qp_solve``; backward one dense KKT solve
    (always the dense one, as in the JAX package, whatever ``cfg.solver``)
    at the solution with the duals and slacks clamped at 1e-8, then
    dp = dx, dG = dλ zᵀ + λ dxᵀ, dh = −dλ, dQ = ½(dx zᵀ + z dxᵀ),
    dA = dν zᵀ + ν dxᵀ and db = −dν (both zero when neq is 0)."""

    @staticmethod
    def forward(ctx, Q, p, G, h, A, b, cfg):
        sol = qp_solve(Q, p, G, h, A, b, cfg)
        ctx.save_for_backward(Q, G, A, sol.z, sol.lam, sol.nu, sol.s)
        ctx.cfg = cfg
        return sol.z

    @staticmethod
    def backward(ctx, dl_dz):
        Q, G, A, z, lam, nu, s = ctx.saved_tensors
        cfg = ctx.cfg
        bsz, nineq, _ = G.shape
        neq = A.shape[1]
        kw = dict(dtype=Q.dtype, device=Q.device)
        K, K_tilde = _build_kkt(Q, G, A, torch.clamp(lam, min=1e-8),
                                torch.clamp(s, min=1e-8), cfg.kkt_reg)
        zeros_i = torch.zeros(bsz, nineq, **kw)
        dx, _, dlam, dnu = _kkt_solve(
            K, K_tilde, dl_dz, zeros_i, zeros_i, torch.zeros(bsz, neq, **kw),
            cfg.refine_steps)
        ger = lambda a, c: a[:, :, None] * c[:, None, :]
        dQ = 0.5 * (ger(dx, z) + ger(z, dx))
        dG = ger(dlam, z) + ger(lam, dx)
        if neq > 0:
            dA, db = ger(dnu, z) + ger(nu, dx), -dnu
        else:
            dA, db = torch.zeros_like(A), torch.zeros(bsz, 0, **kw)
        return dQ, dx, dG, -dlam, dA, db, None


def qp_layer(Q: Tensor, p: Tensor, G: Tensor, h: Tensor, A: Tensor,
             b: Tensor, cfg: QPConfig = QPConfig()) -> Tensor:
    """argmin_z ½zᵀQz + pᵀz  s.t. Gz ≤ h, Az = b — differentiable in all six
    parameters (the OptNet layer, qpth QPFunction). Inputs may be expanded
    views of shared parameters: the gradient has the expanded shape and
    autograd reduces it."""
    return _QPLayer.apply(Q, p, G, h, A, b, cfg)
