"""Batched Riccati (LQR-KKT) solve: the plain PyTorch version of kernel K3
(port of diff_qp_mpc_tpu.ops.riccati), and its elastic form.

Solves, per batch element, the equality-constrained trajectory QP

    min_{dx,du}  Σₜ ½ dwₜᵀ C̃ₜ dwₜ + g̃ₜᵀ dwₜ
    s.t.         dx_{t+1} = Aₜ dxₜ + Bₜ duₜ + rₜ,    dx₀ given

by the backward Riccati recursion and a forward rollout, O(T·n³). This is
the Newton system an interior-point or SQP iteration solves
(``solvers.trajqp``). Returned multipliers: ``lam[t]`` is the costate
−(Pₜdxₜ + pₜ); the multiplier of dynamics row t is lam[t+1], and of the
initial-state row lam[0].

With ``theta`` [bsz, T-1, nx] ≥ 0 the dynamics rows are ELASTIC: the
system is E dw − Θ dν = r (Θ = diag(theta) per stage), which is what the
SL1QP interior-point iteration leaves after eliminating its elastic slack
pairs (``solvers.trajqp.solve_elastic``). The value recursion gains the
proximal transform P ← (I + PΘ)⁻¹P, p ← (I + PΘ)⁻¹p, and the forward
rollout becomes dx_{t+1} = (I + ΘₜPₜ₊₁)⁻¹(A dx + B du + r − Θₜpₜ₊₁). The
elastic form is plain PyTorch on every device, as in the JAX package (a
vmapped scan there; K3 has no Θ).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


def mv(M: Tensor, v: Tensor) -> Tensor:
    """Batched matrix-vector product M v over leading axes."""
    return (M @ v[..., None])[..., 0]


class LQRSolution(NamedTuple):
    dx: Tensor  # [bsz, T, nx]
    du: Tensor  # [bsz, T, nu]
    lam: Tensor  # [bsz, T, nx] costates
    K: Tensor  # [bsz, T, nu, nx] feedback gains
    k: Tensor  # [bsz, T, nu] feedforward terms


def batched_lqr_kkt_solve(Cxx: Tensor, Cxu: Tensor, Cuu: Tensor, gx: Tensor,
                          gu: Tensor, A: Tensor, B: Tensor, r: Tensor,
                          dx0: Tensor, reg: float = 0.0,
                          theta: Optional[Tensor] = None) -> LQRSolution:
    """Cxx [bsz,T,nx,nx], Cxu [bsz,T,nx,nu], Cuu [bsz,T,nu,nu], gx [bsz,T,nx],
    gu [bsz,T,nu], A [bsz,T-1,nx,nx], B [bsz,T-1,nx,nu], r [bsz,T-1,nx],
    dx0 [bsz,nx]; ``reg`` is added to Quu's diagonal before its Cholesky
    factorization; ``theta`` [bsz,T-1,nx] makes the dynamics rows elastic
    (module docstring). Without ``theta`` the hard recursion is a branch
    of its own, with no identity solves."""
    bsz, T, nx, nu = Cxu.shape
    eye_x = torch.eye(nx, dtype=Cxx.dtype, device=Cxx.device)
    eye_u = torch.eye(nu, dtype=Cxx.dtype, device=Cxx.device)
    P = Cxx.new_zeros(bsz, nx, nx)
    p = Cxx.new_zeros(bsz, nx)
    Ks, ks, Ps, ps = [None] * T, [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        if t < T - 1:
            if theta is not None:
                # P ← (I + PΘ)⁻¹P, p ← (I + PΘ)⁻¹p, P symmetrized
                Pp = torch.linalg.solve(eye_x + P * theta[:, t, None, :],
                                        torch.cat([P, p[..., None]], -1))
                P = 0.5 * (Pp[..., :nx] + Pp[..., :nx].transpose(-1, -2))
                p = Pp[..., nx]
            A_t, B_t = A[:, t], B[:, t]
            AT, BT = A_t.transpose(-1, -2), B_t.transpose(-1, -2)
            PB = P @ B_t
            m = mv(P, r[:, t]) + p
            Qxx = Cxx[:, t] + AT @ (P @ A_t)
            Qxu = Cxu[:, t] + AT @ PB
            Quu = Cuu[:, t] + BT @ PB
            qx = gx[:, t] + mv(AT, m)
            qu = gu[:, t] + mv(BT, m)
        else:  # no transition after the last stage: P_T = 0
            Qxx, Qxu, Quu = Cxx[:, t], Cxu[:, t], Cuu[:, t]
            qx, qu = gx[:, t], gu[:, t]
        # no error check: a breakdown gives non-finite values, as in JAX
        L, _ = torch.linalg.cholesky_ex(Quu + reg * eye_u)
        K = -torch.cholesky_solve(Qxu.transpose(-1, -2), L)
        k = -torch.cholesky_solve(qu[..., None], L)[..., 0]
        P = Qxx + Qxu @ K
        P = 0.5 * (P + P.transpose(-1, -2))  # symmetrize against drift
        p = qx + mv(Qxu, k)
        Ks[t], ks[t], Ps[t], ps[t] = K, k, P, p

    dx = dx0
    dxs, dus, lams = [], [], []
    for t in range(T):
        du = mv(Ks[t], dx) + ks[t]
        dxs.append(dx)
        dus.append(du)
        lams.append(-(mv(Ps[t], dx) + ps[t]))
        if t < T - 1:
            dx = mv(A[:, t], dx) + mv(B[:, t], du) + r[:, t]
            if theta is not None:
                th = theta[:, t]
                dx = torch.linalg.solve(eye_x + th[..., :, None] * Ps[t + 1],
                                        dx - th * ps[t + 1])
    return LQRSolution(dx=torch.stack(dxs, 1), du=torch.stack(dus, 1),
                       lam=torch.stack(lams, 1), K=torch.stack(Ks, 1),
                       k=torch.stack(ks, 1))


def batched_lqr_kkt_solve_elastic(Cxx: Tensor, Cxu: Tensor, Cuu: Tensor,
                                  gx: Tensor, gu: Tensor, A: Tensor,
                                  B: Tensor, r: Tensor, dx0: Tensor,
                                  reg: float, theta: Tensor) -> LQRSolution:
    """The elastic recursion (``theta`` [bsz, T-1, nx] required), the
    counterpart of the JAX package's vmapped
    ``batched_lqr_kkt_solve_elastic``."""
    return batched_lqr_kkt_solve(Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0, reg,
                                 theta)
