"""Infinite-horizon discrete LQR: the DARE and the terminal value cost of
stabilizing short-horizon tracking MPC (port of
diff_qp_mpc_tpu.solvers.lqr).

The terminal cost x_Tᵀ P x_T, with P the DARE solution at the goal's
linearization, is the infinite-horizon tail of the MPC's own stage cost:
with it a T 5 ip tracker holds the both-links-up 2-link cartpole, which no
horizon or budget holds without it. Every solve here runs in float64:
P's entries reach ~3.6e4 on the 2-link cartpole, and the stabilization
depends on cross terms that float32 loses.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


def _riccati_map(A, B, Q, R, P):
    """One step of P ↦ Q + Aᵀ P A − Aᵀ P B (R + Bᵀ P B)⁻¹ Bᵀ P A."""
    BtP = B.T @ P
    K = np.linalg.solve(R + BtP @ B, BtP @ A)
    return Q + A.T @ P @ (A - B @ K)


def _fixed_point(A, B, Q, R, tol: float, max_iter: int) -> np.ndarray:
    """The Riccati map iterated from P₀ = Q until the largest entry moves by
    at most ``tol`` (the JAX package's ``dare`` stops once it moves by no
    more than tol), or ``max_iter`` steps; symmetrized."""
    P = Q
    for _ in range(max_iter):
        Pn = _riccati_map(A, B, Q, R, P)
        dP = np.max(np.abs(Pn - P))
        P = Pn
        if not dP > tol:
            break
    return 0.5 * (P + P.T)


def _f64(a) -> np.ndarray:
    if isinstance(a, Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float64)


def dare(A, B, Q, R, tol: float = 1e-9, max_iter: int = 10_000) -> Tensor:
    """The discrete algebraic Riccati equation's solution
    P = Q + Aᵀ P A − Aᵀ P B (R + Bᵀ P B)⁻¹ Bᵀ P A by fixed-point iteration
    from P₀ = Q (linear rate; converges for stabilizable (A, B) with
    detectable (A, Q^½)), on the host in float64; returned as a float64
    tensor."""
    return torch.from_numpy(_fixed_point(_f64(A), _f64(B), _f64(Q), _f64(R),
                                         tol, max_iter))


def lqr_gain(A, B, Q, R) -> Tuple[Tensor, Tensor]:
    """(K, P): the infinite-horizon LQR gain u = −K x and its value P,
    float64."""
    A, B, R = _f64(A), _f64(B), _f64(R)
    P = dare(A, B, Q, R).numpy()
    BtP = B.T @ P
    K = np.linalg.solve(R + BtP @ B, BtP @ A)
    return torch.from_numpy(K), torch.from_numpy(P)


def terminal_value_cost(model, x_goal, u_goal: Optional[object], Q_diag,
                        R_diag) -> Tensor:
    """Terminal P for tracking MPC: the DARE at the goal's linearization,
    float64 (the caller casts it when assembling the cost).

    ``model`` is a DynamicsModel; Q_diag and R_diag are the stage cost's
    diagonals, so that P is the exact infinite-horizon tail of that cost;
    ``u_goal`` None means zero controls. The Jacobian is the model's own
    ``jac`` (analytic on the pendulum and the integrator, forward-mode
    duals through the closed-form step on the cartpoles and the quadrotor,
    as every linearization of the port takes it) at (x_goal, u_goal) in
    float64; the fixed point runs on the host in numpy float64 with
    tolerance 1e-9 and at most 10 000 iterations, and P is symmetrized.
    """
    xg = torch.as_tensor(_f64(x_goal))
    nx, nu = xg.shape[-1], _f64(R_diag).shape[-1]
    ug = (torch.as_tensor(_f64(u_goal)) if u_goal is not None
          else torch.zeros(nu, dtype=torch.float64))
    _, (A, B) = model.jac(xg[None], ug[None])
    P = _fixed_point(_f64(A[0]), _f64(B[0]), np.diag(_f64(Q_diag)),
                     np.diag(_f64(R_diag)), 1e-9, 10_000)
    return torch.from_numpy(P)
