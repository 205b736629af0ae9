"""Slow trusted CPU oracle for testing (a copy of
diff_qp_mpc_tpu.solvers.oracles; numpy in, numpy out).

Role of the reference's CVXPY backend (qpth/solvers/cvxpy.py:9-35,
QPSolvers.CVXPY): an independent, per-instance float64 solver the batched
QP layer (``solvers.qp``) is validated against. The oracle is scipy's SLSQP
(an entirely separate SQP implementation) with duals recovered from the
KKT conditions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy import optimize


def solve_qp_np(Q: np.ndarray, p: np.ndarray, G: Optional[np.ndarray],
                h: Optional[np.ndarray], A: Optional[np.ndarray],
                b: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray]:
    """Solve one QP: min ½zᵀQz + pᵀz s.t. Gz ≤ h, Az = b.

    Returns (z, lam, nu, s). Duals are recovered by least squares on the
    stationarity condition restricted to active constraints.
    """
    nz = Q.shape[0]
    cons = []
    if A is not None and A.size:
        cons.append({"type": "eq", "fun": lambda z: A @ z - b,
                     "jac": lambda z: A})
    if G is not None and G.size:
        cons.append({"type": "ineq", "fun": lambda z: h - G @ z,
                     "jac": lambda z: -G})
    res = optimize.minimize(
        lambda z: 0.5 * z @ Q @ z + p @ z,
        np.zeros(nz),
        jac=lambda z: Q @ z + p,
        constraints=cons,
        method="SLSQP",
        options={"maxiter": 500, "ftol": 1e-12},
    )
    z = res.x
    grad = Q @ z + p

    nineq = G.shape[0] if G is not None and G.size else 0
    neq = A.shape[0] if A is not None and A.size else 0
    s = (h - G @ z) if nineq else np.zeros(0)

    # stationarity: grad + Gᵀλ + Aᵀν = 0, λ ≥ 0, λ·s = 0
    act = s < 1e-7 if nineq else np.zeros(0, bool)
    cols = []
    if nineq:
        cols.append(G[act].T)
    if neq:
        cols.append(A.T)
    lam = np.zeros(nineq)
    nu = np.zeros(neq)
    if cols:
        M = np.concatenate(cols, axis=1)
        if M.size:
            mult, *_ = np.linalg.lstsq(M, -grad, rcond=None)
            k = int(act.sum())
            if nineq:
                lam[act] = np.maximum(mult[:k], 0.0)
            if neq:
                nu = mult[k:]
    return z, lam, nu, s
