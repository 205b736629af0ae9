"""Scan-path AL-MPC solver of the PyTorch port (solvers.al_mpc: warm
start, solve, shift) vs the JAX package.

Tolerances: float64 results agree to rounding unless a line search meets a
near-tie (candidate merits equal to within rounding, first minimum wins),
which moves a step by a power of two; the JAX Pallas kernel and the plain
version differ by up to ~1e-7 for that reason, so float64 is held to 1e-6.
In float32 the Newton systems amplify rounding (cond ~1e4 at R 0.01);
float32 alone moves a solve by ~5e-3, so float32 is held to 1e-2."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.core import types as dq
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.solvers import al_mpc as jax_al
from diff_qp_mpc_tpu_torch.core.types import (
    ALState,
    Bounds,
    DiagQuadCost,
    Lambdas,
)
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.solvers import al_mpc

B, T, NX, NU = 16, 5, 2, 1
N = NX + NU
TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
MAIN = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)
SMALL = dict(al_iter=1, n_newton=2, n_ls=20, rho_max=1e4, reg=1e-5)


def _tracking(seed, dtype=torch.float64):
    """Tracking problems like the policy's: x0 in the env's range, a
    reference drifting from it, Cd = (Q, R), c = −Cd·τ_ref."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    xu_ref = np.concatenate([x_ref, np.zeros((B, T, NU))], -1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, N)).copy()
    return dict(x0=x0, Cd=Cd, c=-Cd * xu_ref, x_ref=x_ref,
                u_ref=np.zeros((B, T, NU)))


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=msg)


def _costs(p, dtype):
    return (DiagQuadCost(Cd=t(p["Cd"], dtype), c=t(p["c"], dtype)),
            dq.DiagQuadCost(Cd=j(p["Cd"], JDT[dtype]),
                            c=j(p["c"], JDT[dtype])))


def _bounds(dtype):
    return (Bounds(u_lo=t([-3.0], dtype), u_hi=t([3.0], dtype)),
            dq.Bounds(u_lo=j([-3.0], JDT[dtype]), u_hi=j([3.0], JDT[dtype])))


def _assert_state(st, jst, tol, msg):
    _close(st.x, jst.x, tol, msg)
    _close(st.u, jst.u, tol, msg)
    _close(st.rho, jst.rho, tol, msg)
    _close(st.lam.flat(), jst.lam.flat(), 10 * tol, msg)
    _close(st.hist_cost, jst.hist_cost, tol, msg)
    _close(st.hist_rho, jst.hist_rho, tol, msg)
    assert st.hist_filled == int(jst.hist_filled), msg


def test_warm_start_selection():
    """History selection: the most recent entry whose cost beats the
    incoming one (entry 0 when none does), λ rescaled, its ρ taken."""
    rng = np.random.RandomState(0)
    H = 3
    hist_cost = rng.randn(H, B)
    hist_cost[:, :4] = np.inf  # fresh history: nothing improves
    fields = dict(lam_dyn=(B, T - 1, NX), lam_init=(B, NX),
                  lam_hi=(B, T, NU), lam_lo=(B, T, NU))
    hist_lam = {k: rng.randn(H, *s) for k, s in fields.items()}
    lam = {k: rng.randn(*s) for k, s in fields.items()}
    hist_rho = rng.uniform(1, 100, (H, B, 1))
    cost_start = rng.randn(B)
    st = ALState.init(B, T, NX, NU, hist_len=H, dtype=torch.float64)
    st = dataclasses.replace(st, hist_cost=t(hist_cost), hist_rho=t(hist_rho),
                             hist_lam=Lambdas(**{k: t(v) for k, v in
                                                 hist_lam.items()}))
    jst = dataclasses.replace(
        dq.ALState.init(B, T, NX, NU, hist_len=H, dtype=jnp.float64),
        hist_cost=j(hist_cost), hist_rho=j(hist_rho),
        hist_lam=dq.Lambdas(**{k: j(v) for k, v in hist_lam.items()}))
    got = al_mpc.warm_start(Lambdas(**{k: t(v) for k, v in lam.items()}),
                            st.rho, t(cost_start), st)
    ref = jax_al.warm_start(dq.Lambdas(**{k: j(v) for k, v in lam.items()}),
                            jst.rho, j(cost_start), jst)
    _close(got[0].flat(), ref[0].flat(), 1e-13)
    _close(got[1], ref[1], 0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_fresh_carried_and_shifted(dtype):
    """Three chained scan-path solves: fresh state, the carried state (λ/ρ
    and history warm start), then after shift()."""
    p = _tracking(1)
    m, jm = Pendulum(), JaxPendulum()
    bounds, jbounds = _bounds(dtype)
    cfg = al_mpc.ALConfig(**MAIN)
    jcfg = jax_al.ALConfig(kernel="scan", **MAIN)
    st = ALState.init(B, T, NX, NU, hist_len=3, dtype=dtype)
    jst = dq.ALState.init(B, T, NX, NU, hist_len=3, dtype=JDT[dtype])
    x0, jx0 = t(p["x0"], dtype), j(p["x0"], JDT[dtype])
    tol = TOL[dtype]
    for k, step in enumerate(("fresh", "carried", "shifted")):
        if step == "shifted":
            st, jst = al_mpc.shift(st), jax_al.shift(jst)
            _assert_state(st, jst, tol, "shift")
        q = _tracking(10 + k)  # a new tracking target each call
        cost, jcost = _costs(q, dtype)
        x, u, st, stats = al_mpc.solve(m, cost, x0, bounds, st, cfg)
        jx, ju, jst, jstats = jax_al.solve(jm, jcost, jx0, jbounds, jst,
                                           jcfg)
        _close(x, jx, tol, step)
        _close(u, ju, tol, step)
        _close(stats.dyn_res, jstats.dyn_res, tol, step)
        _assert_state(st, jst, tol, step)


def test_shift_keep_multipliers():
    p = _tracking(2)
    cost, jcost = _costs(p, torch.float64)
    bounds, jbounds = _bounds(torch.float64)
    st = ALState.init(B, T, NX, NU, dtype=torch.float64)
    jst = dq.ALState.init(B, T, NX, NU, dtype=jnp.float64)
    cfg = al_mpc.ALConfig(**SMALL)
    _, _, st, _ = al_mpc.solve(Pendulum(), cost, t(p["x0"]), bounds, st, cfg)
    _, _, jst, _ = jax_al.solve(JaxPendulum(), jcost, j(p["x0"]), jbounds,
                                jst, jax_al.ALConfig(kernel="scan", **SMALL))
    st, jst = al_mpc.shift(st, True), jax_al.shift(jst, True)
    assert st.just_initialized and bool(jst.just_initialized)
    _close(st.lam.flat(), jst.lam.flat(), 1e-9)
    _close(st.x, jst.x, 1e-9)
