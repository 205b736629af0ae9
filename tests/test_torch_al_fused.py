"""The fused AL path of the PyTorch port (solvers.al_mpc.solve_fused and
solve_fused_stateful, K2's plain version in ops.al_fused_cuda) vs the JAX
package. The JAX fused path runs its Pallas kernel in interpret mode, as
tests/test_al_fused.py does.

Tolerances: float64 results agree to rounding unless a line search meets a
near-tie (candidate merits equal to within rounding, first minimum wins),
which moves a step by a power of two; the JAX Pallas kernel and the plain
version differ by up to ~1e-7 for that reason, so float64 is held to 1e-6.
In float32 the Newton systems amplify rounding (cond ~1e4 at R 0.01);
float32 alone moves a solve by ~5e-3, so float32 is held to 1e-2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.core import types as dq
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.ops.al_fused_pallas import fused_al_solve as jax_fused
from diff_qp_mpc_tpu.solvers import al_mpc as jax_al
from diff_qp_mpc_tpu_torch.core.types import ALState, Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda
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


@pytest.mark.parametrize("budget", ["small", "main"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_fused_plain_matches_pallas_interpret(budget, dtype):
    """solve_fused on CPU tensors (K2's plain version) vs the JAX
    solve_fused with its Pallas kernel in interpret mode."""
    bud = SMALL if budget == "small" else MAIN
    p = _tracking(3)
    cost, jcost = _costs(p, dtype)
    bounds, jbounds = _bounds(dtype)
    u_init = np.zeros((B, T, NU))
    x, u, res = al_mpc.solve_fused(Pendulum(), cost, t(p["x0"], dtype),
                                   bounds, al_mpc.ALConfig(**bud),
                                   x_init=t(p["x_ref"], dtype),
                                   u_init=t(u_init, dtype))
    jx, ju, jres = jax_al.solve_fused(
        JaxPendulum(), jcost, j(p["x0"], JDT[dtype]), jbounds,
        jax_al.ALConfig(kernel="scan", interpret=True, **bud),
        x_init=j(p["x_ref"], JDT[dtype]), u_init=j(u_init, JDT[dtype]),
        differentiable=False)
    assert x.dtype == dtype
    for a, b in ((x, jx), (u, ju), (res, jres)):
        _close(a, b, TOL[dtype])


def test_fused_reference_with_warm_start_inputs():
    """fused_al_solve_reference with carried λ/ρ inputs and every output
    (xu, λ_dyn, λ_hi, λ_lo, res) vs the JAX kernel in interpret mode."""
    p = _tracking(4)
    rng = np.random.RandomState(5)
    lam = dict(lam_dyn=rng.randn(B, T - 1, NX), lam_hi=rng.rand(B, T, NU),
               lam_lo=rng.rand(B, T, NU))
    rho0 = rng.uniform(1.0, 100.0, B)
    x_init = p["x_ref"]
    u_init = rng.uniform(-4, 4, (B, T, NU))
    kw = dict(SMALL, rho_factor=10.0)
    got = al_fused_cuda.fused_al_solve(
        Pendulum(), t(p["Cd"]), t(p["c"]), t(p["x0"]), (-3.0,), (3.0,),
        t(x_init), t(u_init), rho0=t(rho0),
        **{k: t(v) for k, v in lam.items()}, **kw)
    ref = jax_fused(JaxPendulum(), j(p["Cd"]), j(p["c"]), j(p["x0"]),
                    np.array([-3.0]), np.array([3.0]), j(x_init), j(u_init),
                    interpret=True, rho0=j(rho0),
                    **{k: j(v) for k, v in lam.items()}, **kw)
    for a, b in zip(got, ref):
        _close(a, b, 1e-6)


def test_solve_fused_stateful_chain():
    """Two chained warm-started solve_fused_stateful calls (one kernel
    launch per AL iteration, history kept here) vs JAX."""
    m, jm = Pendulum(), JaxPendulum()
    bounds, jbounds = _bounds(torch.float64)
    bud = dict(SMALL, al_iter=2)
    cfg = al_mpc.ALConfig(**bud)
    jcfg = jax_al.ALConfig(kernel="scan", interpret=True, **bud)
    st = ALState.init(B, T, NX, NU, hist_len=3, dtype=torch.float64)
    jst = dq.ALState.init(B, T, NX, NU, hist_len=3, dtype=jnp.float64)
    for k in range(2):
        p = _tracking(20 + k)
        cost, jcost = _costs(p, torch.float64)
        x, u, st, stats = al_mpc.solve_fused_stateful(
            m, cost, t(p["x0"]), bounds, st, cfg)
        jx, ju, jst, jstats = jax_al.solve_fused_stateful(
            jm, jcost, j(p["x0"]), jbounds, jst, jcfg, differentiable=False)
        _close(x, jx, 1e-6, f"solve {k}")
        _close(u, ju, 1e-6, f"solve {k}")
        _close(stats.dyn_res, jstats.dyn_res, 1e-6, f"solve {k}")
        _assert_state(st, jst, 1e-6, f"solve {k}")
