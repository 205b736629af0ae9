"""AL merit numerics and the damped Newton solver of the PyTorch port
(ops.almerit, ops.newton_al) vs the JAX package, pendulum, T 5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_qp_mpc_tpu.core import types as dq
from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.models.base import step_with_jac as jax_step_with_jac
from diff_qp_mpc_tpu.ops import almerit as jax_almerit
from diff_qp_mpc_tpu.ops import newton_al as jax_newton
from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost, Lambdas
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import almerit, newton_al

B, T, NX, NU = 8, 5, 2, 1
N = NX + NU


def _problem(seed=0):
    """Random iterate with some controls beyond the ±3 box, random λ ≥ 0 on
    the bounds and ρ per element, tracking-style diagonal cost."""
    rng = np.random.RandomState(seed)
    return dict(
        x=rng.uniform(-1, 1, (B, T, NX)), u=rng.uniform(-4, 4, (B, T, NU)),
        x0=rng.uniform(-1, 1, (B, NX)),
        Cd=np.broadcast_to([10.0, 1.0, 0.01], (B, T, N)).copy(),
        c=rng.randn(B, T, N), lam_dyn=rng.randn(B, T - 1, NX),
        lam_init=rng.randn(B, NX), lam_hi=rng.rand(B, T, NU),
        lam_lo=rng.rand(B, T, NU), rho=rng.uniform(0.5, 20.0, (B, 1)))


def _torch(p, dtype=torch.float64):
    tt = lambda k: t(p[k], dtype)
    return (DiagQuadCost(Cd=tt("Cd"), c=tt("c")),
            Bounds(u_lo=t([-3.0], dtype), u_hi=t([3.0], dtype)),
            Lambdas(tt("lam_dyn"), tt("lam_init"), tt("lam_hi"),
                    tt("lam_lo")), tt("rho"))


def _jax(p, dtype=jnp.float64):
    jj = lambda k: j(p[k], dtype)
    return (dq.DiagQuadCost(Cd=jj("Cd"), c=jj("c")),
            dq.Bounds(u_lo=j([-3.0], dtype), u_hi=j([3.0], dtype)),
            dq.Lambdas(jj("lam_dyn"), jj("lam_init"), jj("lam_hi"),
                       jj("lam_lo")), jj("rho"))


def _close(got, ref, tol):
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=tol, atol=tol)


def test_residuals_cost_and_merit():
    p = _problem()
    cost, bounds, lam, rho = _torch(p)
    jcost, jbounds, jlam, jrho = _jax(p)
    res = almerit.residuals(Pendulum(), t(p["x"]), t(p["u"]), t(p["x0"]),
                            bounds)
    jres = jax_almerit.residuals(JaxPendulum(), j(p["x"]), j(p["u"]),
                                 j(p["x0"]), jbounds)
    for a, b in zip(res, jres):
        _close(a, b, 1e-13)
    _close(res.clamped().flat_norm(), jres.clamped().flat_norm(), 1e-13)
    xu = np.concatenate([p["x"], p["u"]], -1)
    _close(almerit.compute_cost(cost, t(xu)),
           jax_almerit.compute_cost(jcost, j(xu)), 1e-13)
    _close(almerit.merit_value(cost, res, lam, rho, t(xu)),
           jax_almerit.merit_value(jcost, jres, jlam, jrho, j(xu)), 1e-12)
    _close(almerit.lambda_update(lam, res, rho).flat(),
           jax_almerit.lambda_update(jlam, jres, jrho).flat(), 1e-13)


def test_merit_grad_hess_and_pinning():
    p = _problem(1)
    cost, bounds, lam, rho = _torch(p)
    jcost, jbounds, jlam, jrho = _jax(p)
    m = Pendulum()
    g, D, O, _ = almerit.merit_grad_hess(cost, m.jac, t(p["x"]), t(p["u"]),
                                         t(p["x0"]), bounds, lam, rho)
    jg, jD, jO, _ = jax_almerit.merit_grad_hess(
        jcost, jax_step_with_jac(JaxPendulum().step), j(p["x"]), j(p["u"]),
        j(p["x0"]), jbounds, jlam, jrho)
    for a, b in ((g, jg), (D, jD), (O, jO)):
        _close(a, b, 1e-11)
    pinned = newton_al.pin_first_state(g, D, O, NX)
    jpinned = jax_newton.pin_first_state(jg, jD, jO, NX)
    for a, b in zip(pinned, jpinned):
        _close(a, b, 1e-11)


def test_line_search():
    p = _problem(2)
    cost, bounds, lam, rho = _torch(p)
    jcost, jbounds, jlam, jrho = _jax(p)
    rng = np.random.RandomState(3)
    xu = np.concatenate([p["x"], p["u"]], -1)
    xu[:, 0, :NX] = p["x0"]
    upd = rng.randn(B, T, N)
    upd[:, 0, :NX] = 0.0
    jm = jax_newton._merit_at(jcost, JaxPendulum(), j(xu), j(p["x0"]),
                              jbounds, jlam, jrho)
    ref = jax_newton.line_search(jcost, JaxPendulum(), j(xu), j(upd), jm,
                                 j(p["x0"]), jbounds, jlam, jrho, 20)
    got = newton_al.line_search(cost, Pendulum(), t(xu), t(upd), t(jm),
                                t(p["x0"]), bounds, lam, rho, 20)
    for a, b in zip(got, ref):
        _close(a, b, 1e-12)


# float64: both are exact Newton on the same merit, and the line search's
# first-minimum rule agrees while merits are far from ties; float32: the
# Newton systems amplify rounding (cond ~1e4 at R 0.01)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9),
                                       (torch.float32, 1e-2)])
def test_newton_al(dtype, tol):
    p = _problem(4)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    cost, bounds, lam, rho = _torch(p, dtype)
    jcost, jbounds, jlam, jrho = _jax(p, jd)
    xu = np.concatenate([p["x"], p["u"]], -1)
    kw = dict(n_newton=4, n_ls=20, reg=1e-7)
    ref = jax_newton.newton_al(
        jcost, JaxPendulum(), jax_step_with_jac(JaxPendulum().step),
        j(xu, jd), j(p["x0"], jd), jbounds, jlam, jrho, kernel="scan", **kw)
    m = Pendulum()
    got = newton_al.newton_al(cost, m, m.jac, t(xu, dtype),
                              t(p["x0"], dtype), bounds, lam, rho, **kw)
    assert got.xu.dtype == dtype
    _close(got.xu, ref.xu, tol)
    _close(got.merit, ref.merit, tol)
    _close(got.step_size, ref.step_size, 0)
    _close(got.status, ref.status, 0)
