"""The implicit backward of the port's trajectory-QP layer
(solvers.trajqp.traj_qp_layer, traj_qp_layer_static) and of its SQP MPC
(solvers.sqp_mpc.solve) against jax.grad through the JAX package's custom
VJPs (its fused kernel in interpret mode), and the port's VJPs against
central finite differences as the JAX package's tests/test_trajqp.py checks
its own. Also the SQP straight-through value: NaN wherever the final QP's
w_hat is not finite, in both packages.

Layer inputs are tests/test_torch_trajqp.py's random QPs at the pendulum's
shape (T 5, nx 2, nu 1), B 8, with the control gradient scaled so that
some controls sit on the ±3 box; SQP inputs tests/test_torch_sqp_mpc.py's
(pendulum tracking, qp_iter 2), B 8. Both use TrajQPConfig's defaults
(max_iter 12, reg 1e-9) and the box ±3, so that the JAX fused kernel is
traced once per dtype in this file. The loss is Σ W ⊙ w with W from a
numpy seed; gradients are compared relative to their largest entry.
Tolerances: float64 1e-6 relative (measured: layer ≤ 1.4e-15, SQP
≤ 1.2e-14; the SQP's line search can meet near-ties that move its forward
by ~7e-7, and with it the final QP's linearization point, on other
inputs); float32 1e-2 relative (measured: layer ≤ 1.7e-7, SQP ≤ 1.5e-5).
Finite differences: |g − fd| < 1e-2 + 1e-3·|fd|, the JAX test's bound, at
eps 1e-6, max_iter 25, reg 1e-11."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.core.types import DiagQuadCost as JaxDiagQuadCost
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.solvers import sqp_mpc as jax_sqp
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp
from test_torch_trajqp import random_traj_qp

TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
B = 8
WRT = (0, 1, 5)  # C, c, x0 in the layer's argument order


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(npy(got) - ref).max() / np.abs(ref).max())


def _jax_layer(kernel):
    return (jax_trajqp.traj_qp_layer_static if kernel == "fused"
            else jax_trajqp.traj_qp_layer)


def _port_layer(kernel):
    return (trajqp.traj_qp_layer_static if kernel == "fused"
            else trajqp.traj_qp_layer)


def _jax_bounds(kernel, jdt):
    if kernel == "fused":  # the fused kernel's static python tuples
        return JaxBounds(u_lo=(-3.0,), u_hi=(3.0,))
    return JaxBounds(u_lo=jnp.array([-3.0], jdt), u_hi=jnp.array([3.0], jdt))


def _port_bounds(kernel, dtype):
    if kernel == "fused":
        return Bounds(u_lo=(-3.0,), u_hi=(3.0,))
    return Bounds(u_lo=torch.tensor([-3.0], dtype=dtype),
                  u_hi=torch.tensor([3.0], dtype=dtype))


def _layer_problem():
    arrays = list(random_traj_qp(B=B, T=5, nx=2, nu=1, seed=11))
    arrays[1] = arrays[1] * np.array([1.0, 1.0, 30.0])  # push u to the box
    return arrays


@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_layer_vjp_matches_jax_grad(kernel, dtype, jdt):
    arrays = _layer_problem()
    W = np.random.RandomState(1).randn(*arrays[1].shape)
    jcfg = jax_trajqp.TrajQPConfig(kernel=kernel,
                                   interpret=kernel == "fused")

    def jloss(C, c, x0):
        a = [jnp.asarray(x, jdt) for x in arrays]
        a[0], a[1], a[5] = C, c, x0
        w = _jax_layer(kernel)(*a, _jax_bounds(kernel, jdt), jcfg)
        return jnp.sum(jnp.asarray(W, jdt) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(arrays[i], jdt) for i in WRT))
    tens = [torch.tensor(a, dtype=dtype) for a in arrays]
    for i in WRT:
        tens[i].requires_grad_()
    w = _port_layer(kernel)(*tens, _port_bounds(kernel, dtype),
                            trajqp.TrajQPConfig(kernel=kernel))
    assert float(w.detach()[..., 2].abs().max()) > 3.0 - 1e-3  # bound active
    (torch.tensor(W, dtype=dtype) * w).sum().backward()
    for i, r in zip(WRT, ref):
        assert _rel(tens[i].grad, r) <= TOL[dtype], (i, _rel(tens[i].grad,
                                                             r))
    for i in (2, 3, 4):  # A, B, f are constants of the layer
        assert tens[i].grad is None


@pytest.mark.parametrize("wrt", ["C", "c", "x0"])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_layer_gradients_vs_fd(kernel, wrt):
    arrays = random_traj_qp(B=2, T=4, nx=2, nu=1, seed=2)
    idx = {"C": 0, "c": 1, "x0": 5}[wrt]
    bounds = _port_bounds(kernel, torch.float64)
    cfg = trajqp.TrajQPConfig(max_iter=25, reg=1e-11, kernel=kernel)

    def loss(theta):
        args = [torch.tensor(a) for a in arrays]
        args[idx] = theta
        return (_port_layer(kernel)(*args, bounds, cfg) ** 2).sum()

    theta0 = torch.tensor(arrays[idx], requires_grad=True)
    loss(theta0).backward()
    g = npy(theta0.grad).reshape(-1)
    rng = np.random.RandomState(0)
    eps = 1e-6
    for ci in rng.choice(g.size, size=min(6, g.size), replace=False):
        e = np.zeros(g.size)
        e[ci] = eps
        pert = torch.tensor(e.reshape(arrays[idx].shape))
        if wrt == "C":
            pert = 0.5 * (pert + pert.transpose(-1, -2))
        with torch.no_grad():
            fd = (float(loss(theta0 + pert)) - float(loss(theta0 - pert))) \
                / (2 * eps)
        assert abs(g[ci] - fd) < 1e-2 + 1e-3 * abs(fd), (wrt, ci, g[ci], fd)


def _sqp_problem(seed=0):
    from test_torch_sqp_mpc import tracking_problem

    x0, x_ref, u_ref, Cd, c = tracking_problem(seed)
    return x0, x_ref, u_ref, Cd, c, np.random.RandomState(9).randn(B, 5, 3)


def _jax_sqp(kernel, jdt, x0, x_ref, u_ref, Cd, c):
    bounds = _jax_bounds(kernel, jdt)
    cfg = jax_sqp.SQPConfig(qp_iter=2, qp=jax_trajqp.TrajQPConfig(
        kernel=kernel, interpret=kernel == "fused"))
    return jax_sqp.solve(JaxPendulum(), JaxDiagQuadCost(Cd=Cd, c=c), x0,
                         bounds, u_ref, x_ref, cfg, differentiable=True)


def _port_sqp(kernel, dtype, x0, x_ref, u_ref, Cd, c):
    bounds = _port_bounds(kernel, dtype)
    cfg = sqp_mpc.SQPConfig(qp_iter=2, qp=trajqp.TrajQPConfig(kernel=kernel))
    return sqp_mpc.solve(Pendulum(), DiagQuadCost(Cd=Cd, c=c), x0, bounds,
                         u_ref, x_ref, cfg, differentiable=True)


@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_sqp_vjp_matches_jax_grad(kernel, dtype, jdt):
    """Gradients w.r.t. the diagonal cost (Cd, c) and x0 through the final
    QP; the SQP iterations and the warm starts carry none."""
    x0, x_ref, u_ref, Cd, c, W = _sqp_problem()
    jt = lambda a: jnp.asarray(a, jdt)

    def jloss(Cd_, c_, x0_, x_ref_):
        res = _jax_sqp(kernel, jdt, x0_, x_ref_, jt(u_ref), Cd_, c_)
        return jnp.sum(jt(W) * jnp.concatenate([res.x, res.u], -1))

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(jt(Cd), jt(c), jt(x0),
                                                jt(x_ref))
    tens = [torch.tensor(a, dtype=dtype, requires_grad=True)
            for a in (Cd, c, x0, x_ref)]
    res = _port_sqp(kernel, dtype, tens[2], tens[3],
                    torch.tensor(u_ref, dtype=dtype), tens[0], tens[1])
    (torch.tensor(W, dtype=dtype) * torch.cat([res.x, res.u], -1)) \
        .sum().backward()
    for name, got, r in zip(("Cd", "c", "x0"), tens[:3], ref[:3]):
        assert _rel(got.grad, r) <= TOL[dtype], (name, _rel(got.grad, r))
    # the warm start is detached, in both packages
    assert float(np.abs(np.asarray(ref[3])).max()) == 0.0
    assert tens[3].grad is None


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_sqp_value_is_nan_where_w_hat_is_not(monkeypatch, kernel):
    """Both packages return w_value + (w_hat − stop_gradient(w_hat)): with
    the final QP's x plan non-finite at some entries (which the rollout
    line search never reads), the returned x is NaN there and only
    there."""
    bad = [(1, 2, 0), (4, 4, 1), (6, 0, 1)]

    def poison(layer, to_inf):
        def poisoned(*a, **kw):
            w = layer(*a, **kw)
            for b, t_, i in bad:
                w = to_inf(w, b, t_, i)
            return w
        return poisoned

    def jax_inf(w, b, t_, i):
        return w.at[b, t_, i].set(jnp.inf)

    def port_inf(w, b, t_, i):
        w = w.clone()
        w[b, t_, i] = float("inf")
        return w

    name = "traj_qp_layer_static" if kernel == "fused" else "traj_qp_layer"
    monkeypatch.setattr(jax_trajqp, name, poison(getattr(jax_trajqp, name),
                                                 jax_inf))
    monkeypatch.setattr(trajqp, name, poison(getattr(trajqp, name),
                                             port_inf))
    x0, x_ref, u_ref, Cd, c, _ = _sqp_problem()
    ref = _jax_sqp(kernel, jnp.float64, *(jnp.asarray(a) for a in
                                          (x0, x_ref, u_ref, Cd, c)))
    got = _port_sqp(kernel, torch.float64, *(torch.tensor(a) for a in
                                             (x0, x_ref, u_ref, Cd, c)))
    jx, px = np.asarray(ref.x), npy(got.x)
    where = np.zeros(jx.shape, bool)
    for idx in bad:
        where[idx] = True
    np.testing.assert_array_equal(np.isnan(jx), where)
    np.testing.assert_array_equal(np.isnan(px), where)
    np.testing.assert_allclose(px[~where], jx[~where], rtol=1e-6, atol=1e-6)
    assert np.isfinite(npy(got.u)).all() and np.isfinite(
        np.asarray(ref.u)).all()
