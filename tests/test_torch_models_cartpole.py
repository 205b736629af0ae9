"""The integrator and the cartpoles of the PyTorch port vs the JAX package:
step, the one-state ODE and the Jacobians, the closed form that kernel K2's
functors evaluate (``step_parts``, ``jac``) against the JAX ``step_parts``
and its ``jax.jvp`` columns, the 2-link golden vectors, the clips and
wraps, and the integrators of models.base.

Tolerances: float64 agrees to rounding (the closed form and JAX's
automatic differentiation of the energies sum in other orders), held to
1e-10 on steps and Jacobians (1e-11 and 1e-10 for the closed form);
float32 to 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu import models as jm
from diff_qp_mpc_tpu.models import base as jbase
from diff_qp_mpc_tpu_torch import models as tm
from test_cartpole2l_reference_golden import F_PKG, F_V1, U, X

# (name, JAX model, port model, input scale of x, of u)
MODELS = {
    "integrator": (lambda: jm.Integrator(dt=0.1),
                   lambda: tm.Integrator(dt=0.1)),
    "integrator_nq2": (lambda: jm.Integrator(nx=4, nu=2),
                       lambda: tm.Integrator(nx=4, nu=2)),
    "cartpole1l": (jm.Cartpole1L, tm.Cartpole1L),
    "cartpole1l_env": (lambda: jm.Cartpole1L(dt=0.05, max_force=100.0),
                       lambda: tm.Cartpole1L(dt=0.05, max_force=100.0)),
    "cartpole2l": (jm.Cartpole2L, tm.Cartpole2L),
    "cartpole2l_pkg": (jm.Cartpole2L.pkg, tm.Cartpole2L.pkg),
    "cossin": (jm.CartpoleCosSin, tm.CartpoleCosSin),
}
CLOSED_FORM = ["integrator", "integrator_nq2", "cartpole1l",
               "cartpole1l_env", "cartpole2l", "cartpole2l_pkg"]
TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


def _inputs(model, seed=0, B=16):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, 2.0, (B, model.nx))
    if isinstance(model, jm.CartpoleCosSin):  # (x, ẋ, cos θ, sin θ, θ̇)
        th = rng.uniform(-np.pi, np.pi, B)
        x[:, 2], x[:, 3] = np.cos(th), np.sin(th)
    u = rng.uniform(-5.0, 5.0, (B, model.nu))
    return x, u


def _pair(name):
    make_j, make_t = MODELS[name]
    return make_j(), make_t()


def _lagrangian_ode(model):
    """The port's ``lagrangian_ode`` of a cartpole's energies (the JAX
    package's, written in torch): ẋ = f(x, u) of one state."""
    cos = torch.cos
    if isinstance(model, tm.Cartpole1L):
        M, m, l, g = model.M, model.m, model.l, model.g

        def kinetic(q, qd):
            v2 = qd[0] ** 2 + (l * qd[1]) ** 2 + 2 * l * qd[1] * qd[0] * cos(
                q[1])
            return 0.5 * M * qd[0] ** 2 + 0.5 * m * v2

        def potential(q):
            return -m * g * l * cos(q[1])
    else:
        M, m1, m2, g = model.M, model.m1, model.m2, model.g
        l1 = model.l1
        r1, r2 = model.com * model.l1, model.com * model.l2
        inertia = model.link_inertia

        def kinetic(q, qd):
            th1, phi = q[1], q[1] + q[2]
            xd, w1, w12 = qd[0], qd[1], qd[1] + qd[2]
            v1x, v1y = xd + r1 * w1 * cos(th1), r1 * w1 * torch.sin(th1)
            t1x, t1y = xd + l1 * w1 * cos(th1), l1 * w1 * torch.sin(th1)
            v2x = t1x + r2 * w12 * cos(phi)
            v2y = t1y + r2 * w12 * torch.sin(phi)
            return (0.5 * M * xd ** 2 + 0.5 * m1 * (v1x ** 2 + v1y ** 2)
                    + 0.5 * m2 * (v2x ** 2 + v2y ** 2)
                    + 0.5 * inertia * (w1 ** 2 + w12 ** 2))

        def potential(q):
            h2 = -l1 * cos(q[1]) - r2 * cos(q[1] + q[2])
            return g * (m1 * -r1 * cos(q[1]) + m2 * h2)

    def input_map(q, u):
        return torch.cat([u, u.new_zeros(model.nq - 1)])

    return tm.lagrangian_ode(kinetic, potential, input_map)


def _autodiff_step(model, x, u):
    """RK4 of ``_lagrangian_ode`` (the JAX package's step), batched by
    vmap."""
    ode = _lagrangian_ode(model)
    return torch.func.vmap(lambda xx, uu: tm.rk4(ode, xx, uu, model.dt))(
        x, u)


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=tol,
                               atol=tol, err_msg=msg)


@functools.lru_cache(maxsize=None)
def _jax_refs(name):
    """The JAX model's step and Jacobians (``jac``: jax.jacfwd of its step)
    and, for K2's models, its step_parts with every input column's
    derivative ([B, nx, n], jax.jacfwd of step_parts: the jax.jvp per
    column of the Pallas kernel, batched) on ``_inputs`` (seed 0), once
    per model."""
    jmod = MODELS[name][0]()
    nx, nu = jmod.nx, jmod.nu
    x, u = _inputs(jmod)
    refs = dict(x=x, u=u, step=jax.jit(jmod.__call__)(j(x), j(u)),
                jac=jax.jit(jmod.jac)(j(x), j(u)))
    if name in CLOSED_FORM:
        def parts(xu):  # one element's (x, u) -> x_next
            out = jmod.step_parts(tuple(xu[i] for i in range(nx)),
                                  tuple(xu[nx + i] for i in range(nu)))
            return jnp.stack(out)

        xu = jnp.concatenate([j(x), j(u)], -1)
        refs["parts"] = (jax.jit(jax.vmap(parts))(xu),
                         jax.jit(jax.vmap(jax.jacfwd(parts)))(xu))
    return refs


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", list(MODELS))
def test_step_matches_jax(name, dtype):
    refs = _jax_refs(name)
    got = MODELS[name][1]()(t(refs["x"], dtype), t(refs["u"], dtype))
    assert got.dtype == dtype
    _close(got, refs["step"], TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", list(MODELS))
def test_jac_matches_jax(name, dtype):
    """The port's Jacobians (the closed form's forward-mode pass, the
    integrator's exact form, CosSin's forward-mode pass) vs jax.jacfwd."""
    refs = _jax_refs(name)
    xn_ref, (A_ref, B_ref) = refs["jac"]
    xn, (A, B) = MODELS[name][1]().jac(t(refs["x"], dtype),
                                      t(refs["u"], dtype))
    for got, ref in ((xn, xn_ref), (A, A_ref), (B, B_ref)):
        _close(got, ref, TOL[dtype])


@pytest.mark.parametrize("name", ["cartpole1l", "cartpole2l",
                                  "cartpole2l_pkg"])
def test_lagrangian_ode_and_autodiff_step_match_jax(name):
    """The port's Lagrangian engine (torch.func hessian/jacfwd/grad and
    linalg.solve) on the model's energies, one state, vs the JAX model's
    ``_ode``; and its RK4 step vs the JAX model's step."""
    refs = _jax_refs(name)
    jmod, tmod = _pair(name)
    ode = _lagrangian_ode(tmod)
    x, u = refs["x"][:4], refs["u"][:4]
    for i in range(2):
        _close(ode(t(x[i]), t(u[i])), jmod._ode(j(x[i]), j(u[i])),
               1e-11, f"state {i}")
    _close(_autodiff_step(tmod, t(x), t(u)), refs["step"][:4], 1e-11)
    got32 = _autodiff_step(tmod, t(x, torch.float32), t(u, torch.float32))
    assert got32.dtype == torch.float32
    _close(got32, refs["step"][:4], 1e-5)


@pytest.mark.parametrize("name", CLOSED_FORM)
def test_closed_form_matches_jax_step_parts(name):
    """The plain torch version of each CUDA functor (step_parts, and jac's
    forward-mode columns) vs JAX's step_parts and its jvp columns, float64:
    the hand-derived M(q) and b = τ − c against automatic differentiation
    of the energies, before any card run."""
    refs = _jax_refs(name)
    f_ref, J_ref = refs["parts"]
    tmod = MODELS[name][1]()
    x, u = t(refs["x"]), t(refs["u"])
    f = tmod.step_parts(tuple(x.unbind(-1)), tuple(u.unbind(-1)))
    _close(torch.stack(f, -1), f_ref, 1e-11)
    xn, (A, B) = tmod.jac(x, u)
    _close(xn, f_ref, 1e-11)
    _close(torch.cat([A, B], -1), J_ref, 1e-10)


@pytest.mark.parametrize("golden", ["default", "pkg"])
@pytest.mark.parametrize("how", ["step", "step_autodiff"])
def test_cartpole2l_reference_golden(golden, how):
    """Both 2-link reference models' golden next states, from the closed
    form and from RK4 of the Lagrangian engine on the energies."""
    model = tm.Cartpole2L() if golden == "default" else tm.Cartpole2L.pkg()
    out = (model.step(t(X), t(U)) if how == "step"
           else _autodiff_step(model, t(X), t(U)))
    np.testing.assert_allclose(npy(out), F_V1 if golden == "default"
                               else F_PKG, atol=5e-9, rtol=0)


@pytest.mark.parametrize("name", ["cartpole1l", "cartpole2l_pkg",
                                  "integrator", "cossin"])
def test_clips_match_jax(name):
    jmod, tmod = _pair(name)
    rng = np.random.RandomState(4)
    x = rng.uniform(-12.0, 12.0, (32, jmod.nx))
    u = rng.uniform(-900.0, 900.0, (32, jmod.nu))
    np.testing.assert_array_equal(npy(tmod.action_clip(t(u))),
                                  np.asarray(jmod.action_clip(j(u))))
    _close(tmod.state_clip(t(x)), jmod.state_clip(j(x)), 1e-13)


def test_cartpole2l_wrap_is_seam_free_at_goal():
    """θ₂ slightly below its goal 0 stays near 0 ([−π, π)); θ₁ slightly
    below 0 wraps to near 2π ([0, 2π)); as the JAX package's seam case."""
    m = tm.Cartpole2L.pkg()
    x = torch.zeros(1, 6, dtype=torch.float64)
    x[0, 1], x[0, 2] = -0.10, -0.02
    y = m.state_clip(x)
    assert abs(float(y[0, 1]) - (2 * np.pi - 0.10)) < 1e-12
    assert abs(float(y[0, 2]) - (-0.02)) < 1e-12
    np.testing.assert_allclose(
        npy(y), np.asarray(jm.Cartpole2L.pkg().state_clip(j(npy(x)))),
        atol=1e-13)


@pytest.mark.parametrize("wrap", ["angle_normalize", "angle_normalize_2pi"])
def test_angle_wraps_match_jax(wrap):
    a = np.array([-10.0, -2 * np.pi, -np.pi, -0.1, 0.0, 3.0, np.pi,
                  2 * np.pi, 7.5])
    _close(getattr(tm, wrap)(t(a)), getattr(jbase, wrap)(j(a)), 1e-14)


@pytest.mark.parametrize("integ", ["euler", "midpoint", "rk4"])
def test_integrators_match_jax(integ):
    jmod, tmod = _pair("cartpole1l")
    x, u = _inputs(jmod, seed=5, B=1)
    ref = getattr(jbase, integ)(jmod._ode, j(x[0]), j(u[0]), 0.05)
    got = getattr(tm, integ)(_lagrangian_ode(tmod), t(x[0]), t(u[0]), 0.05)
    _close(got, ref, 1e-12)


def test_semi_implicit_euler_matches_jax():
    x, u = _inputs(jm.Integrator(nx=4, nu=2), seed=6)
    accel_j = lambda x_, u_: -x_[..., :2] + u_
    accel_t = lambda x_, u_: -x_[..., :2] + u_
    ref = jbase.semi_implicit_euler(accel_j, j(x), j(u), 0.1, 2)
    _close(tm.semi_implicit_euler(accel_t, t(x), t(u), 0.1, 2), ref, 1e-14)


def test_integrator_refuses_unpaired_state():
    with pytest.raises(ValueError):
        tm.Integrator(nx=3, nu=1)
