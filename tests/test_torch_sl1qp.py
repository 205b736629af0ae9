"""The port's SL1QP MPC (solvers.sl1qp_mpc) against the JAX package's on
``Integrator(nx=2, nu=1, dt=0.1)`` as tests/test_sl1qp.py sets it up (B 3,
T 5, diag(10, 10, 0.01), box ±3, μ 100, qp_iter 4): the value and the
gradient w.r.t. the cost (Cd, c) and x0 on both backends, the riccati
backend in float32 too; and the cases of tests/test_sl1qp.py on the port.

Tolerances: float64 1e-8 on x, u, the cost and slack_l1, relative to each
field's largest entry or 1 (the same SQP over the same elastic IPM; read:
≤ 3e-16), the gradients 1e-8 relative (read: ≤ 3e-16); float32 1e-3
(the rollout line search's near-ties, as the SQP tests; read: ≤ 8e-8).
The port's two backends agree to the JAX test's rtol 1e-2, atol 1e-3.

On a dense cost: the 2-link cartpole's stabilize planner at T 5 with its
terminal LQR P (datagen.expert_cost), μ 100, qp_iter 1 (one QP of QP
max_iter 20; the backends' gap is there at the first QP and stays at any
count, so the JAX traces stay at ~20 s a backend), from four states of the
env's reset draw (seed 1) where the port's backends disagree. Each port
backend is held to the JAX package's same backend in float64 to 1e-9 (read:
≤ 2.4e-12), and the riccati-vs-dense gap to JAX's own gap (0.281 of 8.77 on
u: the ℓ1 penalty is inexact there, the slacks ≈ 0.01, and the dense
expansion's problem has another minimizer, in both packages). The JAX
package's cp2 solves run jitted, with their LAPACK on one thread."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy, one_blas_thread
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.core.types import DiagQuadCost as JaxDiagQuadCost
from diff_qp_mpc_tpu.core.types import QuadCost as JaxQuadCost
from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.models import Integrator as JaxIntegrator
from diff_qp_mpc_tpu.solvers import sl1qp_mpc as jax_sl1qp
from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import datagen
from diff_qp_mpc_tpu_torch.models import Integrator
from diff_qp_mpc_tpu_torch.solvers import sl1qp_mpc, sqp_mpc

BSZ, T, NX, NU = 3, 5, 2, 1
FIELDS = ("x", "u", "cost", "slack_l1")


def problem():
    """(x0, Cd, c) numpy arrays of test_sl1qp.py's setup (x0 from numpy's
    generator, not JAX's)."""
    x0 = np.random.RandomState(0).randn(BSZ, NX)
    Cd = np.concatenate([np.full((BSZ, T, NX), 10.0),
                         np.full((BSZ, T, NU), 0.01)], -1)
    return x0, Cd, 0.1 * np.random.RandomState(1).randn(BSZ, T, NX + NU)


def port_solve(x0, Cd, c, dtype=torch.float64, differentiable=True,
               **cfg):
    return sl1qp_mpc.solve(
        Integrator(nx=2, nu=1, dt=0.1), DiagQuadCost(Cd=Cd, c=c), x0,
        Bounds(u_lo=torch.tensor([-3.0], dtype=dtype),
               u_hi=torch.tensor([3.0], dtype=dtype)),
        torch.zeros(BSZ, T, NU, dtype=dtype),
        cfg=sl1qp_mpc.SL1QPConfig(**cfg), differentiable=differentiable)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(npy(got) - want).max()) / max(1.0, float(
        np.abs(want).max()))


@pytest.mark.parametrize("backend", ["riccati", "dense"])
def test_value_and_gradient_match_jax(backend):
    """One JAX value_and_grad (the solve's outputs as aux) against the
    port's solve and backward, gradient of Σ x² + Σ u² w.r.t. Cd, c, x0."""
    x0, Cd, c = problem()
    cfg = dict(qp_iter=4, mu=100.0, backend=backend)

    def jax_loss(Cd_, c_, x0_):
        res = jax_sl1qp.solve(
            JaxIntegrator(nx=2, nu=1, dt=0.1),
            JaxDiagQuadCost(Cd=Cd_, c=c_), x0_,
            JaxBounds(u_lo=jnp.array([-3.0]), u_hi=jnp.array([3.0])),
            jnp.zeros((BSZ, T, NU)), cfg=jax_sl1qp.SL1QPConfig(**cfg))
        return jnp.sum(res.x ** 2) + jnp.sum(res.u ** 2), res

    (_, ref), grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(Cd), jnp.asarray(c), jnp.asarray(x0))
    ts = [torch.tensor(a, requires_grad=True) for a in (Cd, c, x0)]
    got = port_solve(ts[2], ts[0], ts[1], **cfg)
    for name in FIELDS:
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-8, name
    ((got.x ** 2).sum() + (got.u ** 2).sum()).backward()
    for name, t_, g in zip(("Cd", "c", "x0"), ts, grads):
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        assert _rel(t_.grad, g) <= 1e-8, name


def test_float32_matches_jax():
    x0, Cd, c = problem()
    cfg = dict(qp_iter=4, mu=100.0)
    ref = jax_sl1qp.solve(
        JaxIntegrator(nx=2, nu=1, dt=0.1),
        JaxDiagQuadCost(Cd=jnp.asarray(Cd, jnp.float32),
                        c=jnp.asarray(c, jnp.float32)),
        jnp.asarray(x0, jnp.float32),
        JaxBounds(u_lo=jnp.array([-3.0], jnp.float32),
                  u_hi=jnp.array([3.0], jnp.float32)),
        jnp.zeros((BSZ, T, NU), jnp.float32),
        cfg=jax_sl1qp.SL1QPConfig(**cfg), differentiable=False)
    got = port_solve(*(torch.tensor(a, dtype=torch.float32)
                       for a in (x0, Cd, c)), dtype=torch.float32,
                     differentiable=False, **cfg)
    for name in FIELDS:
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-3, name


def test_riccati_backend_matches_dense():
    """The structured elastic IPM against the reference-style dense
    expanded QP (port only; the JAX test's case)."""
    x0, Cd, c = (torch.tensor(a) for a in problem())
    res_r = port_solve(x0, Cd, c, qp_iter=4, mu=100.0, backend="riccati")
    res_d = port_solve(x0, Cd, c, qp_iter=4, mu=100.0, backend="dense")
    torch.testing.assert_close(res_r.u, res_d.u, rtol=1e-2, atol=1e-3)
    assert float(res_r.slack_l1.max()) < 1e-3


def test_matches_hard_sqp_when_feasible():
    x0, Cd, c = (torch.tensor(a) for a in problem())
    res_el = port_solve(x0, Cd, c, qp_iter=4, mu=100.0)
    res_hd = sqp_mpc.solve(
        Integrator(nx=2, nu=1, dt=0.1), DiagQuadCost(Cd=Cd, c=c), x0,
        Bounds(u_lo=torch.tensor([-3.0]).double(),
               u_hi=torch.tensor([3.0]).double()),
        torch.zeros(BSZ, T, NU, dtype=torch.float64),
        cfg=sqp_mpc.SQPConfig(qp_iter=4), differentiable=False)
    assert float(res_el.slack_l1.max()) < 1e-3
    torch.testing.assert_close(res_el.u, res_hd.u, rtol=1e-2, atol=1e-3)


def test_feasible_rollout_and_bounds():
    """The value is a rollout of its own controls (the line search keeps
    the iterates on the dynamics), inside the box."""
    x0, Cd, c = (torch.tensor(a) for a in problem())
    res = port_solve(x0, Cd, c, qp_iter=4, mu=50.0)
    torch.testing.assert_close(
        res.x.detach(), Integrator(nx=2, nu=1, dt=0.1).rollout(x0, res.u),
        rtol=1e-8, atol=1e-8)
    assert float(res.u.abs().max()) <= 3.0 + 1e-6


CP2_ROWS = [7, 8, 9, 12]
CP2_CFG = dict(qp_iter=1, mu=100.0)


def _cp2_problem():
    """(env, cost, x0, bounds) of the cp2 stabilize planner at T 5 with the
    terminal P, float64, from CP2_ROWS of the env's reset draw (seed 1)."""
    env = make_env("cartpole2link", stabilization=True)
    planner = datagen.planner_settings(env)
    planner["T"] = 5
    cost = datagen.expert_cost(env, planner, len(CP2_ROWS), torch.float64)
    x0 = env.reset(torch.Generator().manual_seed(1), 64,
                   dtype=torch.float64).x[CP2_ROWS]
    bounds = Bounds(u_lo=torch.tensor([-250.0], dtype=torch.float64),
                    u_hi=torch.tensor([250.0], dtype=torch.float64))
    return env, cost, x0, bounds


@functools.lru_cache(maxsize=None)
def _cp2_jax(backend):
    env, cost, x0, bounds = _cp2_problem()
    model = jax_make_env("cartpole2link", stabilization=True).model
    cfg = jax_sl1qp.SL1QPConfig(backend=backend, **CP2_CFG)

    @jax.jit  # one trace: eager JAX re-traces cp2's dynamics at every call
    def solve(C, c, x0_):
        return jax_sl1qp.solve(
            model, JaxQuadCost(C=C, c=c), x0_,
            JaxBounds(u_lo=jnp.array([-250.0]), u_hi=jnp.array([250.0])),
            jnp.zeros((len(CP2_ROWS), 5, 1)), cfg=cfg, differentiable=False)

    with one_blas_thread():
        res = solve(jnp.asarray(npy(cost.C)), jnp.asarray(npy(cost.c)),
                    jnp.asarray(npy(x0)))
        return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _cp2_port(backend):
    env, cost, x0, bounds = _cp2_problem()
    return sl1qp_mpc.solve(env.model, cost, x0, bounds,
                           torch.zeros(len(CP2_ROWS), 5, 1,
                                       dtype=torch.float64),
                           cfg=sl1qp_mpc.SL1QPConfig(backend=backend,
                                                     **CP2_CFG),
                           differentiable=False)


@pytest.mark.parametrize("backend", ["riccati", "dense"])
def test_cp2_terminal_cost_matches_jax(backend):
    ref, got = _cp2_jax(backend), _cp2_port(backend)
    for name in FIELDS:
        assert _rel(getattr(got, name), ref[name]) <= 1e-9, name
    assert float(np.abs(ref["u"]).max()) > 1.0  # the SQP moved
    assert float(ref["slack_l1"].min()) > 1e-3  # the slacks stay


def test_cp2_terminal_cost_backends_differ_as_jaxs():
    """The reference's own behaviour, which the port keeps: its riccati and
    dense backends reach different minimizers on this problem."""
    jax_gap = _cp2_jax("riccati")["u"] - _cp2_jax("dense")["u"]
    gap = npy(_cp2_port("riccati").u - _cp2_port("dense").u)
    assert np.abs(gap - jax_gap).max() <= 1e-9
    assert np.abs(jax_gap).max() > 0.1


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        sl1qp_mpc.SL1QPConfig(backend="pprefix")
