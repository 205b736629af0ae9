"""The port's elastic (SL1QP) trajectory QP (solvers.trajqp.solve_elastic
and elastic_traj_qp_layer) against the JAX package's, and the cases of
tests/test_trajqp.py:122-150 on the port: with a large μ on a feasible QP
the slacks vanish and the solve equals the hard one; on a QP whose
dynamics demand a jump the controls cannot make, the slacks absorb it.

Tolerances: the same IPM over the same elastic Riccati recursion, so
float64 agrees to 1e-10 relative to each field's largest entry (read:
≤ 2e-15); float32 to 1e-4 (read: ≤ 1.1e-6 over 12 iterations). The
gradients w.r.t. C, c and x0 in float64 to 1e-9 relative (read:
≤ 8.6e-15)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.core.types import Bounds
from diff_qp_mpc_tpu_torch.solvers import trajqp

DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
MU = 5.0


def random_traj_qp(seed, bsz=4, T=5, nx=2, nu=1, tight=False):
    """(C, c, A, B, f, x0) numpy arrays, C SPD per stage; ``tight`` scales
    c up so the ±1 box binds."""
    rng = np.random.RandomState(seed)
    n = nx + nu
    L = 0.3 * rng.randn(bsz, T, n, n)
    return (L @ L.transpose(0, 1, 3, 2) + np.eye(n),
            rng.randn(bsz, T, n) * (3.0 if tight else 1.0),
            np.eye(nx) + 0.1 * rng.randn(bsz, T - 1, nx, nx),
            rng.randn(bsz, T - 1, nx, nu), 0.1 * rng.randn(bsz, T - 1, nx),
            rng.randn(bsz, nx))


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(npy(got) - want).max()) / max(1.0, float(
        np.abs(want).max()))


def port_bounds(nu, dtype=torch.float64):
    return Bounds(u_lo=torch.full((nu,), -1.0, dtype=dtype),
                  u_hi=torch.full((nu,), 1.0, dtype=dtype))


def jax_bounds(nu, jdt=jnp.float64):
    return JaxBounds(u_lo=jnp.full((nu,), -1.0, jdt),
                     u_hi=jnp.full((nu,), 1.0, jdt))


@pytest.mark.parametrize("nx,nu,tight", [(2, 1, True), (3, 1, False)])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
def test_solve_elastic_matches_jax(nx, nu, tight, dtype, jdt):
    arrays = random_traj_qp(nx, nx=nx, nu=nu, tight=tight)
    ref = jax_trajqp.solve_elastic(
        *(jnp.asarray(a, jdt) for a in arrays), jax_bounds(nu, jdt), MU,
        jax_trajqp.TrajQPConfig(max_iter=12))
    got = trajqp.solve_elastic(
        *(torch.tensor(a, dtype=dtype) for a in arrays),
        port_bounds(nu, dtype), MU, trajqp.TrajQPConfig(max_iter=12))
    assert got._fields == ref._fields
    for name in ref._fields:
        assert _rel(getattr(got, name), getattr(ref, name)) <= TOL[dtype], \
            name


def test_solve_elastic_warm_start_matches_jax():
    """x_init and u_init (the SL1QP iterate) start the IPM."""
    arrays = random_traj_qp(7, tight=True)
    rng = np.random.RandomState(8)
    x_init, u_init = rng.randn(4, 5, 2), 0.5 * rng.randn(4, 5, 1)
    ref = jax_trajqp.solve_elastic(
        *(jnp.asarray(a) for a in arrays), jax_bounds(1), MU,
        jax_trajqp.TrajQPConfig(max_iter=12), jnp.asarray(x_init),
        jnp.asarray(u_init))
    got = trajqp.solve_elastic(
        *(torch.tensor(a) for a in arrays), port_bounds(1), MU,
        trajqp.TrajQPConfig(max_iter=12), torch.tensor(x_init),
        torch.tensor(u_init))
    for name in ref._fields:
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-10, name


def test_elastic_layer_gradients_match_jax():
    arrays = random_traj_qp(9, tight=True)
    weight = np.arange(1.0, 4.0)

    def jax_loss(C, c, x0):
        w = jax_trajqp.elastic_traj_qp_layer(
            C, c, *(jnp.asarray(a) for a in arrays[2:5]), x0, jax_bounds(1),
            MU, jax_trajqp.TrajQPConfig(max_iter=12))
        return jnp.sum(w ** 2 * weight)

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(arrays[i]) for i in (0, 1, 5)))
    C, c, x0 = (torch.tensor(arrays[i], requires_grad=True)
                for i in (0, 1, 5))
    w = trajqp.elastic_traj_qp_layer(
        C, c, *(torch.tensor(a) for a in arrays[2:5]), x0, port_bounds(1),
        MU, trajqp.TrajQPConfig(max_iter=12))
    (w ** 2 * torch.tensor(weight)).sum().backward()
    for name, t_, r in zip(("C", "c", "x0"), (C, c, x0), ref):
        assert _rel(t_.grad, r) <= 1e-9, name
    assert torch.equal(C.grad, C.grad.transpose(-1, -2))


def test_elastic_layer_without_grad_is_the_solve():
    arrays = [torch.tensor(a) for a in random_traj_qp(10)]
    w = trajqp.elastic_traj_qp_layer(*arrays, port_bounds(1), MU)
    sol = trajqp.solve_elastic(*arrays, port_bounds(1), MU)
    assert torch.equal(w, torch.cat([sol.x, sol.u], -1))


def test_elastic_matches_hard_when_feasible():
    """μ large and a feasible QP: the slacks vanish and the elastic solve
    equals the hard-constrained one (rtol 1e-6, atol 1e-7, as the JAX
    test)."""
    arrays = [torch.tensor(a) for a in random_traj_qp(5, bsz=3)]
    hard = trajqp.solve(*arrays, port_bounds(1),
                        trajqp.TrajQPConfig(max_iter=20))
    el = trajqp.solve_elastic(*arrays, port_bounds(1), mu=50.0,
                              cfg=trajqp.TrajQPConfig(max_iter=25))
    assert float(el.slack_l1.max()) < 1e-6
    torch.testing.assert_close(el.u, hard.u, rtol=1e-6, atol=1e-7)


def test_elastic_absorbs_infeasibility():
    """Dynamics that demand x' = x + 10 with (almost) no control authority
    and a ±1 box: the hard QP has no feasible point; the elastic solve
    stays finite and reports the violation in its slacks (μ 0.5 is below
    the marginal cost of tracking the jump)."""
    bsz, T, nx, nu = 2, 4, 2, 1
    n = nx + nu
    C = torch.eye(n, dtype=torch.float64).expand(bsz, T, n, n)
    c = torch.zeros(bsz, T, n, dtype=torch.float64)
    A = torch.eye(nx, dtype=torch.float64).expand(bsz, T - 1, nx, nx)
    B = torch.zeros(bsz, T - 1, nx, nu, dtype=torch.float64) + 1e-6
    f = torch.full((bsz, T - 1, nx), 10.0, dtype=torch.float64)
    x0 = torch.zeros(bsz, nx, dtype=torch.float64)
    el = trajqp.solve_elastic(C, c, A, B, f, x0, port_bounds(nu), mu=0.5,
                              cfg=trajqp.TrajQPConfig(max_iter=25))
    assert not bool(torch.isnan(el.x).any())
    assert float(el.slack_l1.min()) > 1.0
