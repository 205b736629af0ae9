"""The port's plain Riccati LQR-KKT solve (K3's plain version,
diff_qp_mpc_tpu_torch.ops.riccati) against the JAX package's scan solve
(ops.riccati) and its Pallas kernel in interpret mode (ops.riccati_pallas),
at (nx, nu) = (2, 1) (the pendulum), (3, 2) and (4, 1) (every shape K3 is
built for), T 5, B 16.

Tolerances: a direct linear solve, so float64 agrees to 1e-10 relative to
the largest entry; float32 to 1e-4 (the recursion's rounding over five
stages, cond(Quu) ≲ 1e2 on these inputs). The KKT residuals of the port's
solution, computed by the JAX package's kkt_residual, are below 1e-9 in
float64.

The elastic form (``theta``, the SL1QP path's relaxed dynamics rows)
against the JAX package's batched_lqr_kkt_solve_elastic at the same shapes
and (3, 1) (the slew-augmented pendulum), Θ drawn in [0, 2], at the same
tolerances (two more small linear solves a stage); with Θ = 0 it gives the
hard recursion's bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.ops import riccati as jax_riccati
from diff_qp_mpc_tpu.ops import riccati_pallas
from diff_qp_mpc_tpu_torch.ops import riccati, riccati_cuda

B, T = 16, 5
REG = 1e-9
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]


def lqr_problem(nx, nu, seed=0):
    """Random LQR-KKT system with SPD stage costs, as numpy arrays."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T, nx, nx)
    Mu = rng.randn(B, T, nu, nu)
    return (M @ M.transpose(0, 1, 3, 2) + np.eye(nx),
            0.2 * rng.randn(B, T, nx, nu),
            Mu @ Mu.transpose(0, 1, 3, 2) + np.eye(nu),
            rng.randn(B, T, nx), rng.randn(B, T, nu),
            np.eye(nx) + 0.1 * rng.randn(B, T - 1, nx, nx),
            0.2 * rng.randn(B, T - 1, nx, nu),
            0.1 * rng.randn(B, T - 1, nx), rng.randn(B, nx))


def _close(got, want, tol, what):
    err = np.abs(npy(got) - np.asarray(want)).max()
    assert err <= tol * np.abs(np.asarray(want)).max(), (what, err)


@pytest.mark.parametrize("nx,nu", [(2, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
def test_plain_matches_jax_scan(nx, nu, dtype, jdt):
    arrays = lqr_problem(nx, nu, seed=nx)
    ref = jax_riccati.batched_lqr_kkt_solve(
        *(jnp.asarray(a, jdt) for a in arrays), REG)
    got = riccati.batched_lqr_kkt_solve(
        *(torch.tensor(a, dtype=dtype) for a in arrays), REG)
    for name in ("dx", "du", "lam", "K", "k"):
        _close(getattr(got, name), getattr(ref, name), TOL[dtype], name)


@pytest.mark.parametrize("nx,nu", [(2, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
def test_wrapper_matches_pallas_interpret(nx, nu, dtype, jdt):
    """The kernel wrapper on CPU tensors (its plain version, no launch)
    against the Pallas kernel in interpret mode."""
    arrays = lqr_problem(nx, nu, seed=10 + nx)
    ref = riccati_pallas.batched_lqr_kkt_solve(
        *(jnp.asarray(a, jdt) for a in arrays), reg=REG, interpret=True)
    before = riccati_cuda.launches
    got = riccati_cuda.batched_lqr_kkt_solve(
        *(torch.tensor(a, dtype=dtype) for a in arrays), REG)
    assert riccati_cuda.launches == before
    for name, g, r in zip(("dx", "du", "lam"), got, ref):
        _close(g, r, TOL[dtype], name)


@pytest.mark.parametrize("nx,nu", [(2, 1), (3, 2), (4, 1)])
def test_kkt_residuals(nx, nu):
    arrays = lqr_problem(nx, nu, seed=20 + nx)
    sol = riccati.batched_lqr_kkt_solve(*(torch.tensor(a) for a in arrays),
                                        0.0)
    jsol = jax_riccati.LQRSolution(*(jnp.asarray(npy(a)) for a in sol))
    residuals = jax.vmap(jax_riccati.kkt_residual)(
        *(jnp.asarray(a) for a in arrays), jsol)
    for r in residuals:
        assert float(jnp.abs(r).max()) <= 1e-9


def _theta(nx, seed):
    return np.random.RandomState(seed).uniform(0.0, 2.0, (B, T - 1, nx))


@pytest.mark.parametrize("nx,nu", [(2, 1), (3, 1), (3, 2), (4, 1)])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
def test_elastic_matches_jax(nx, nu, dtype, jdt):
    arrays = lqr_problem(nx, nu, seed=30 + nx)
    theta = _theta(nx, 40 + nx)
    ref = jax_riccati.batched_lqr_kkt_solve_elastic(
        *(jnp.asarray(a, jdt) for a in arrays), REG, jnp.asarray(theta, jdt))
    got = riccati.batched_lqr_kkt_solve_elastic(
        *(torch.tensor(a, dtype=dtype) for a in arrays), REG,
        torch.tensor(theta, dtype=dtype))
    for name in ("dx", "du", "lam", "K", "k"):
        _close(getattr(got, name), getattr(ref, name), TOL[dtype], name)


@pytest.mark.parametrize("nx,nu", [(2, 1), (3, 1)])
def test_elastic_with_zero_theta_is_the_hard_recursion(nx, nu):
    arrays = [torch.tensor(a) for a in lqr_problem(nx, nu, seed=50 + nx)]
    hard = riccati.batched_lqr_kkt_solve(*arrays, REG)
    zero = riccati.batched_lqr_kkt_solve(*arrays, REG,
                                         theta=torch.zeros(B, T - 1, nx))
    for name, a, b in zip(hard._fields, hard, zero):
        assert torch.equal(a, b), name


def test_elastic_rows_are_relaxed():
    """The solution satisfies the elastic rows: the dynamics residual of
    row t is Θₜ λ[t+1], with λ the costate −(P dx + p)."""
    arrays = [torch.tensor(a) for a in lqr_problem(3, 1, seed=60)]
    theta = torch.tensor(_theta(3, 61))
    sol = riccati.batched_lqr_kkt_solve(*arrays, 0.0, theta=theta)
    A, Bm, r = arrays[5], arrays[6], arrays[7]
    feas = sol.dx[:, 1:] - (riccati.mv(A, sol.dx[:, :-1])
                            + riccati.mv(Bm, sol.du[:, :-1]) + r)
    torch.testing.assert_close(feas, theta * sol.lam[:, 1:], rtol=1e-10,
                               atol=1e-10)
