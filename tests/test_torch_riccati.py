"""The port's plain Riccati LQR-KKT solve (K3's plain version,
diff_qp_mpc_tpu_torch.ops.riccati) against the JAX package's scan solve
(ops.riccati) and its Pallas kernel in interpret mode (ops.riccati_pallas),
at (nx, nu) = (2, 1) (the pendulum), (3, 2) and (4, 1) (every shape K3 is
built for), T 5, B 16.

Tolerances: a direct linear solve, so float64 agrees to 1e-10 relative to
the largest entry; float32 to 1e-4 (the recursion's rounding over five
stages, cond(Quu) ≲ 1e2 on these inputs). The KKT residuals of the port's
solution, computed by the JAX package's kkt_residual, are below 1e-9 in
float64."""
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


def test_elastic_theta_is_not_ported():
    arrays = [torch.tensor(a) for a in lqr_problem(2, 1)]
    with pytest.raises(NotImplementedError):
        riccati.batched_lqr_kkt_solve(*arrays, REG,
                                      theta=torch.zeros(B, T - 1, 2))
