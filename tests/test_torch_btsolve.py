"""K1's plain PyTorch version (diff_qp_mpc_tpu_torch.ops.btsolve) vs the JAX
scan solver and the JAX Pallas kernel in interpret mode, and the CUDA
wrapper's dispatch and input checks. The kernel itself is held against the
plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.ops import btsolve as jax_btsolve
from diff_qp_mpc_tpu.ops import btsolve_pallas
from diff_qp_mpc_tpu_torch.ops import btsolve, btsolve_cuda

# relative to max|x|: float64 is held to rounding; float32 to the
# conditioning (≲ 10) of these systems times float32's unit roundoff
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _system(B=16, T=5, n=3, seed=0):
    """SPD block-tridiagonal H = L Lᵀ with L block lower bidiagonal."""
    rng = np.random.RandomState(seed)
    Ld = np.tril(0.3 * rng.randn(B, T, n, n), -1) + np.eye(n) * (
        1.0 + rng.rand(B, T, n, 1))
    Ls = 0.3 * rng.randn(B, T, n, n)
    D = Ld @ Ld.transpose(0, 1, 3, 2)
    D[:, 1:] += Ls[:, 1:] @ Ls[:, 1:].transpose(0, 1, 3, 2)
    O = Ls[:, 1:] @ Ld[:, :-1].transpose(0, 1, 3, 2)
    return D, O, rng.randn(B, T, n)


def _rel(got, ref):
    return np.abs(npy(got) - np.asarray(ref)).max() / np.abs(
        np.asarray(ref)).max()


@pytest.mark.parametrize("reference,n", [("scan", 3), ("scan", 5),
                                         ("pallas_interpret", 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_matches_jax(reference, dtype, n):
    D, O, b = _system(n=n, seed=n)
    reg = 1e-7
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    if reference == "scan":
        ref = jax_btsolve.batched_factor_solve(j(D, jd), j(O, jd), j(b, jd),
                                               reg)
    else:
        ref = btsolve_pallas.batched_factor_solve(
            j(D, jd), j(O, jd), j(b, jd), reg=reg, interpret=True)
    got = btsolve.batched_factor_solve(t(D, dtype), t(O, dtype),
                                       t(b, dtype), reg)
    assert got.dtype == dtype
    assert _rel(got, ref) <= TOL[dtype]


def test_solves_the_dense_system():
    D, O, b = _system(seed=3)
    reg = 1e-3
    Dt, Ot, bt = t(D), t(O), t(b)
    x = btsolve.batched_factor_solve(Dt, Ot, bt, reg)
    H = btsolve.to_dense(Dt, Ot) + reg * torch.eye(15, dtype=torch.float64)
    np.testing.assert_allclose(npy(H @ x.reshape(16, 15, 1))[..., 0],
                               b.reshape(16, 15), atol=1e-12)


def test_reads_only_the_lower_triangle():
    """As the JAX solver and both kernels do, the diagonal blocks' upper
    triangle is never read."""
    D, O, b = _system(seed=4)
    Dg = D + np.triu(np.full_like(D, 7.0), 1)
    x = btsolve.batched_factor_solve(t(D), t(O), t(b), 1e-7)
    xg = btsolve.batched_factor_solve(t(Dg), t(O), t(b), 1e-7)
    np.testing.assert_array_equal(npy(x), npy(xg))


def test_not_positive_definite_gives_nan():
    D, O, b = _system(seed=5)
    D[0, 2] = -np.eye(3)
    x = btsolve.batched_factor_solve(t(D), t(O), t(b), 0.0)
    assert torch.isnan(x[0]).all() and torch.isfinite(x[1:]).all()


def test_wrapper_takes_plain_version_on_cpu_without_counting():
    D, O, b = _system(seed=6)
    before = btsolve_cuda.launches
    got = btsolve_cuda.batched_factor_solve(t(D), t(O), t(b), 1e-7)
    ref = btsolve.batched_factor_solve(t(D), t(O), t(b), 1e-7)
    np.testing.assert_array_equal(npy(got), npy(ref))
    assert btsolve_cuda.launches == before


@pytest.mark.parametrize("case", ["block_size", "dtype", "shape", "device"])
def test_kernel_input_checks(case):
    D, O, b = (t(a, torch.float32) for a in _system(n=3, seed=7))
    if case == "block_size":
        D, O, b = (t(a, torch.float32) for a in _system(n=4, seed=7))
        err = ValueError
    elif case == "dtype":
        b = b.double()
        err = TypeError
    elif case == "shape":
        O = O[:, :-1]
        err = ValueError
    else:
        err = ValueError  # CPU tensors never reach the kernel
    with pytest.raises(err):
        btsolve_cuda._check(D, O, b)
