"""The port's CUDA kernels against their plain PyTorch versions, on the card.
This file imports no JAX, so it runs on the GPU machine:

    python -m pytest -p no:xdist -o addopts="" -m cuda tests/test_torch_cuda_kernels.py

Without a CUDA device every test skips. Tolerances as in chip_smoke.py."""
import numpy as np
import pytest
import torch

from diff_qp_mpc_tpu_torch.core.types import ALState, Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve, btsolve_cuda
from diff_qp_mpc_tpu_torch.solvers import al_mpc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _system(B, T, n, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    Ld = np.tril(0.3 * rng.randn(B, T, n, n), -1) + np.eye(n) * (
        1.0 + rng.rand(B, T, n, 1))
    Ls = 0.3 * rng.randn(B, T, n, n)
    D = Ld @ Ld.transpose(0, 1, 3, 2)
    D[:, 1:] += Ls[:, 1:] @ Ls[:, 1:].transpose(0, 1, 3, 2)
    O = Ls[:, 1:] @ Ld[:, :-1].transpose(0, 1, 3, 2)
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return to(D), to(O), to(rng.randn(B, T, n))


@pytest.mark.parametrize("n", btsolve_cuda.BLOCK_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btsolve_kernel_matches_plain(cuda, n, dtype, tol):
    D, O, b = _system(100, 5, n, dtype, cuda, seed=n)
    before = btsolve_cuda.launches
    x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7)
    assert btsolve_cuda.launches == before + 1
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    assert float((x - ref).abs().max() / ref.abs().max()) <= tol


def test_btsolve_kernel_refuses_unbuilt_block_size(cuda):
    D, O, b = _system(4, 3, 4, torch.float32, cuda)
    with pytest.raises(ValueError):
        btsolve_cuda.batched_factor_solve(D, O, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-2),
                                       (torch.float64, 1e-6)])
def test_al_fused_kernel_matches_plain(cuda, dtype, tol):
    B, T = 100, 5
    rng = np.random.RandomState(0)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, 2), axis=1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, 3)).copy()
    c = -Cd * np.concatenate([x_ref, np.zeros((B, T, 1))], -1)
    to = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    args = (Pendulum(), to(Cd), to(c), to(x0), (-3.0,), (3.0,), to(x_ref),
            torch.zeros(B, T, 1, dtype=dtype, device=cuda))
    kw = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)
    before = al_fused_cuda.launches
    out = al_fused_cuda.fused_al_solve(*args, **kw)
    assert al_fused_cuda.launches == before + 1
    ref = al_fused_cuda.fused_al_solve_reference(*args, **kw)
    for i in (0, 4):  # xu and res, as chip_smoke.py checks them
        assert float((out[i] - ref[i]).abs().max()) <= tol


def test_solve_fused_stateful_launches_once_per_al_iteration(cuda):
    B, T = 8, 5
    cost = DiagQuadCost(
        Cd=torch.tensor([10.0, 1.0, 0.01], device=cuda).expand(B, T, 3),
        c=torch.zeros(B, T, 3, device=cuda))
    st = ALState.init(B, T, 2, 1, dtype=torch.float32, device=cuda)
    before = al_fused_cuda.launches
    x, u, st, stats = al_mpc.solve_fused_stateful(
        Pendulum(), cost, torch.full((B, 2), 0.2, device=cuda),
        Bounds(u_lo=(-3.0,), u_hi=(3.0,)), st, al_mpc.ALConfig())
    assert al_fused_cuda.launches == before + 2
    assert torch.isfinite(x).all() and torch.isfinite(stats.dyn_res).all()
