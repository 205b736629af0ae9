"""Kernel K2's CUDA sources for the integrator, the cartpoles, the
quadrotor and the CosSin models, built for the host with g++
(``utils.k2_host``: one thread per element, no multiply-add contraction;
the quadrotor's functor in the one-lane kernel), against the plain
PyTorch version on the CPU: the kernel's own arithmetic, checked without a
card.

Tolerances as K2's card checks hold it (``k2_models``): each element's
error on xu within TOL (float32: but for at most the model's
``share_limit`` of the elements), the median within MEDIAN_LIMIT (the two
implementations sum in other orders, and the line search's first minimum
meets near-ties), at the card checks' B 256 and seed."""
import pytest
import torch

from diff_qp_mpc_tpu_torch.benchmarks import k2_models
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda
from diff_qp_mpc_tpu_torch.utils import k2_host


@pytest.mark.parametrize("name,T,dtype", k2_models.CASES, ids=str)
def test_host_build_matches_plain(name, T, dtype):
    B = 256
    args = k2_models.problem(name, B, T, dtype, seed=B, device="cpu")
    budget = k2_models.budget(name)
    host = k2_host.launch(*args, **budget)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **budget)
    assert all(bool(torch.isfinite(o).all()) for o in host)
    el = k2_models.element_errors(host, ref)
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.share_limit(name, dtype)
    assert float(el.median()) <= k2_models.MEDIAN_LIMIT[dtype]


@pytest.mark.parametrize("build_kw", [
    dict(contract=True),
    dict(contract=True, exempt=("merit_constraints",), rounded_merit=False),
    dict(contract=True, exempt=("rk4_value", "rk4_column", "chol"))],
    ids=["contract", "merit-contracted-exempt", "rk4-chol-exempt"])
def test_host_build_variants_match_plain(build_kw):
    """The bisection's builds (contraction, the merit's term contracted as
    the pendulum's, named device functions exempt) run cp1 at T 10 in
    float32 within K2's float32 check."""
    dtype = torch.float32
    args = k2_models.problem("cartpole1l", 64, 10, dtype, seed=64,
                             device="cpu")
    host = k2_host.launch(*args, **k2_models.BUDGET, **build_kw)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **k2_models.BUDGET)
    assert all(bool(torch.isfinite(o).all()) for o in host)
    el = k2_models.element_errors(host, ref)
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.SHARE_LIMIT[dtype]


def test_host_build_refuses_unknown_exempt_function():
    with pytest.raises(ValueError, match="no device function"):
        k2_host.build("al_fused_integrator", contract=True,
                      exempt=("no_such_function",))


def test_kernel_on_host_routes_the_solver():
    """Within ``kernel_on_host`` the solvers' K2 calls go to the host build
    (one per AL iteration on the stateful path)."""
    from diff_qp_mpc_tpu_torch.core.types import (
        ALState,
        Bounds,
        DiagQuadCost,
    )
    from diff_qp_mpc_tpu_torch.solvers import al_mpc

    model, Cd, c, x0, u_lo, u_hi, xi, ui = k2_models.problem(
        "cartpole1l", 4, 5, torch.float64, seed=0, device="cpu")
    st = ALState.init(4, 5, 4, 1, dtype=torch.float64)
    original = al_fused_cuda.fused_al_solve
    with k2_host.kernel_on_host() as count:
        x, u, st, _ = al_mpc.solve_fused_stateful(
            model, DiagQuadCost(Cd=Cd, c=c), x0,
            Bounds(u_lo=u_lo, u_hi=u_hi), st, al_mpc.ALConfig(al_iter=3))
    assert count["launches"] == 3
    assert al_fused_cuda.fused_al_solve is original
    assert torch.isfinite(x).all() and torch.isfinite(u).all()
