"""The port's OptNet QP layer (diff_qp_mpc_tpu_torch.solvers.qp) against the
JAX package's (solvers.qp) and the scipy oracle, at small sizes, the cases
of tests/test_qp.py: the forward of both solvers ("dense", "prefactor")
with neq 0 and 3, the constraints, all six gradients against jax.grad of
qp_layer (the prefactor layer's too), dQ symmetric, expanded inputs, and a
singular KKT and a Q that is not positive definite, which must give the
JAX package's non-finite values instead of raising.

Tolerances: the two packages run the same LAPACK factorizations in the
same order, so float64 agrees to rounding amplified over 20 IPM
iterations: 1e-9 relative to each field's largest entry (read: ≤ 2e-14).
float32 to 1e-4 (read: ≤ 3e-6). The oracle (SLSQP, float64) to the JAX
test's rtol 1e-4, atol 1e-5. Gradients in float64 to 1e-8 relative
(read: ≤ 1.3e-14)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.solvers import qp as jax_qp
from diff_qp_mpc_tpu_torch.solvers import oracles, qp

DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
NAMES = ("Q", "p", "G", "h", "A", "b")


def random_qp(seed, bsz, nz, nineq, neq):
    """Feasible-by-construction random QPs (h = G z0 + s0, b = A z0), as
    numpy arrays."""
    rng = np.random.RandomState(seed)
    L = rng.randn(bsz, nz, nz)
    Q = L @ L.transpose(0, 2, 1) + 0.5 * np.eye(nz)
    p = rng.randn(bsz, nz)
    G = rng.randn(bsz, nineq, nz)
    z0 = rng.randn(bsz, nz)
    s0 = rng.uniform(0.2, 1.0, (bsz, nineq))
    h = np.einsum("bij,bj->bi", G, z0) + s0
    A = rng.randn(bsz, neq, nz)
    b = np.einsum("bij,bj->bi", A, z0)
    return Q, p, G, h, A, b


def _rel(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    return float(np.abs(npy(got) - want).max(initial=0.0)) / scale


@pytest.mark.parametrize("solver", ["dense", "prefactor"])
@pytest.mark.parametrize("neq", [0, 3])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
def test_forward_matches_jax(solver, neq, dtype, jdt):
    arrays = random_qp(neq, 6, 5, 4, neq)
    ref = jax_qp.qp_solve(*(jnp.asarray(a, jdt) for a in arrays),
                          jax_qp.QPConfig(solver=solver))
    got = qp.qp_solve(*(torch.tensor(a, dtype=dtype) for a in arrays),
                      qp.QPConfig(solver=solver))
    for name in ("z", "lam", "nu", "s"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= TOL[dtype], \
            name
    # float32's Schur system breaks down near convergence on some
    # elements, in both packages alike: their residual total is NaN there
    np.testing.assert_array_equal(np.isnan(npy(got.resids)),
                                  np.isnan(np.asarray(ref.resids)))
    finite = ~np.isnan(npy(got.resids))
    assert _rel(got.resids[finite], np.asarray(ref.resids)[finite]) \
        <= TOL[dtype]


@pytest.mark.parametrize("solver", ["dense", "prefactor"])
@pytest.mark.parametrize("neq", [0, 3])
def test_forward_matches_oracle(solver, neq):
    arrays = random_qp(10 + neq, 6, 5, 4, neq)
    got = qp.qp_solve(*(torch.tensor(a) for a in arrays),
                      qp.QPConfig(max_iter=25, solver=solver))
    Q, p, G, h, A, b = arrays
    for i in range(len(Q)):
        z_ref, _, _, _ = oracles.solve_qp_np(
            Q[i], p[i], G[i], h[i], A[i] if neq else None,
            b[i] if neq else None)
        np.testing.assert_allclose(npy(got.z[i]), z_ref, rtol=1e-4,
                                   atol=1e-5)


def test_constraints_satisfied():
    Q, p, G, h, A, b = (torch.tensor(a) for a in random_qp(1, 8, 6, 5, 2))
    sol = qp.qp_solve(Q, p, G, h, A, b)
    assert float(((G @ sol.z[..., None])[..., 0] - h).max()) < 1e-6
    assert float(((A @ sol.z[..., None])[..., 0] - b).abs().max()) < 1e-6
    assert float(sol.lam.min()) > -1e-8  # dual feasibility


@pytest.mark.parametrize("solver", ["dense", "prefactor"])
@pytest.mark.parametrize("neq", [0, 2])
def test_gradients_match_jax(solver, neq):
    """All six gradients of Σ z² · k against jax.grad of the JAX layer; the
    backward is the dense KKT solve under either solver, as in JAX."""
    arrays = random_qp(20 + neq, 3, 4, 3, neq)
    weight = np.arange(1.0, 5.0)
    jcfg = jax_qp.QPConfig(solver=solver)
    ref = jax.grad(lambda *a: jnp.sum(jax_qp.qp_layer(*a, jcfg) ** 2
                                      * weight),
                   argnums=tuple(range(6)))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    z = qp.qp_layer(*ts, qp.QPConfig(solver=solver))
    (z ** 2 * torch.tensor(weight)).sum().backward()
    for name, t_, r in zip(NAMES, ts, ref):
        assert t_.grad.shape == t_.shape, name
        assert _rel(t_.grad, r) <= 1e-8, name
    if neq == 0:
        assert not ts[4].grad.any() and not ts[5].grad.any()


def test_dQ_is_symmetric():
    ts = [torch.tensor(a, requires_grad=True)
          for a in random_qp(3, 2, 4, 3, 0)]
    (qp.qp_layer(*ts) ** 3).sum().backward()
    dQ = ts[0].grad
    assert torch.equal(dQ, dQ.transpose(-1, -2))


def test_expanded_inputs_reduce_their_gradient():
    """A shared A_p broadcast to the batch (the sudoku example): the
    gradient reaching A_p is the batch sum of the layer's, which the same
    QPs given as distinct copies give."""
    Q, p, G, h, A, b = random_qp(4, 5, 6, 4, 2)
    A_p = torch.tensor(A[0], requires_grad=True)
    args = [torch.tensor(a) for a in (Q, p, G, h)]
    b_t = torch.tensor(np.einsum("ij,bj->bi", A[0],
                                 np.random.RandomState(5).randn(5, 6)))
    z = qp.qp_layer(*args, A_p.expand(5, 2, 6), b_t)
    (z ** 2).sum().backward()
    A_full = torch.tensor(np.broadcast_to(A[0], (5, 2, 6)).copy(),
                          requires_grad=True)
    (qp.qp_layer(*args, A_full, b_t) ** 2).sum().backward()
    torch.testing.assert_close(A_p.grad, A_full.grad.sum(0), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("case", ["singular_dense", "not_pd_prefactor"])
def test_breakdown_gives_jax_non_finite_values(case):
    """A KKT matrix that is exactly singular (Q = 0, G = 0, no
    regularization) and a Q that is not positive definite under the
    prefactor solver: no exception, and non-finite values where the JAX
    package has them."""
    Q, p, G, h, A, b = random_qp(2, 2, 4, 3, 0)
    if case == "singular_dense":
        Q, G = np.zeros_like(Q), np.zeros_like(G)
        kw = dict(kkt_reg=0.0)
    else:
        Q = -Q
        kw = dict(solver="prefactor")
    arrays = (Q, p, G, h, A, b)
    ref = jax_qp.qp_solve(*(jnp.asarray(a) for a in arrays),
                          jax_qp.QPConfig(**kw))
    got = qp.qp_solve(*(torch.tensor(a) for a in arrays), qp.QPConfig(**kw))
    for name in ("z", "lam", "s", "resids"):
        want = np.asarray(getattr(ref, name))
        assert not np.isfinite(want).all(), name
        np.testing.assert_array_equal(np.isfinite(npy(getattr(got, name))),
                                      np.isfinite(want), err_msg=name)


def test_unknown_solver_raises():
    with pytest.raises(ValueError):
        qp.QPConfig(solver="lu")
