"""DEQMPCPolicy of the PyTorch port with the committed ip checkpoint's
weights (logs/deqmpc_pendulum_ip_fused_v2: out_type 1, the interior-point
SQP tracker, qp_iter 2) against the flax policy's apply, bsz 8, deq_iter 6,
every iterate's net_states, states and actions: on the scan IPM path in
float64 and float32, and on the fused path (K4's plain version against the
JAX Pallas kernel in interpret mode) in float64.

Tolerances as test_torch_policy.py's: float64 1e-6 (the SQP line search's
near-ties at convergence; measured 2.3e-7 on these inputs); float32 1e-2
(measured 4.2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    IP_CKPT,
    ip_policy_argv,
    j,
    jax_params,
    jax_policy,
    npy,
    t,
    torch_policy,
)
from diff_qp_mpc_tpu_torch.learning import policies
from diff_qp_mpc_tpu_torch.ops import riccati_cuda, trajqp_fused_cuda

TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
X = np.random.RandomState(0).uniform([-np.pi, -1.0], [np.pi, 1.0], (8, 2))


def _compare(monkeypatch, fused, dtype):
    """Runs both policies, compares every iterate, and returns the type of
    the box bounds each tracking solve handed the SQP solver."""
    seen = []
    solve = policies.sqp_mpc.solve

    def spy(model, cost, x0, bounds, **kw):
        seen.append(type(bounds.u_lo))
        return solve(model, cost, x0, bounds, **kw)

    monkeypatch.setattr(policies.sqp_mpc, "solve", spy)
    argv = ip_policy_argv(fused=fused)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jpol, _ = jax_policy(argv)
    pol, _ = torch_policy(argv, dtype, ckpt=IP_CKPT)
    assert pol.tracking.solver_type == "ip"
    assert pol.tracking.sqp_cfg.qp.kernel == ("fused" if fused else "scan")
    jits, jres = jax.jit(lambda p, x: jpol.apply(p, x, qp_solve=True))(
        jax_params(jpol, jdt, ckpt=IP_CKPT), j(X, jdt))
    k3, k4 = riccati_cuda.launches, trajqp_fused_cuda.launches
    with torch.no_grad():
        its, res = pol(t(X, dtype))
    # CPU tensors take the plain versions: no kernel is counted
    assert (riccati_cuda.launches, trajqp_fused_cuda.launches) == (k3, k4)
    assert len(its) == len(jits) == 6
    tol = TOL[dtype]
    for k, (a, b) in enumerate(zip(its, jits)):
        assert a.states.dtype == dtype
        for name in ("net_states", "states", "actions"):
            np.testing.assert_allclose(
                npy(getattr(a, name)), np.asarray(getattr(b, name)),
                rtol=tol, atol=tol, err_msg=f"iterate {k} {name}")
    np.testing.assert_allclose(float(res), float(jres), rtol=tol, atol=tol)
    return seen


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_scan_policy_matches_flax(monkeypatch, dtype):
    assert set(_compare(monkeypatch, False, dtype)) == {torch.Tensor}


def test_fused_policy_matches_flax(monkeypatch):
    """Also: the fused branch hands the SQP solver the box as python float
    tuples (the JAX fused kernel needs static bounds; a traced box crashed
    ip-fused training there)."""
    assert set(_compare(monkeypatch, True, torch.float64)) == {tuple}
