"""DEQMPCPolicy of the PyTorch port with the committed pendulum checkpoint's
weights vs the flax policy's apply, bsz 8, on both tracking paths (scan;
fused, with the JAX Pallas kernel in interpret mode).

Tolerances, as for the solver (test_torch_al_mpc.py): float64 1e-6
(line-search near-ties); float32 1e-2, since float32 alone moves a solve by
~5e-3 (Newton systems with cond ~1e4)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    j,
    jax_params,
    jax_policy,
    npy,
    policy_argv,
    t,
    torch_policy,
)
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve_cuda

TOL = {torch.float64: 1e-6, torch.float32: 1e-2}


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_policy_forward_matches_flax(fused, dtype):
    argv = policy_argv(fused=fused)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jpol, _ = jax_policy(argv)
    pol, _ = torch_policy(argv, dtype)
    x = np.random.RandomState(0).uniform([-np.pi, -1.0], [np.pi, 1.0],
                                         (8, 2))
    jits, jres = jax.jit(lambda p, x: jpol.apply(p, x, qp_solve=True))(
        jax_params(jpol, jdt), j(x, jdt))
    k1, k2 = btsolve_cuda.launches, al_fused_cuda.launches
    with torch.no_grad():
        its, res = pol(t(x, dtype))
    # CPU tensors take the plain versions: no kernel is counted
    assert (btsolve_cuda.launches, al_fused_cuda.launches) == (k1, k2)
    assert len(its) == len(jits) == 6
    tol = TOL[dtype]
    for k, (a, b) in enumerate(zip(its, jits)):
        assert a.states.dtype == dtype
        for name in ("net_states", "states", "actions"):
            np.testing.assert_allclose(
                npy(getattr(a, name)), np.asarray(getattr(b, name)),
                rtol=tol, atol=tol, err_msg=f"iterate {k} {name}")
    np.testing.assert_allclose(float(res), float(jres), rtol=tol, atol=tol)
