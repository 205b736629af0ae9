"""DEQMPCPolicy options beyond the checkpoint's configuration, vs flax:
ws_mode "solution" with the warm-start state carried across the DEQ
iterates (scan solve, and solve_fused_stateful on the fused path), and
out_type 1 with freshly initialised weights mapped by params_from_flax.
float64; tolerance 1e-6 as in test_torch_al_mpc.py (line-search near-ties).
"""
import jax
import numpy as np
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
from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

X = np.random.RandomState(1).uniform([-np.pi, -1.0], [np.pi, 1.0], (8, 2))


def _compare(jpol, jparams, pol):
    jits, _ = jax.jit(lambda p, x: jpol.apply(p, x, qp_solve=True))(
        jparams, j(X))
    with torch.no_grad():
        its, _ = pol(t(X))
    assert len(its) == len(jits)
    for k, (a, b) in enumerate(zip(its, jits)):
        for name in ("net_states", "states", "actions"):
            np.testing.assert_allclose(
                npy(getattr(a, name)), np.asarray(getattr(b, name)),
                rtol=1e-6, atol=1e-6, err_msg=f"iterate {k} {name}")


def test_solution_warm_start_with_carry():
    """ws_mode "solution" with λ/ρ carried across the DEQ iterates. ρ then
    grows past 1e3 and controls sit on the ±3 bound, where the active-set
    masks switch on rounding: the JAX package's own scan and fused paths
    differ by ~3e-6 at iterate 1 and ~3e-4 at iterate 2. Each port path is
    held, per iterate, to ten times that spread (at least 1e-6)."""
    runs = {}
    for fused in (False, True):
        argv = policy_argv(fused=fused, deq_iter=3, carry="on",
                           ws_mode="solution")
        jpol, _ = jax_policy(argv)
        jits, _ = jax.jit(lambda p, x: jpol.apply(p, x, qp_solve=True))(
            jax_params(jpol), j(X))
        pol, _ = torch_policy(argv)
        assert pol.tracking.carry and pol.ws_mode == "solution"
        with torch.no_grad():
            its, _ = pol(t(X))
        runs[fused] = (jits, its)
    for k in range(3):
        traj = lambda it: np.concatenate(
            [npy(it[k].states), npy(it[k].actions)], -1)
        spread = np.abs(traj(runs[False][0]) - traj(runs[True][0])).max()
        tol = max(1e-6, 10 * spread)
        for fused, (jits, its) in runs.items():
            err = np.abs(traj(its) - traj(jits)).max()
            assert err <= tol, (k, fused, err, spread)


def test_out_type_1_with_mapped_init_weights():
    argv = policy_argv(deq_iter=2, out_type=1)
    jpol, _ = jax_policy(argv)
    params = jpol.init(jax.random.PRNGKey(3), j(X), qp_solve=False)
    state = params_from_flax(jax.tree.map(np.asarray, params)["params"])
    pol, _ = torch_policy(argv, state_dict=state)
    assert tuple(pol.layer.out.weight.shape) == (8, 128)
    _compare(jpol, params, pol)
