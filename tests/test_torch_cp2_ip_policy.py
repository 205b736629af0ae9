"""The cp2 ip checkpoint (``deqmpc_cp2_ip_term_v1``: Cartpole2L stabilize,
the interior-point SQP tracker with the terminal LQR value cost, T 5,
qp_iter 2, tracking_r 0.01, out_type 1) in the port against the JAX
package: the DEQ-MPC forward on 8 states of its expert data and one
``--terminal_lqr`` training step's gradient against ``jax.grad``, both
packages reading the checkpoint through their own readers and rebuilding
the terminal P from the env.

One of its six DEQ iterations: this file tests what the cp2 ip
checkpoint adds (the terminal P, the cp2 model at (6, 1) through the ip
solvers); the coupling of DEQ iterates is the pendulum ip policy's test
(tests/test_torch_policy_ip.py, all six). The JAX package runs its scan
path once, in float64 (``jax.value_and_grad`` with the iterates as aux:
~1 min of compiling on the CPU, ~2 min at two iterations). The port runs both its paths against it: the scan IPM over the
Riccati solve, and the fused path (K4's plain version). The JAX package's
Pallas K4 in interpret mode takes over 2.5 minutes for a single solve at
(5, 6, 1) on the CPU, so the fused path's reference at this shape is the
JAX scan IPM, to which the JAX package's tests/test_trajqp_fused.py holds
its kernel (K4's corner semantics move a solve by ≤ 3.4e-10 in float64);
tests/test_torch_trajqp.py holds K4's plain version to the interpreted
Pallas kernel at the pendulum's shape. Every iterate's states and actions
within 1e-6 of their largest entry in float64 and, for the port's float32
runs, within 1e-2 of the JAX float64 result, as the pendulum's ip policy
test holds them (the SQP line search's near-ties); the loss and every
parameter's gradient in float64 within 1e-6 relative, as
tests/test_torch_trajqp_grad.py holds the SQP's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t

CKPT = "logs/deqmpc_cp2_ip_term_v1/ckpt_best.msgpack"
DATA = "data/expert_traj_mpc-Cartpole2l-v0-stabilize_new.pkl"
TOL = {"f64": 1e-6, "f32": 1e-2}
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def _rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(npy(got).astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _argv(fused):
    return (["--env", "cartpole2link", "--stabilization", "--deq",
             "--deq_iter", "1", "--T", "5", "--hdim", "128", "--qp_solve",
             "--solver_type", "ip", "--qp_iter", "2", "--tracking_r", "0.01",
             "--terminal_lqr", "--deq_out_type", "1", "--policy_out_type",
             "1"] + (["--fused"] if fused else []))


def _window():
    """8 windows of the checkpoint's expert data, T 5."""
    from diff_qp_mpc_tpu_torch.learning import data

    batch = data.sample_window_batch(data.load_expert_pickle(DATA), 8, 5,
                                     np.random.RandomState(0),
                                     use_native=False)
    return tuple(batch[k] for k in ("state", "action", "mask"))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX package's policy (scan path, float64) with the checkpoint's
    parameters from the windows' first states: its iterates, the DEQ-MPC
    loss on the windows and its gradient (jax.value_and_grad, the iterates
    as aux), and its terminal P."""
    from diff_qp_mpc_tpu.envs import make_env
    from diff_qp_mpc_tpu.learning import losses as jax_losses
    from diff_qp_mpc_tpu.learning import train as jax_train
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    args = jax_train.build_parser().parse_args(_argv(fused=False))
    jpol = jax_train.make_policy(args, make_env("cartpole2link",
                                                stabilization=True))
    template = jpol.init(jax.random.PRNGKey(0), jnp.zeros((2, 6)),
                         qp_solve=False)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), load_checkpoint(
        CKPT, {"params": template})["params"])
    gt_s, gt_a, mask = _window()

    def jloss(prm):
        its, _ = jpol.apply(prm, j(gt_s[:, 0]), qp_solve=True)
        return jax_losses.compute_loss_deqmpc(
            1, j(gt_s), j(gt_a), j(mask), its)[0], its

    (jl, jits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    iterates = [(np.asarray(it.states), np.asarray(it.actions))
                for it in jits]
    return (iterates, float(jl), params_from_flax(jg["params"]),
            np.asarray(jpol.tracking.terminal_P))


def _port_policy(fused, dt):
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import train
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    args = train.build_parser().parse_args(_argv(fused) + ["--device",
                                                           "cpu"])
    pol = train.make_policy(args, make_env("cartpole2link",
                                           stabilization=True))
    pol.load_state_dict(load_policy_params(CKPT))
    return pol.to(DTYPES[dt])


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_checkpoint_forward_matches_jax(fused, dt):
    jits, _, _, jP = _jax_run()
    pol = _port_policy(fused, dt)
    np.testing.assert_allclose(np.asarray(pol.tracking.terminal_P), jP,
                               rtol=0, atol=1e-9 * np.abs(jP).max())
    assert pol.tracking.sqp_cfg.qp.kernel == ("fused" if fused else "scan")
    with torch.no_grad():
        its, _ = pol(t(_window()[0][:, 0], DTYPES[dt]))
    assert len(its) == len(jits) == 1
    for k, (a, (states, actions)) in enumerate(zip(its, jits)):
        assert a.states.dtype == DTYPES[dt]
        for got, ref in ((a.states, states), (a.actions, actions)):
            assert _rel(got, ref) <= TOL[dt], (k, _rel(got, ref))


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_terminal_lqr_training_gradient_matches_jax(fused):
    """The DEQ-MPC loss of the checkpoint's policy on the windows and its
    gradient with respect to every parameter, through the final QP's
    implicit backward (one Riccati solve, P included), float64. At one DEQ
    iteration the cell's state-update weights get no gradient (its state
    starts at zero): those must be exactly zero in the port too."""
    from diff_qp_mpc_tpu_torch.learning import losses

    gt_s, gt_a, mask = _window()
    _, jl, jgrads, _ = _jax_run()
    pol = _port_policy(fused, "f64")
    its, _ = pol(t(gt_s[:, 0]))
    loss = losses.compute_loss_deqmpc(1, t(gt_s), t(gt_a), t(mask), its)[0]
    assert abs(float(loss.detach()) - jl) <= 1e-6 * abs(jl)
    grads = torch.autograd.grad(loss, list(pol.parameters()))
    zero = []
    for (name, _), g in zip(pol.named_parameters(), grads):
        ref = jgrads[name]
        if float(ref.abs().max()) == 0:
            zero.append(name)
            assert float(g.abs().max()) == 0, name
            continue
        assert float((g - ref).abs().max() / ref.abs().max()) <= 1e-6, name
    assert len(zero) < len(grads) // 2, zero
