"""The quadrotor's DEQ-MPC policy in the port against the JAX package's:
the checkpoint ``deqmpc_quadrotor_fused_v8``'s forward and a training
gradient, float64 on the CPU (JAX with x64 on, tests/conftest.py; the
port's K2 and K1 run their plain versions). The JAX side runs its scan
path: its quadrotor kernel in interpret mode takes minutes at these sizes,
and its own tests/test_al_fused.py holds the two equal. Tracing JAX's
quadrotor solve takes ~20 s on the CPU, so one JAX run (``_jax_run``)
serves both tests."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_port_common import j, jax_template, npy, t

CKPT = "logs/deqmpc_quadrotor_fused_v8/ckpt_best.msgpack"


def _rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(npy(got).astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _policy_argv(hdim, deq_iter, fused):
    return (["--env", "rexquadrotor", "--deq", "--deq_iter", str(deq_iter),
             "--bsz", "4", "--T", "5", "--hdim", str(hdim), "--qp_solve",
             "--qp_iter", "2", "--rho_max", "1e4", "--deq_out_type", "1",
             "--policy_out_type", "1", "--solver_carry", "on",
             "--grad_clip", "10"] + (["--fused"] if fused else []))


def _jax_policy(argv):
    from diff_qp_mpc_tpu.envs import make_env as jax_make_env
    from diff_qp_mpc_tpu.learning import train as jax_train

    args = jax_train.build_parser().parse_args(argv)
    return jax_train.make_policy(args, jax_make_env("rexquadrotor"))


def _port_policy(argv):
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import train

    args = train.build_parser().parse_args(argv + ["--device", "cpu"])
    return train.make_policy(args, make_env("rexquadrotor")).double(), args


def _window():
    """A window of the checkpoint's expert data: 4 states, T 5."""
    from diff_qp_mpc_tpu_torch.learning import data

    batch = data.sample_window_batch(
        data.load_expert_pickle("data/expert_traj_mpc-RexQuadrotor-v0_new"
                                ".pkl"), 4, 5, np.random.RandomState(0),
        use_native=False)
    return tuple(batch[k] for k in ("state", "action", "mask"))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX package's policy with the checkpoint's parameters (hdim 128,
    T 5, qp_iter 2, rho_max 1e4, warm starts carried), over two of its six
    DEQ iterations (the iterations past the second repeat the second's
    code), from the window's first states: its iterates' states and
    actions, and the DEQ-MPC loss on the window with its gradient
    (jax.value_and_grad, the iterates as aux) through the AL solves'
    implicit backwards, in float64."""
    from diff_qp_mpc_tpu.learning import losses as jax_losses
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    gt_s, gt_a, mask = _window()
    jpol = _jax_policy(_policy_argv(128, 2, fused=False))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), load_checkpoint(
        CKPT, {"params": jax_template(jpol, 12)})["params"])

    def jloss(prm):
        its, _ = jpol.apply(prm, j(gt_s[:, 0]), qp_solve=True)
        return jax_losses.compute_loss_deqmpc(1, j(gt_s), j(gt_a), j(mask),
                                              its)[0], its

    (jl, jits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    iterates = [(np.asarray(it.states), np.asarray(it.actions))
                for it in jits]
    return iterates, float(jl), params_from_flax(jg["params"])


def _port_checkpoint_policy(fused):
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    pol, _ = _port_policy(_policy_argv(128, 2, fused))
    pol.load_state_dict(load_policy_params(CKPT))
    return pol.double()


def test_checkpoint_policy_forward_matches_jax():
    """The checkpoint's policy on the window's 4 states, with its
    parameters through both packages' checkpoint readers: the JAX
    package's forward on its scan path (``_jax_run``) against the port's
    on both its paths (the fused path's K2 and the scan path's K1 run
    their plain versions here). Every iterate's states and actions within
    1e-6 of their largest entry, as the pendulum's and cp1's policy tests
    hold them."""
    x0 = _window()[0][:, 0]
    jits = _jax_run()[0]
    for fused in (True, False):
        with torch.no_grad():
            its, _ = _port_checkpoint_policy(fused)(t(x0))
        assert len(its) == len(jits) == 2
        for k, (a, (states, actions)) in enumerate(zip(its, jits)):
            for got, ref in ((a.states, states), (a.actions, actions)):
                assert _rel(got, ref) <= 1e-6, (fused, k)
    # the actions live in the box [0, 20], not about 0
    u = npy(its[-1].actions)
    assert u.min() >= -1e-6 and u.max() <= 20.0 + 1e-6 and u.mean() > 5.0


def test_training_gradient_matches_jax():
    """The DEQ-MPC loss of the checkpoint's policy on the window and its
    gradient with respect to every parameter, through the AL solves'
    implicit backwards, against jax.grad of the JAX package's scan path
    (``_jax_run``), on the port's fused path (K2 forward, K1 backward,
    both plain here), in float64. Held to 1e-6 relative to each quantity's
    largest entry, as tests/test_torch_train.py holds the pendulum's."""
    from diff_qp_mpc_tpu_torch.learning import losses

    gt_s, gt_a, mask = _window()
    _, jl, jgrads = _jax_run()
    pol = _port_checkpoint_policy(fused=True)
    its, _ = pol(t(gt_s[:, 0]))
    loss = losses.compute_loss_deqmpc(1, t(gt_s), t(gt_a), t(mask), its)[0]
    assert abs(float(loss.detach()) - jl) <= 1e-6 * abs(jl)
    grads = torch.autograd.grad(loss, list(pol.parameters()))
    for (name, _), g in zip(pol.named_parameters(), grads):
        ref = jgrads[name]
        assert float(ref.abs().max()) > 0, name
        assert float((g - ref).abs().max() / ref.abs().max()) <= 1e-6, name
