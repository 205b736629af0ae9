"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
both packages built from the same flags, a committed pendulum checkpoint
loaded into each (the AL one unless a test names the ip one), and numpy <->
tensor helpers, and ways to keep the JAX side's tracing down (a
checkpoint template by shape, a jitted model for the terminal LQR cost).
JAX runs on the CPU (x64 on, tests/conftest.py); the port's tensors lie on
the CPU, so its kernel wrappers take their plain PyTorch versions."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

CKPT = "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack"
# ip tracking solver, out_type 1 (its meta.json)
IP_CKPT = "logs/deqmpc_pendulum_ip_fused_v2/ckpt.msgpack"

torch.set_num_threads(1)


def t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def j(a, dtype=jnp.float64):
    return jnp.asarray(np.asarray(a), dtype)


def npy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def policy_argv(fused=False, deq_iter=6, qp_iter=2, out_type=2,
                carry="off", ws_mode="proposal", solver_type="al"):
    """Flags of the checkpoint's configuration (its meta.json, with the
    solver_carry that evaluation adopts for it)."""
    return (["--env", "pendulum", "--deq", "--deq_iter", str(deq_iter),
             "--qp_iter", str(qp_iter), "--deq_out_type", str(out_type),
             "--T", "5", "--hdim", "128", "--solver_carry", carry,
             "--ws_mode", ws_mode, "--solver_type", solver_type]
            + (["--fused"] if fused else []))


def ip_policy_argv(fused=False, deq_iter=6):
    """Flags of the ip checkpoint's configuration (its meta.json)."""
    return policy_argv(fused=fused, deq_iter=deq_iter, out_type=1,
                       solver_type="ip")


def jax_policy(argv):
    """(flax policy, env) from the JAX trainer's flags; the fused path runs
    its Pallas kernel (K2, or K4 on the ip path) in interpret mode."""
    from diff_qp_mpc_tpu.envs import make_env
    from diff_qp_mpc_tpu.learning.train import build_parser, make_policy

    args = build_parser().parse_args(argv)
    env = make_env(args.env)
    pol = make_policy(args, env)
    if args.fused and args.solver_type == "ip":
        sqp = pol.tracking.sqp_cfg
        sqp = dataclasses.replace(
            sqp, qp=dataclasses.replace(sqp.qp, interpret=True))
        pol = pol.clone(
            tracking=dataclasses.replace(pol.tracking, sqp_cfg=sqp))
    elif args.fused:
        cfg = dataclasses.replace(pol.tracking.cfg, interpret=True)
        pol = pol.clone(tracking=dataclasses.replace(pol.tracking, cfg=cfg))
    return pol, env


def torch_policy(argv, dtype=torch.float64, state_dict=None, ckpt=CKPT):
    """(port policy, env) from the same flags, with the weights of ``ckpt``
    unless ``state_dict`` is given."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    args = build_parser().parse_args(argv)
    env = make_env(args.env)
    pol = make_policy(args, env)
    pol.load_state_dict(state_dict if state_dict is not None
                        else load_policy_params(ckpt))
    return pol.to(dtype), env


def jax_params(pol, dtype=jnp.float64, ckpt=CKPT):
    """A committed checkpoint's parameters for the flax policy."""
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint

    params = load_checkpoint(ckpt, {"params": jax_template(pol, 2)})[
        "params"]
    return jax.tree.map(lambda a: a.astype(dtype), params)


class JittedJaxModel:
    """A JAX package dynamics model whose batched step runs jitted, for the
    JAX side of a test: eager JAX re-traces a model's dynamics (the
    cartpoles' Lagrangian derivatives) at every call, tens of seconds a call
    on the CPU. The same computation; every other attribute is the
    model's."""

    def __init__(self, model):
        self._model = model
        self._step = jax.jit(model.__call__)

    def __call__(self, x, u):
        return self._step(x, u)

    def __getattr__(self, name):
        return getattr(self._model, name)


@contextlib.contextmanager
def jitted_jax_terminal_cost():
    """Within the block, the JAX package's ``lqr.terminal_value_cost``
    linearizes a JittedJaxModel of its model at the goal (the JAX trainer's
    make_policy and the JAX expert import it from there when called)."""
    from diff_qp_mpc_tpu.solvers import lqr

    orig = lqr.terminal_value_cost
    lqr.terminal_value_cost = (
        lambda model, *a, **kw: orig(JittedJaxModel(model), *a, **kw))
    try:
        yield
    finally:
        lqr.terminal_value_cost = orig


@contextlib.contextmanager
def one_blas_thread():
    """Within the block, SciPy's OpenBLAS, which JAX's CPU LAPACK kernels
    call (batched LU and solves), on one thread. Its threads spin while
    they wait: with the suite's workers on every core, the sudoku example's
    float64 step ran ~20 times slower than alone. Block on JAX's results
    inside the block: its dispatch is asynchronous."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def jax_template(pol, nx):
    """The shapes of a flax DEQ-MPC policy's parameters, as
    load_checkpoint's template (traced, not run: flax's eager init compiles
    every op on its own)."""
    return jax.eval_shape(lambda: pol.init(
        jax.random.PRNGKey(0), jnp.zeros((2, nx), jnp.float32),
        qp_solve=False))


def rel_err(got, want):
    """max |got − want| over max |want|, in float64."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(npy(got).astype(np.float64) - want).max()) / scale


def load_flax(module, params, dtype):
    """``module`` cast to ``dtype``, then given a flax tree's weights by its
    ``flax_modules()`` (cast first: flax's float64 initial draws are not
    all float32 numbers)."""
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    module.to(dtype).load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params)["params"], module.flax_modules()))
    return module


def assert_flax_grads(module, jgrads, tol):
    """Every parameter's .grad of the port module within ``tol`` (relative
    to its largest entry) of a flax gradient tree, mapped by name."""
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    ref = params_from_flax(jax.tree.map(np.asarray, jgrads)["params"],
                           module.flax_modules())
    named = dict(module.named_parameters())
    assert set(ref) == set(named)
    for name, p in named.items():
        err = rel_err(p.grad, ref[name])
        assert err <= tol, (name, err)
