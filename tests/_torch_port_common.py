"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py):
both packages built from the same flags, the committed pendulum checkpoint
loaded into each, and numpy <-> tensor helpers. JAX runs on the CPU (x64 on,
tests/conftest.py); the port's tensors lie on the CPU, so its kernel
wrappers take their plain PyTorch versions."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

CKPT = "logs/deqmpc_pendulum_sac_fused_T5_bsz256/ckpt.msgpack"

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
                carry="off", ws_mode="proposal"):
    """Flags of the checkpoint's configuration (its meta.json, with the
    solver_carry that evaluation adopts for it)."""
    return (["--env", "pendulum", "--deq", "--deq_iter", str(deq_iter),
             "--qp_iter", str(qp_iter), "--deq_out_type", str(out_type),
             "--T", "5", "--hdim", "128", "--solver_carry", carry,
             "--ws_mode", ws_mode] + (["--fused"] if fused else []))


def jax_policy(argv):
    """(flax policy, env) from the JAX trainer's flags; the fused path runs
    its Pallas kernel in interpret mode."""
    from diff_qp_mpc_tpu.envs import make_env
    from diff_qp_mpc_tpu.learning.train import build_parser, make_policy

    args = build_parser().parse_args(argv)
    env = make_env(args.env)
    pol = make_policy(args, env)
    if args.fused:
        cfg = dataclasses.replace(pol.tracking.cfg, interpret=True)
        pol = pol.clone(tracking=dataclasses.replace(pol.tracking, cfg=cfg))
    return pol, env


def torch_policy(argv, dtype=torch.float64, state_dict=None):
    """(port policy, env) from the same flags, with the checkpoint's weights
    unless ``state_dict`` is given."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    args = build_parser().parse_args(argv)
    env = make_env(args.env)
    pol = make_policy(args, env)
    pol.load_state_dict(state_dict if state_dict is not None
                        else load_policy_params(CKPT))
    return pol.to(dtype), env


def jax_params(pol, dtype=jnp.float64):
    """The committed checkpoint's parameters for the flax policy."""
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint

    x = jnp.zeros((2, 2), jnp.float32)
    template = pol.init(jax.random.PRNGKey(0), x, qp_solve=False)
    params = load_checkpoint(CKPT, {"params": template})["params"]
    return jax.tree.map(lambda a: a.astype(dtype), params)
