"""The behaviour-cloning baselines (diff_qp_mpc_tpu_torch.learning.deq:
FFDNetwork, NNPolicy; learning.policies.NNMPCPolicy) and the trainer's and
evaluator's ``--deq`` off branch, against the JAX package's, from
flax-initialised weights mapped by params_from_flax and numpy seeds.

The JAX side runs jitted, once per case in float64, and the port runs
each case in float64 and in float32 against it. Tolerances, relative to
each quantity's largest entry: float64 1e-10 on the networks and a BC
training step, 1e-6 through the AL solve (the line search's near-ties, as
test_torch_policy_variants.py); float32 1e-4 on the networks, 1e-2 through
the solve. NNMPCPolicy runs the AL scan path.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import assert_flax_grads, load_flax, npy, rel_err
from diff_qp_mpc_tpu.learning import deq as jdeq
from diff_qp_mpc_tpu_torch.learning import deq, evaluate, train
from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

NX, NU, NQ, T, H, DT, B = 4, 1, 2, 5, 32, 0.05, 6
DTYPES = {"f64": (torch.float64, 1e-10), "f32": (torch.float32, 1e-4)}


X = np.random.RandomState(0).uniform(-1.0, 1.0, (B, NX))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _init64(module, seed, *args, **kwargs):
    """A flax module's initial parameters, cast to float64."""
    return jax.tree.map(lambda a: a.astype(jnp.float64), module.init(
        jax.random.PRNGKey(seed), *args, **kwargs))


@functools.lru_cache(maxsize=None)
def _jax_net(name, out_type, seed):
    """A flax network's float64 parameters, the weights of a fixed linear
    functional of its outputs, and its jitted outputs (None kept) and
    jax.grad."""
    jnet = (jdeq.FFDNetwork(nq=NQ, T=T, hdim=H) if name == "ffd" else
            jdeq.NNPolicy(nx=NX, nu=NU, nq=NQ, T=T, hdim=H, dt=DT,
                          out_type=out_type))
    params = _init64(jnet, seed, X)
    shapes = jax.eval_shape(jnet.apply, params, X)
    shapes = shapes if isinstance(shapes, tuple) else (shapes,)
    rng = np.random.RandomState(seed)
    ws = [None if s is None else rng.randn(*s.shape) for s in shapes]

    def loss(p):
        outs = jnet.apply(p, X)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)
                   if o is not None), outs

    (_, jouts), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, ws, jouts, jg


def _outputs_and_grads(net, dt, name, out_type, seed):
    """The port network's outputs against _jax_net's, and the gradient of
    the same functional (into .grad) against jax.grad."""
    dtype, tol = DTYPES[dt]
    params, ws, jouts, jg = _jax_net(name, out_type, seed)
    net = load_flax(net, params, dtype)
    outs = net(torch.tensor(X, dtype=dtype))
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * torch.tensor(w, dtype=dtype)).sum() for o, w in zip(outs, ws)
        if o is not None).backward()
    assert [o is None for o in outs] == [o is None for o in jouts]
    for o, jo in zip(outs, jouts):
        if o is not None:
            assert rel_err(o, jo) <= tol
    assert_flax_grads(net, jg, tol)
    return outs


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("out_type", [0, 1, 2, 3])
def test_nn_policy_matches_flax(out_type, dt):
    """NNPolicy at each out_type: (states, actions) with None where JAX has
    None, out_type 3's finite-difference velocities included."""
    net = deq.NNPolicy(NX, NU, NQ, T, H, DT, out_type=out_type)
    states, actions = _outputs_and_grads(net, dt, "nn", out_type, out_type)
    if out_type == 3:
        assert states.shape == (B, T, 2 * NQ)
        np.testing.assert_allclose(npy(states[:, -1, NQ:]),
                                   npy(states[:, -2, NQ:]))


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_ffd_network_matches_flax(dt):
    (pos,) = _outputs_and_grads(deq.FFDNetwork(NX, NQ, T, H), dt, "ffd",
                                None, 7)
    assert pos.shape == (B, T, NQ)


def test_nn_policy_refuses_out_type_4():
    with pytest.raises(ValueError, match="out_type"):
        deq.NNPolicy(NX, NU, NQ, T, H, DT, out_type=4)


# ------------------------------------------------------------ NNMPC ----
def _trackers(extra=()):
    """Both packages' pendulum tracking MPC (AL scan path, T 5, al_iter 2)
    from the trainer's flags."""
    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning.train import build_parser as jax_parser
    from diff_qp_mpc_tpu.learning.train import make_policy as jax_make
    from diff_qp_mpc_tpu_torch.envs import make_env

    argv = ["--env", "pendulum", "--deq", "--T", str(T), "--qp_iter", "2",
            "--hdim", "16", "--deq_iter", "1", *extra]
    return (jax_make(jax_parser().parse_args(argv), jax_env("pendulum")
                     ).tracking,
            train.make_policy(train.build_parser().parse_args(argv),
                              make_env("pendulum")).tracking)


def test_nn_mpc_policy_matches_flax():
    """NNMPCPolicy on the AL scan path: FFDNetwork's reference with zero
    velocities, one tracking solve; its states and actions and the
    gradient of a linear functional of both w.r.t. every parameter,
    float64 within 1e-6 and float32 within 1e-2."""
    from diff_qp_mpc_tpu.learning.policies import NNMPCPolicy as JaxNNMPC
    from diff_qp_mpc_tpu_torch.learning.policies import NNMPCPolicy

    jtrack, track = _trackers()
    jpol = JaxNNMPC(nx=2, nu=1, nq=1, T=T, hdim=H, tracking=jtrack)
    rng = np.random.RandomState(4)
    x = rng.uniform([-1.0, -1.0], [1.0, 1.0], (B, 2))
    ws, wa = rng.randn(B, T, 2), rng.randn(B, T, 1)
    params = _init64(jpol, 2, x)

    def loss(p):
        s, a = jpol.apply(p, x)
        return jnp.sum(s * ws) + jnp.sum(a * wa), (s, a)

    (_, (js, ja)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    for dt, tol in (("f64", 1e-6), ("f32", 1e-2)):
        dtype = DTYPES[dt][0]
        pol = load_flax(NNMPCPolicy(2, 1, 1, T, H, track), params, dtype)
        s, a = pol(torch.tensor(x, dtype=dtype))
        ((s * torch.tensor(ws, dtype=dtype)).sum()
         + (a * torch.tensor(wa, dtype=dtype)).sum()).backward()
        assert rel_err(s, js) <= tol and rel_err(a, ja) <= tol, dt
        assert_flax_grads(pol, jg, tol)


# ------------------------------------------------- train, evaluate ----
BC_ARGV = ["--env", "pendulum", "--T", str(T), "--hdim", "16",
           "--policy_out_type", "2", "--bsz", str(B), "--grad_clip", "0.5",
           "--expert_type", "sac"]


def test_bc_train_step_matches_jax():
    """Two clip + Adam steps of --deq off (NNPolicy, policy_out_type 2,
    float64) against the JAX trainer's jitted step: loss, gradient norm,
    a zero dyn_res, and the parameters and Adam's moments after."""
    import optax

    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning import train as jax_train
    from diff_qp_mpc_tpu_torch.envs import make_env

    jargs = jax_train.build_parser().parse_args(BC_ARGV)
    jpol = jax_train.make_policy(jargs, jax_env("pendulum"))
    params = _init64(jpol, 3, jnp.zeros((B, 2)))
    opt = optax.chain(optax.clip_by_global_norm(jargs.grad_clip),
                      optax.adam(jargs.lr))
    jstep = jax_train.make_train_step(jpol, opt, jargs)
    args = train.build_parser().parse_args(BC_ARGV + ["--device", "cpu"])
    pol = train.make_policy(args, make_env("pendulum"))
    assert isinstance(pol, deq.NNPolicy) and pol.out_type == 2
    pol = load_flax(pol, params, torch.float64)
    adam = train.Adam(dict(pol.named_parameters()), args.lr)
    step = train.make_train_step(pol, adam, args, torch.Generator())
    jstate = opt.init(params)
    rng = np.random.RandomState(1)
    for _ in range(2):
        batch = {"state": rng.uniform(-1, 1, (B, T, 2)),
                 "action": rng.uniform(-1, 1, (B, T, 1)),
                 "mask": (rng.rand(B, T) > 0.2).cumprod(1).astype(float)}
        params, jstate, jl, jle, jdr, jn = jstep(
            params, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), qp_solve=False)
        tl, tle, tdr, tn = step({k: torch.tensor(v)
                                 for k, v in batch.items()}, False)
        for got, ref in ((tl, jl), (tle, jle), (tn, jn)):
            assert rel_err(got, ref) <= 1e-10, (float(got), float(ref))
        assert float(tdr) == float(jdr) == 0.0
        assert float(tn) > jargs.grad_clip  # the clip acts
    ref = params_from_flax(_np_tree(params)["params"], pol.flax_modules())
    for name, v in pol.state_dict().items():
        assert rel_err(v, ref[name]) <= 1e-10, name
    adam_state = jstate[1][0]
    for moment, jm in (("mu", adam_state.mu), ("nu", adam_state.nu)):
        mref = params_from_flax(_np_tree(jm)["params"], pol.flax_modules())
        for name, v in getattr(adam, moment).items():
            assert rel_err(v, mref[name]) <= 1e-10, (moment, name)


X0 = np.array([[0.01, 0.0], [0.03, -0.05], [2.5, 0.0], [-3.0, 0.5]])


@pytest.mark.parametrize("out_type", [2, 1], ids=["acts", "state_only"])
def test_bc_evaluate_matches_jax(out_type):
    """evaluate_policy with deq off: 4 episodes × 10 steps of an NNPolicy
    (out_type 2, flax-initialised, float64) from the same initial states
    give the JAX evaluator's metrics; a state-only NNPolicy (out_type 1)
    raises JAX's ValueError in both."""
    from diff_qp_mpc_tpu.envs import EnvState as JaxEnvState
    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning.evaluate import (
        evaluate_policy as jax_evaluate,
    )
    from diff_qp_mpc_tpu_torch.envs import make_env

    jnet = jdeq.NNPolicy(nx=2, nu=1, nq=1, T=T, hdim=H, dt=0.05,
                         out_type=out_type)
    params = _init64(jnet, 5, jnp.zeros((4, 2)))
    jenv = jax_env("pendulum")
    jenv.reset = lambda key, bsz: JaxEnvState.make(jnp.asarray(X0))
    env = make_env("pendulum")
    net = load_flax(deq.NNPolicy(2, 1, 1, T, H, 0.05, out_type=out_type),
                params, torch.float64)
    run = lambda: evaluate.evaluate_policy(
        env, net, episodes=4, max_steps=10, device=torch.device("cpu"),
        dtype=torch.float64, x_init=torch.tensor(X0), deq=False)
    if out_type == 1:
        with pytest.raises(ValueError, match="state-only"):
            jax_evaluate(jenv, jnet, params, episodes=4, max_steps=10,
                         deq=False)
        with pytest.raises(ValueError, match="state-only"):
            run()
        return
    ref = jax_evaluate(jenv, jnet, params, episodes=4, max_steps=10,
                       deq=False)
    got = run()
    for k in ("success_rate", "mean_episode_len", "episodes"):
        assert got[k] == ref[k], k
    for k in ("mean_reward", "median_final_goal_err"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-10, atol=1e-12)


def test_bc_entry_points_train_save_and_evaluate(tmp_path):
    """train.main without --deq on the CPU: 3 steps logged "bc" under a
    bc_ run name, a checkpoint that the JAX package's load_checkpoint
    reads with its NNPolicy template and that --load resumes; then
    evaluate.main adopts deq off from its meta.json and acts with the
    NNPolicy. Without --device cpu both raise (no CUDA device)."""
    from diff_qp_mpc_tpu.envs import make_env as jax_env
    from diff_qp_mpc_tpu.learning import train as jax_train
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint

    argv = BC_ARGV + ["--iters", "3", "--ckpt_every", "1", "--save",
                      "--logdir", str(tmp_path), "--device", "cpu"]
    records = []
    pol = train.main(argv, on_step=records.append)
    assert [r["mode"] for r in records] == ["bc"] * 3
    assert all(r["dyn_res"] == 0.0 and np.isfinite(r["loss"])
               for r in records)
    run = tmp_path / train.run_name(train.build_parser().parse_args(argv))
    assert run.name.startswith("bc_pendulum")
    ckpt = str(run / "ckpt.msgpack")
    assert json.load(open(ckpt + ".meta.json"))["deq"] is False
    jpol = jax_train.make_policy(jax_train.build_parser().parse_args(
        BC_ARGV), jax_env("pendulum"))
    template = jax.eval_shape(lambda: jpol.init(jax.random.PRNGKey(0),
                                                jnp.zeros((2, 2))))
    restored = load_checkpoint(ckpt, {"params": template})["params"]
    want = params_from_flax(_np_tree(restored)["params"], pol.flax_modules())
    for k, v in pol.state_dict().items():
        assert torch.equal(want[k], v), k
    resumed = train._setup(train.build_parser().parse_args(
        argv + ["--load", "--iters", "0"]))
    assert resumed.optimizer.count == 3
    metrics = evaluate.main(["--ckpt", ckpt, "--device", "cpu",
                             "--episodes", "4", "--max_steps", "3"])
    assert metrics["steps_run"] == 3 and np.isfinite(metrics["mean_reward"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(BC_ARGV + ["--iters", "1"])
