"""The port's training path (learning.losses, learning.data with its native
window sampler, learning.train) against the JAX package's.

- losses on fixed iterates, every out_type, float64 to 1e-12 (the same
  sums in another order);
- the window sampler: the port's native library and the JAX package's
  at the same seed, and both numpy samplers on the same RandomState, give
  identical batches;
- one training step of the DEQ-MPC phase (AL fused and ip fused, grad_clip
  1 on, the parameters of one flax initialization carried across, B 4,
  deq_iter 2, hdim 16, float64): loss, gradient, gradient norm, and after
  two steps the parameters and Adam's moments against the JAX trainer's
  jitted step with optax (its fused kernels in interpret mode). Held to 1e-6
  relative to each quantity's largest entry, as the solves' VJPs (measured
  ≤ 3.0e-7 over all of them, AL and ip: the AL forward's line-search
  near-ties move a solve by ~1e-7, and Adam's first steps, ≈ −lr·sign(g),
  pass a gradient's rounding on to its tiny entries);
- the non-finite guard, optax's cosine schedule, clip and Adam;
- the entry point end to end on the CPU: metrics.jsonl, the checkpoints and
  --load.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import npy, t
from diff_qp_mpc_tpu import runtime as jax_runtime
from diff_qp_mpc_tpu.learning import data as jax_data
from diff_qp_mpc_tpu.learning import losses as jax_losses
from diff_qp_mpc_tpu.learning import train as jax_train
from diff_qp_mpc_tpu.learning.policies import DEQMPCRollout as JaxRollout
from diff_qp_mpc_tpu_torch import runtime
from diff_qp_mpc_tpu_torch.learning import data, losses, train
from diff_qp_mpc_tpu_torch.learning.policies import DEQMPCRollout
from diff_qp_mpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    params_from_flax,
)

DATA = "data/expert_traj_sac-Pendulum-v0_new.pkl"
B, T = 4, 5


def _rel(got, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    return float(np.abs(npy(got) - ref).max() / scale)


# ------------------------------------------------------------- losses ----
def _iterates(rng, n, nx=2, nu=1):
    return [dict(net_states=rng.randn(B, T, nx), states=rng.randn(B, T, nx),
                 actions=rng.randn(B, T, nu)) for _ in range(n)]


@pytest.mark.parametrize("out_type", [0, 1, 2, 3])
@pytest.mark.parametrize("action_weight", [0.0, 0.3])
def test_losses_match_jax(out_type, action_weight):
    rng = np.random.RandomState(out_type)
    gt_s, gt_a = rng.randn(B, T, 2), rng.randn(B, T, 1)
    mask = np.cumprod(rng.rand(B, T) > 0.2, axis=1).astype(float)
    its = _iterates(rng, 3)
    jits = [JaxRollout(**{k: jnp.asarray(v) for k, v in it.items()})
            for it in its]
    pits = [DEQMPCRollout(**{k: t(v) for k, v in it.items()})
            for it in its]
    gt = [jnp.asarray(a) for a in (gt_s, gt_a, mask)]
    pgt = [t(a) for a in (gt_s, gt_a, mask)]
    pairs = [
        (losses.compute_loss_deqmpc(out_type, *pgt, pits, action_weight),
         jax_losses.compute_loss_deqmpc(out_type, *gt, jits, action_weight)),
        (losses.compute_loss_deq(*pgt, pits),
         jax_losses.compute_loss_deq(*gt, jits)),
        (losses.compute_loss_bc(out_type, *pgt, pits[0].states,
                                pits[0].actions),
         jax_losses.compute_loss_bc(out_type, *gt, jits[0].states,
                                    jits[0].actions)),
    ]
    for got, ref in pairs:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(npy(g), np.asarray(r), rtol=1e-12,
                                       atol=1e-12)


# --------------------------------------------------------------- data ----
@pytest.fixture(scope="module")
def dataset():
    d = data.load_expert_pickle(DATA)
    ref = jax_data.load_expert_pickle(DATA)
    for k in ref:
        np.testing.assert_array_equal(d[k], ref[k])
    return d


@pytest.mark.parametrize("seed", [0, 12345])
def test_native_sampler_matches_jax(dataset, seed):
    got = runtime.sample_window_batch_native(dataset, 64, T, seed)
    ref = jax_runtime.sample_window_batch_native(dataset, 64, T, seed)
    assert ref is not None  # the JAX package's library built
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    # windows crossing an episode end stay masked once masked
    assert (np.diff(got["mask"], axis=1) <= 0).all()


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_sample_window_batch_matches_jax(dataset, use_native):
    """Both packages' samplers on the same RandomState: the same draws, so
    the same batches, batch after batch."""
    rng, jrng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(3):
        got = data.sample_window_batch(dataset, 32, T, rng,
                                       use_native=use_native)
        ref = jax_data.sample_window_batch(dataset, 32, T, jrng,
                                           use_native=use_native)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


def test_sampler_pads_past_the_data_end():
    d = {"state": np.arange(12, dtype=np.float32).reshape(6, 2),
         "action": np.ones((6, 1), np.float32),
         "mask": np.array([1, 1, 1, 1, 1, 1], np.float32)}
    for use_native in (True, False):
        out = data.sample_window_batch(d, 200, 4, np.random.RandomState(0),
                                       use_native=use_native)
        late = out["state"][:, -1, 0] == 0.0  # windows past the end
        assert late.any()
        assert (out["mask"][late, -1] == 0).all()


def test_native_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(runtime, "CXX_FLAGS", ["-no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        runtime.build()


@pytest.mark.parametrize("mode", ["pendulum", "cartpole"])
def test_unwrap_window_angles_matches_jax(mode):
    rng = np.random.RandomState(0)
    s = rng.uniform(-np.pi, np.pi, (16, T, 4))
    np.testing.assert_array_equal(data.unwrap_window_angles(s, mode),
                                  jax_data.unwrap_window_angles(s, mode))


# ---------------------------------------------------------- optimizer ----
def test_cosine_schedule_matches_optax():
    ref = optax.cosine_decay_schedule(1e-3, 100, alpha=0.1)
    got = train.cosine_decay(1e-3, 100)
    for count in (0, 1, 37, 99, 100, 250):
        np.testing.assert_allclose(got(count), float(ref(count)),
                                   rtol=1e-14)


def test_clip_and_adam_match_optax():
    """optax.chain(clip_by_global_norm(1), adam(cosine schedule)) over four
    updates, one of them below the clip threshold."""
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s) for k, s in shapes.items()}
    sched = optax.cosine_decay_schedule(1e-2, 10, alpha=0.1)
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: t(v) for k, v in params.items()}
    adam = train.Adam(tp, train.cosine_decay(1e-2, 10))
    for scale in (3.0, 0.1, 5.0, 2.0):
        g = {k: scale * rng.randn(*s) for k, s in shapes.items()}
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        tg = {k: t(v) for k, v in g.items()}
        norm = train.global_norm(tg)
        np.testing.assert_allclose(
            float(norm), float(optax.global_norm(g)), rtol=1e-14)
        adam.step(train.clip_by_global_norm(tg, 1.0, norm))
    for k in shapes:
        np.testing.assert_allclose(npy(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-12, atol=1e-14)
    assert adam.count == 4


# --------------------------------------------------------- train step ----
def _argv(fused_path):
    solver = ["--solver_type", "ip"] if fused_path == "ip" else []
    return (["--env", "pendulum", "--deq", "--deq_iter", "2", "--bsz",
             str(B), "--T", str(T), "--hdim", "16", "--qp_solve", "--fused",
             "--deq_out_type", "2", "--policy_out_type", "2",
             "--grad_clip", "1", "--expert_type", "sac"] + solver)


def _batch(dataset, seed=0):
    return data.sample_window_batch(dataset, B, T,
                                    np.random.RandomState(seed),
                                    use_native=False)


def _jax_setup(argv):
    """The JAX trainer's policy (fused kernels in interpret mode), params of
    one flax initialization, optimizer and jitted step, as its main builds
    them."""
    from _torch_port_common import jax_policy

    args = jax_train.build_parser().parse_args(argv)
    pol, _ = jax_policy(argv)
    params = pol.init(jax.random.PRNGKey(0), jnp.zeros((B, 2)),
                      qp_solve=False)
    opt = optax.chain(optax.clip_by_global_norm(args.grad_clip),
                      optax.adam(args.lr))
    return args, pol, params, opt, jax_train.make_train_step(pol, opt, args)


def _jax_grads(pol, params, args, batch):
    """jax.grad of the JAX trainer's DEQ-MPC loss (its loss_fn)."""
    def loss_fn(p):
        its, _ = pol.apply(p, batch["state"][:, 0], qp_solve=True)
        return jax_losses.compute_loss_deqmpc(
            args.policy_out_type, batch["state"], batch["action"],
            batch["mask"], its)[0]
    return jax.grad(loss_fn)(params)


@pytest.mark.parametrize("fused_path", ["al", "ip"])
def test_train_step_matches_jax(dataset, fused_path):
    argv = _argv(fused_path)
    jargs, jpol, jparams, jopt, jstep = _jax_setup(argv)
    args = train.build_parser().parse_args(argv + ["--device", "cpu"])
    from diff_qp_mpc_tpu_torch.envs import make_env

    pol = train.make_policy(args, make_env("pendulum")).double()
    pol.load_state_dict(params_from_flax(jparams["params"]))
    adam = train.Adam(dict(pol.named_parameters()), args.lr)
    step = train.make_train_step(pol, adam, args, torch.Generator())

    batches = [_batch(dataset, s) for s in (0, 1)]
    jb = {k: jnp.asarray(v, jnp.float64) for k, v in batches[0].items()}
    tb = {k: t(v) for k, v in batches[0].items()}
    # the gradient itself, before any update
    jg = params_from_flax(_jax_grads(jpol, jparams, jargs, jb)["params"])
    loss, _, _ = train.compute_loss(pol, args, tb, True, torch.Generator())
    tg = torch.autograd.grad(loss, list(pol.parameters()))
    for (name, _), g in zip(pol.named_parameters(), tg):
        assert _rel(g, jg[name]) <= 1e-6, (name, _rel(g, jg[name]))

    jopt_state = jopt.init(jparams)
    key = jax.random.PRNGKey(0)
    for b in batches:
        jb = {k: jnp.asarray(v, jnp.float64) for k, v in b.items()}
        jparams, jopt_state, jl, jle, jdr, jn = jstep(
            jparams, jopt_state, jb, key, qp_solve=True)
        tl, tle, tdr, tn = step({k: t(v) for k, v in b.items()}, True)
        for got, ref in ((tl, jl), (tle, jle), (tdr, jdr), (tn, jn)):
            assert _rel(got, ref) <= 1e-6, (_rel(got, ref), float(got),
                                            float(ref))
        assert float(tn) > jargs.grad_clip  # the clip acts
    state = pol.state_dict()
    for name, ref in params_from_flax(jparams["params"]).items():
        assert _rel(state[name], ref) <= 1e-6, name
    adam_state = jopt_state[1][0]
    assert adam.count == int(adam_state.count) == 2
    for moment, jm in (("mu", adam_state.mu), ("nu", adam_state.nu)):
        ref = params_from_flax(jm["params"])
        for name, v in getattr(adam, moment).items():
            assert _rel(v, ref[name]) <= 1e-6, (moment, name)


def test_nonfinite_gradient_skips_the_update(dataset):
    """A non-finite gradient norm leaves the parameters and Adam's moments
    and count as they were."""
    args = train.build_parser().parse_args(_argv("al") + ["--device", "cpu"])
    from diff_qp_mpc_tpu_torch.envs import make_env

    torch.manual_seed(0)
    pol = train.make_policy(args, make_env("pendulum")).double()
    adam = train.Adam(dict(pol.named_parameters()), args.lr)
    step = train.make_train_step(pol, adam, args, torch.Generator())
    batch = {k: t(v) for k, v in _batch(dataset).items()}
    step(batch, False)
    before = ({k: v.clone() for k, v in pol.state_dict().items()},
              {k: v.clone() for k, v in adam.mu.items()},
              {k: v.clone() for k, v in adam.nu.items()}, adam.count)
    batch["state"][1, 0, 0] = float("nan")  # the policy input
    _, _, _, gnorm = step(batch, False)
    assert not torch.isfinite(gnorm)
    after = (pol.state_dict(), adam.mu, adam.nu, adam.count)
    for b, a in zip(before[:3], after[:3]):
        for k in b:
            assert torch.equal(b[k], a[k]), k
    assert after[3] == before[3] == 1


# -------------------------------------------------------- entry point ----
def test_main_trains_saves_and_resumes(tmp_path):
    """Three steps (one pretraining, two DEQ-MPC) on the CPU: the log lines
    of metrics.jsonl, ckpt.msgpack with the JAX trainer's meta.json, and
    --load restoring the parameters and the optimizer exactly."""
    argv = ["--env", "pendulum", "--deq", "--deq_iter", "2", "--bsz", "4",
            "--hdim", "16", "--qp_solve", "--fused", "--pretrain",
            "--pretrain_iters", "1", "--deq_out_type", "2",
            "--policy_out_type", "2", "--expert_type", "sac", "--iters",
            "3", "--ckpt_every", "1", "--save", "--logdir", str(tmp_path),
            "--name", "run", "--device", "cpu"]
    records = []
    pol = train.main(argv, on_step=records.append)
    assert [r["mode"] for r in records] == ["deq", "deqmpc", "deqmpc"]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in records)
    run = tmp_path / "run"
    lines = [json.loads(s) for s in open(run / "metrics.jsonl")]
    assert [ln["step"] for ln in lines] == [0] * 4 + [1] * 4 + [2] * 4
    assert {k for ln in lines for k in ln} - {"t", "step"} == {
        "losses/loss_avg", "losses/loss_end", "stats/dyn_res",
        "stats/step_time_ms"}
    meta = json.load(open(run / "ckpt.msgpack.meta.json"))
    assert meta["fused"] is True and meta["iters"] == 3
    assert os.path.exists(run / "ckpt_best.msgpack")  # iter 2 ≥ 1 + 1
    state, opt_state = load_checkpoint(str(run / "ckpt.msgpack"))
    for k, v in pol.state_dict().items():
        assert torch.equal(state[k], v.float()), k
    assert opt_state["count"] == 3
    resumed = train._setup(train.build_parser().parse_args(
        argv + ["--load", "--iters", "0"]))
    pol2, adam2 = resumed.policy, resumed.optimizer
    for k, v in pol.state_dict().items():
        assert torch.equal(pol2.state_dict()[k], v), k
    assert adam2.count == 3
