"""The port's RL networks, weight mapping, checkpoints, rollouts and
``Env.reset_where`` (learning.rl, envs.base) against the JAX package's
(diff_qp_mpc_tpu.learning.rl), on the CPU.

- Each network's forward with one flax initialization carried across by
  ``params_from_flax``: float64 (JAX promotes the float32 parameters to the
  float64 inputs; the port casts them) within 1e-12 relative to each
  output's largest entry, float32 within 1e-5 (sums in another order). The
  port's own initialization has flax's tree, shapes and distributions.
- The committed pendulum CGAC actor rolled out by ``sac_expert_rollouts``
  from JAX's ``env.reset(PRNGKey(0), 16)`` in float64 on both sides: the
  same trajectory lengths (truncation at the first done), states and
  actions within 1e-6 of their largest entry (up to 200 closed-loop steps
  through the upright equilibrium, where the rounding of one step grows;
  the pickles store float32, whose one ulp at the largest velocity, ~8, is
  ~1e-7 of it).
- A SAC and a CGAC checkpoint written by the port and read back by JAX's
  ``load_checkpoint`` give the same actions to 1e-6 (float32), and the
  port's ``load_cgac_actor`` reads both the committed actors and its own.
- ``reset_where`` with JAX's fresh draw: exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.learning import rl as jax_rl
from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint
from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning import rl
from diff_qp_mpc_tpu_torch.utils.checkpoint import load_msgpack

CGAC_PENDULUM = "data/expert_traj_cgac-Pendulum-v0_new.pkl.cgac_ckpt.msgpack"
CGAC_CP1 = "data/expert_traj_cgac-Cartpole1l-v0_new.pkl.cgac_ckpt.msgpack"


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(npy(got).astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


# (JAX module, port constructor, inputs: x and, for the critic, u)
NETS = {
    "actor_critic": (lambda: jax_rl.ActorCritic(nu=1),
                     lambda: rl.ActorCritic(2, 1), 1),
    "gaussian_actor": (lambda: jax_rl.GaussianActor(nu=1),
                       lambda: rl.GaussianActor(2, 1), 1),
    "twin_q": (lambda: jax_rl.TwinQ(), lambda: rl.TwinQ(2, 1), 2),
    "cgac_actor": (lambda: jax_rl.CGACActor(nu=1),
                   lambda: rl.CGACActor(2, 1), 1),
}


def _inputs(n_in, dtype):
    rng = np.random.RandomState(3)
    xs = [3.0 * rng.randn(64, 2)] + ([3.0 * rng.uniform(-1, 1, (64, 1))]
                                     if n_in == 2 else [])
    return [x.astype(dtype) for x in xs]


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", sorted(NETS))
def test_network_forward_matches_jax(name, dtype, tol):
    jnet, make, n_in = NETS[name]
    xs = _inputs(n_in, dtype)
    params = jnet().init(jax.random.PRNGKey(7), *(jnp.asarray(x[:1])
                                                  for x in xs))
    ref = jnet().apply(params, *(jnp.asarray(x) for x in xs))
    net = rl.load_flax(make(), params["params"]).to(
        torch.float64 if dtype == np.float64 else torch.float32)
    got = net(*(torch.tensor(x) for x in xs))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == (torch.float64 if dtype == np.float64
                           else torch.float32)
        assert g.shape == r.shape
        assert _rel(g.detach(), r) <= tol, name
    # and back: params_to_flax gives the flax tree itself
    back = rl.params_to_flax(rl.load_flax(make(), params["params"]))
    for path, leaf in jax.tree_util.tree_leaves_with_path(params["params"]):
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, np.asarray(leaf))


@pytest.mark.parametrize("name", sorted(NETS))
def test_port_initialization_is_flaxs(name):
    """The port's fresh network has flax's tree (names, shapes), zero
    biases, and kernels of flax's lecun-normal spread."""
    jnet, make, n_in = NETS[name]
    xs = _inputs(n_in, np.float32)
    params = jnet().init(jax.random.PRNGKey(0), *(jnp.asarray(x[:1])
                                                  for x in xs))["params"]
    torch.manual_seed(0)
    tree = rl.params_to_flax(make())
    assert sorted(tree) == sorted(params)
    for layer, leaves in params.items():
        if layer == "log_std":  # ActorCritic's constant −0.5
            np.testing.assert_array_equal(tree[layer], np.asarray(leaves))
            continue
        assert tree[layer]["kernel"].shape == leaves["kernel"].shape
        np.testing.assert_array_equal(tree[layer]["bias"], 0.0)
        fan_in = leaves["kernel"].shape[0]
        std = float(np.std(tree[layer]["kernel"]))
        if tree[layer]["kernel"].size >= 256:
            assert abs(std * np.sqrt(fan_in) - 1.0) < 0.15, (layer, std)
        assert np.abs(tree[layer]["kernel"]).max() <= 2.0 / np.sqrt(
            fan_in) / 0.8796 + 1e-6


def _jax_cgac_act(env, path):
    """JAX's deterministic CGAC action of a checkpoint (train_cgac's
    act_fn: mean_action of the normalized observation), every constant in
    float64 (in float32 the normalizer's √(var + 1e-5) alone moves the
    actions by ~2e-5 over a rollout)."""
    tree = load_msgpack(path)["params"]
    net = jax_rl.CGACActor(nu=env.nu)
    f64 = lambda a: jnp.asarray(a, jnp.float64)
    params = {"params": jax.tree.map(f64, tree["actor"]["params"])}
    m, v = f64(tree["obs_mean"]), f64(tree["obs_var"])
    lo, hi = f64(env.action_space.low), f64(env.action_space.high)

    def act(obs):
        o = jnp.clip((obs - m) / jnp.sqrt(v + 1e-5), -5.0, 5.0)
        mean, _ = net.apply(params, o)
        return jnp.tanh(mean) * (hi - lo) / 2.0 + (hi + lo) / 2.0

    return act


def test_committed_cgac_actor_rollouts_match_jax():
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    n = 16
    init = np.asarray(jenv.reset(jax.random.PRNGKey(0), n).x)
    ref = jax_rl.sac_expert_rollouts(jenv, _jax_cgac_act(jenv, CGAC_PENDULUM),
                                     num_traj=n, seed=0)
    actor, m, v = rl.load_cgac_actor(CGAC_PENDULUM, device="cpu",
                                     dtype=torch.float64)
    got = rl.sac_expert_rollouts(env, rl.actor_act_fn(env, actor, m, v), n,
                                 init_states=init, dtype=torch.float64,
                                 device="cpu")
    assert [len(t) for t in got] == [len(t) for t in ref]
    assert min(len(t) for t in got) < env.max_steps  # truncated at done
    for i in (0, 1):
        g = np.stack([p[i] for t in got for p in t])
        r = np.stack([p[i] for t in ref for p in t])
        assert g.dtype == np.float32
        assert np.abs(g.astype(np.float64) - r).max() \
            <= 1e-6 * np.abs(r).max(), i
    # the committed actor swings every one of them up
    finals = np.array([t[-1][0] for t in got])
    assert (np.abs(finals[:, 0]) < 0.1).all()


def test_committed_cgac_actors_load():
    for path, nx in ((CGAC_PENDULUM, 2), (CGAC_CP1, 4)):
        actor, m, v = rl.load_cgac_actor(path, device="cpu")
        assert [l.in_features for l in actor.trunk] == [nx, 512]
        assert m.shape == v.shape == (nx,) and bool((v > 0).all())


@pytest.mark.parametrize("algo", ["sac", "cgac"])
def test_checkpoint_reads_back_in_jax(tmp_path, algo):
    """save_expert_checkpoint's file through JAX's load_checkpoint (a flax
    template of the trainer's tree): the same actions as the port's."""
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    torch.manual_seed(4)
    actor = rl.GaussianActor(2, 1) if algo == "sac" else rl.CGACActor(2, 1)
    jnet = jax_rl.GaussianActor(nu=1) if algo == "sac" \
        else jax_rl.CGACActor(nu=1)
    m, v = torch.tensor([0.3, -0.2]), torch.tensor([2.0, 0.5])
    path = str(tmp_path / f"x.pkl.{algo}_ckpt.msgpack")
    rl.save_expert_checkpoint(path, actor, m, v)
    template = {"params": {
        "actor": jnet.init(jax.random.PRNGKey(1), jnp.zeros((1, 2),
                                                            jnp.float32)),
        "obs_mean": jnp.zeros(2, jnp.float32),
        "obs_var": jnp.ones(2, jnp.float32)}}
    restored = load_checkpoint(path, template)["params"]
    obs = np.random.RandomState(0).uniform(-3, 3, (32, 2)).astype(np.float32)
    o = jnp.clip((obs - restored["obs_mean"])
                 / jnp.sqrt(restored["obs_var"] + 1e-5), -5, 5)
    want = jnp.tanh(jnet.apply(restored["actor"], o)[0]) * 3.0
    got = rl.actor_act_fn(env, actor, m, v)(torch.tensor(obs))
    assert np.abs(npy(got) - np.asarray(want)).max() <= 1e-6
    if algo == "cgac":
        actor2, m2, v2 = rl.load_cgac_actor(path, device="cpu")
        again = rl.actor_act_fn(env, actor2, m2, v2)(torch.tensor(obs))
        torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_reset_where_matches_jax():
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    rng = np.random.RandomState(2)
    x = rng.randn(8, 2)
    ns, steps = rng.randint(0, 5, 8), rng.randint(0, 50, 8)
    mask = np.array([1, 0, 0, 1, 1, 0, 1, 0], bool)
    key = jax.random.PRNGKey(5)
    jstate = type(jenv.reset(key, 8))(x=jnp.asarray(x),
                                       num_successes=jnp.asarray(ns, jnp.int32),
                                       steps=jnp.asarray(steps, jnp.int32))
    ref = jenv.reset_where(key, jstate, jnp.asarray(mask))
    fresh = np.asarray(jenv.reset(key, 8).x)
    state = EnvState(x=torch.tensor(x), num_successes=torch.tensor(
        ns, dtype=torch.int32), steps=torch.tensor(steps, dtype=torch.int32))
    got = env.reset_where(state, torch.tensor(mask), fresh=torch.tensor(fresh))
    for f in ("x", "num_successes", "steps"):
        np.testing.assert_array_equal(npy(getattr(got, f)),
                                      np.asarray(getattr(ref, f)))
    # drawn from a generator: fresh states where the mask is set, in dtype
    drawn = env.reset_where(state, torch.tensor(mask),
                            generator=torch.Generator().manual_seed(0))
    assert drawn.x.dtype == torch.float64
    np.testing.assert_array_equal(npy(drawn.x)[~mask], x[~mask])
    assert (np.abs(npy(drawn.x)[mask]) <= [np.pi, 1.0]).all()
    assert not np.isin(npy(drawn.x)[mask], x).any()
