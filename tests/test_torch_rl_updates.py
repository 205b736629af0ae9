"""One SAC iteration, one CGAC iteration and one PPO iteration of the port
(learning.rl) against the JAX package's jitted ones (learning.rl's
make_sac, make_cgac, make_ppo), on the pendulum at a small configuration
with the networks at their default widths, on the CPU.

Both start from the JAX state: its flax parameters, Adam moments, replay
buffer or window, observation statistics and envs carried across. The JAX
package's draws are rebuilt from its key chain in the test (SAC/CGAC:
``key, k_step, k_upd = split(st.key, 3)``; ``k_act, k_reset =
split(k_step)``; per update ``k_idx, k_act, k_next = split(k, 3)``; PPO:
per collect step ``key, k_act, k_reset = split(key, 3)``, per epoch
``permutation(k_e, B)``) and passed to the port's functions of their draws.
SAC's and CGAC's warmup steps (uniform actions) are held the same way.

float32 is the JAX package's own arithmetic (``init_state`` fixes it; the
JAX side runs with x64 off, as on a TPU); float64 casts the JAX state to
float64 under x64 and the port's to float64. Tolerances, each relative to
the largest entry of the quantity (max(1, ·) for the states and buffers):
- float64: 1e-9 on everything (read: ≤ 4e-11);
- float32, the states, buffers, statistics and losses: 1e-5 (read:
  ≤ 3e-6);
- float32, what Adam steps moved: 1e-4 on the Adam moments (read: ≤ 6.1e-5,
  CGAC's actor: the moments divide each gradient's rounding by √ν of
  entries that started at 0), and on the parameters, log α and the target
  networks 1e-4 for all but a share of at most 1e-3 of each tensor's
  entries, which may differ by up to 2·lr per Adam step. Adam's first steps
  are ≈ −lr·sign(g): an entry whose gradient sits at float32 rounding level
  takes either sign in two correct implementations (read: 1 of CGAC's
  131,072 second-layer actor weights, 5.5e-5 apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.learning import rl as jax_rl
from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning import rl
from diff_qp_mpc_tpu_torch.learning.optim import Adam
from diff_qp_mpc_tpu_torch.utils import checkpoint

DTYPES = [(torch.float32, False), (torch.float64, True)]
IDS = ["float32", "float64"]
SHARE = 1e-3

# a buffer smaller than the warmup's transitions (the ring wraps); a window
# not yet full after the iteration (the time index offset is live)
SAC_CFG = jax_rl.SACConfig(n_envs=4, buffer_size=12, batch_size=16,
                           updates_per_iter=2, warmup_steps=16, block=1,
                           normalize_obs=True)
CGAC_CFG = jax_rl.CGACConfig(n_envs=8, window=3, batch_size=16,
                             updates_per_iter=2, warmup_steps=1, block=1)
PPO_CFG = jax_rl.PPOConfig(n_envs=4, rollout_len=8, epochs=2, minibatches=2)


def _x64(on):
    return jax.enable_x64(True) if on else jax.enable_x64(False)


def _f64_tree(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float64)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        tree)


def _t(a, dtype):
    a = np.asarray(a)
    return torch.tensor(a, dtype=dtype if a.dtype.kind == "f" else None)


def _rel(got, want, floor=0.0):
    want = np.asarray(want, np.float64)
    got = npy(got).astype(np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), floor, 1e-30))


def _check(got, want, dtype, what, floor=0.0, steps=0, lr=0.0,
           moment=False):
    """``got`` within the dtype's tolerance of ``want``, after ``steps``
    Adam steps (``moment``: an Adam moment; see the module docstring)."""
    if dtype == torch.float64:
        assert _rel(got, want, floor) <= 1e-9, what
        return
    want = np.asarray(want, np.float64)
    err = np.abs(npy(got).astype(np.float64) - want)
    scale = max(float(np.abs(want).max()), floor, 1e-30)
    tol = 1e-4 * scale if steps else 1e-5 * scale
    if not steps or moment:
        assert float(err.max()) <= tol, (what, float(err.max()) / scale)
        return
    out = err > tol
    assert out.mean() <= SHARE, (what, out.mean())
    assert float(err.max()) <= tol + 2 * lr * steps, what


# --------------------------------------------------- the state, carried --
def _adam(jstate, params, net, dtype, lr):
    """The port's Adam of an optax.adam state on ``net``'s parameters (or on
    {"log_alpha": ...} when ``net`` is None)."""
    s = jstate[0]
    opt = Adam(params, lr)
    opt.count = int(s.count)
    for name in ("mu", "nu"):
        tree = getattr(s, name)
        moments = ({"log_alpha": tree} if net is None else
                   rl.params_from_flax(net, tree["params"]))
        setattr(opt, name, {k: _t(v, dtype) for k, v in moments.items()})
    return opt


def _port_state(algo, jst, env, dtype, lr):
    actor_cls = rl.GaussianActor if algo == "sac" else rl.CGACActor
    actor = rl.load_flax(actor_cls(env.nx, env.nu), jst.actor["params"])
    q = rl.load_flax(rl.TwinQ(env.nx, env.nu), jst.q["params"])
    q_targ = rl.load_flax(rl.TwinQ(env.nx, env.nu), jst.q_targ["params"])
    actor, q, q_targ = (m.to(dtype) for m in (actor, q, q_targ))
    log_alpha = _t(jst.log_alpha, dtype).requires_grad_(True)
    common = dict(
        actor=actor, q=q, q_targ=q_targ, log_alpha=log_alpha,
        opt_a=_adam(jst.opt_a, dict(actor.named_parameters()), actor, dtype,
                    lr),
        opt_q=_adam(jst.opt_q, dict(q.named_parameters()), q, dtype, lr),
        opt_alpha=_adam(jst.opt_alpha, {"log_alpha": log_alpha}, None, dtype,
                        lr),
        obs_mean=_t(jst.obs_mean, dtype), obs_var=_t(jst.obs_var, dtype),
        obs_count=_t(jst.obs_count, dtype),
        env_state=EnvState(*(_t(getattr(jst.env_state, f), dtype) for f in (
            "x", "num_successes", "steps"))))
    bufs = {k: _t(getattr(jst, k), dtype)
            for k in ("buf_obs", "buf_act", "buf_rew", "buf_next")}
    if algo == "sac":
        return rl.SACState(**common, **bufs,
                           buf_mask=_t(jst.buf_mask, dtype),
                           ptr=int(jst.ptr), size=int(jst.size))
    return rl.CGACState(**common, **bufs, filled=int(jst.filled))


def _compare_state(algo, st, jst, dtype, lr, steps):
    """Every field of the port's state against the JAX state."""
    for f in ("x", "num_successes", "steps"):
        _check(getattr(st.env_state, f), getattr(jst.env_state, f), dtype,
               f"env_state.{f}", floor=1.0)
    for f in ("buf_obs", "buf_act", "buf_rew", "buf_next") + (
            ("buf_mask",) if algo == "sac" else ()):
        _check(getattr(st, f), getattr(jst, f), dtype, f, floor=1.0)
    if algo == "sac":
        assert (st.ptr, st.size) == (int(jst.ptr), int(jst.size))
    else:
        assert st.filled == int(jst.filled)
    for f in ("obs_mean", "obs_var", "obs_count"):
        _check(getattr(st, f), getattr(jst, f), dtype, f, floor=1.0)
    kw = dict(steps=steps, lr=lr)
    for name in ("actor", "q", "q_targ"):
        net = getattr(st, name)
        _compare_tree(rl.params_to_flax(net),
                      getattr(jst, name)["params"], dtype, name, **kw)
    for name, net in (("opt_a", st.actor), ("opt_q", st.q)):
        opt, js = getattr(st, name), getattr(jst, name)[0]
        assert opt.count == int(js.count), name
        for m in ("mu", "nu"):
            tree = checkpoint.params_to_flax(getattr(opt, m),
                                             rl._flax_modules(net))
            _compare_tree(tree, getattr(js, m)["params"], dtype,
                          f"{name}.{m}", moment=True, **kw)
    _check(st.log_alpha.detach(), jst.log_alpha, dtype, "log_alpha", **kw)
    js = jst.opt_alpha[0]
    for m in ("mu", "nu"):
        _check(getattr(st.opt_alpha, m)["log_alpha"], getattr(js, m), dtype,
               f"opt_alpha.{m}", moment=True, **kw)


def _compare_tree(tree, jtree, dtype, what, **kw):
    for layer, leaves in jtree.items():
        if not isinstance(leaves, dict):
            _check(tree[layer], leaves, dtype, f"{what}.{layer}", **kw)
            continue
        for k, v in leaves.items():
            _check(tree[layer][k], v, dtype, f"{what}.{layer}.{k}", **kw)


# --------------------------------------------------- SAC and CGAC ------
def _env_draws(jenv, key, n, nu, dtype_j, random_policy, lo=None, hi=None):
    """JAX env_step's draws from its key: (the action or its noise, the
    fresh initial states)."""
    k_act, k_reset = jax.random.split(key)
    if random_policy:
        draw = jax.random.uniform(k_act, (n, nu), minval=lo, maxval=hi)
    else:
        draw = jax.random.normal(k_act, (n, nu))
    return draw, jenv.reset(k_reset, n).x


@pytest.mark.parametrize("dtype,x64", DTYPES, ids=IDS)
@pytest.mark.parametrize("algo", ["sac", "cgac"])
def test_warmup_and_one_iteration_match_jax(algo, dtype, x64):
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    cfg = SAC_CFG if algo == "sac" else CGAC_CFG
    make = jax_rl.make_sac if algo == "sac" else jax_rl.make_cgac
    port_cls = rl.SAC if algo == "sac" else rl.CGAC
    port_cfg = (rl.SACConfig if algo == "sac" else rl.CGACConfig)(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    algo_port = port_cls(env, port_cfg, dtype=dtype, device="cpu")
    n, nu, B = cfg.n_envs, env.nu, cfg.batch_size
    with _x64(x64):
        (_, _, _, init_state, warmup_block, train_block) = make(jenv, cfg)
        jst0 = init_state(0)
        if x64:
            jst0 = _f64_tree(jst0)
        jst1, _ = warmup_block(jst0)
        jst2, (mean_r, q_loss, a_loss) = train_block(jst1)
        lo = jnp.asarray(env.action_space.low, jnp.float32)
        hi = jnp.asarray(env.action_space.high, jnp.float32)
        # the warmup's draws
        warm, key = [], jst0.key
        for _ in range(algo_port.warmup_steps()):
            key, k_step = jax.random.split(key)
            warm.append(_env_draws(jenv, k_step, n, nu, None, True, lo, hi))
        # the iteration's
        key, k_step, k_upd = jax.random.split(jst1.key, 3)
        step_draws = _env_draws(jenv, k_step, n, nu, None, False)
        high = (min(int(jst1.size) + n, cfg.buffer_size) if algo == "sac"
                else min(int(jst1.filled) + 1, cfg.window) * n)
        upd_draws = []
        for k in jax.random.split(k_upd, cfg.updates_per_iter):
            k_idx, k_act, k_next = jax.random.split(k, 3)
            upd_draws.append((jax.random.randint(k_idx, (B,), 0, high),
                              jax.random.normal(k_act, (B, nu)),
                              jax.random.normal(k_next, (B, nu))))

    # the warmup: uniform actions with JAX's draws, from JAX's first state
    st = _port_state(algo, jst0, env, dtype, cfg.lr)
    for u, fresh in warm:
        algo_port.env_step(st, _t(u, dtype), _t(fresh, dtype),
                           random_policy=True)
    _compare_state(algo, st, jst1, dtype, cfg.lr, steps=0)

    # one iteration from JAX's warmed-up state
    st = _port_state(algo, jst1, env, dtype, cfg.lr)
    r = algo_port.env_step(st, _t(step_draws[0], dtype),
                           _t(step_draws[1], dtype))
    losses = [algo_port.grad_update(st, torch.tensor(np.asarray(idx)),
                                    _t(ea, dtype), _t(en, dtype))
              for idx, ea, en in upd_draws]
    _check(r, mean_r[0], dtype, "mean reward")
    for i, (name, ref) in enumerate((("q_loss", q_loss), ("a_loss", a_loss))):
        _check(torch.stack([l[i] for l in losses]).mean(), ref[0], dtype,
               name)
    _compare_state(algo, st, jst2, dtype, cfg.lr,
                   steps=cfg.updates_per_iter)


# ---------------------------------------------------------------- PPO ----
@pytest.mark.parametrize("dtype,x64", DTYPES, ids=IDS)
def test_ppo_collect_gae_and_update_match_jax(dtype, x64):
    env, jenv = make_env("pendulum"), jax_make_env("pendulum")
    cfg = PPO_CFG
    L, n, nu = cfg.rollout_len, cfg.n_envs, env.nu
    port_cfg = rl.PPOConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})
    ppo = rl.PPO(env, port_cfg, dtype=dtype, device="cpu")
    with _x64(x64):
        net, _, collect, gae, update = jax_rl.make_ppo(jenv, cfg)
        key = jax.random.PRNGKey(0)
        key, k_init, k_reset, k_col, k_up = jax.random.split(key, 5)
        params = net.init(k_init, jnp.zeros((1, env.nx)))
        if x64:
            params = _f64_tree(params)
        optimizer = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                                optax.adam(cfg.lr))
        opt_state = optimizer.init(params)
        env0 = jenv.reset(k_reset, n)
        env1, _, traj, last_v = jax.jit(collect)(params, env0, k_col)
        advs, returns = jax.jit(gae)(traj, last_v)
        params2, opt_state2, loss = jax.jit(
            update, static_argnums=2)(params, opt_state, optimizer, traj,
                                      advs, returns, k_up)
        eps, fresh, key = [], [], k_col
        for _ in range(L):
            key, k_act, k_rs = jax.random.split(key, 3)
            eps.append(jax.random.normal(k_act, (n, nu)))
            fresh.append(jenv.reset(k_rs, n).x)
        perms = [jax.random.permutation(k, L * n)
                 for k in jax.random.split(k_up, cfg.epochs)]

    pnet = rl.load_flax(rl.ActorCritic(env.nx, env.nu),
                        params["params"]).to(dtype)
    state = EnvState(*(_t(getattr(env0, f), dtype)
                       for f in ("x", "num_successes", "steps")))
    env2, ptraj, plast_v = ppo.collect(
        pnet, state, _t(np.stack(eps), dtype), _t(np.stack(fresh), dtype))
    for f in ("x", "num_successes", "steps"):
        _check(getattr(env2, f), getattr(env1, f), dtype, f, floor=1.0)
    for f in rl.Transition._fields:
        _check(getattr(ptraj, f), getattr(traj, f), dtype, f, floor=1.0)
    assert ptraj.done.dtype == torch.float32
    _check(plast_v, last_v, dtype, "last_v", floor=1.0)
    assert float(npy(ptraj.done).sum()) == 0.0  # no env ends in 8 steps

    # GAE and the update on JAX's rollout (one input, one output each)
    # the done flags are float32 in both packages, whatever the dtype
    jtraj = rl.Transition(*(_t(getattr(traj, f), torch.float32 if f == "done"
                               else dtype) for f in rl.Transition._fields))
    padvs, preturns = ppo.gae(jtraj, _t(last_v, dtype))
    _check(padvs, advs, dtype, "advs", floor=1.0)
    _check(preturns, returns, dtype, "returns", floor=1.0)
    opt = Adam(dict(pnet.named_parameters()), cfg.lr)
    ploss = ppo.update(pnet, opt, jtraj, _t(advs, dtype), _t(returns, dtype),
                       torch.tensor(np.stack([np.asarray(p) for p in perms])))
    _check(ploss, loss, dtype, "loss")
    steps = cfg.epochs * cfg.minibatches
    _compare_tree(rl.params_to_flax(pnet), params2["params"], dtype,
                  "params", steps=steps, lr=cfg.lr)
    adam = opt_state2[1][0]
    assert opt.count == int(adam.count) == steps
    for m in ("mu", "nu"):
        moments = dict(getattr(opt, m))
        tree = checkpoint.params_to_flax(moments, rl._flax_modules(pnet))
        tree["log_std"] = npy(moments["log_std"])
        _compare_tree(tree, getattr(adam, m)["params"], dtype, m,
                      steps=steps, lr=cfg.lr, moment=True)
