"""The port's integrator, cartpole and quadrotor envs (and the pendulum's)
vs the JAX package's: their constants, reset from given initial states, a run of
steps with the same actions (state, reward, done, the success streak),
_success, goal_error and _diverged, and the port's own initial-state draws
within the JAX draws' box. Float64; held to 1e-12 (cp2's RK4 sums in
another order)."""
import jax
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu import envs as jenvs
from diff_qp_mpc_tpu_torch import envs as tenvs

ENVS = [("pendulum", {}), ("integrator", {}), ("cartpole1link", {}),
        ("cartpole1link", {"stabilization": True}),
        ("cartpole2link", {"stabilization": True}),
        ("cartpole2link", {}), ("rexquadrotor", {})]
IDS = ["pendulum", "integrator", "cp1", "cp1-stabilize", "cp2-stabilize",
       "cp2", "quadrotor"]
# the quadrotor's attitude, velocity and rates are drawn from normals (its
# position uniform): their draws have no box, so they are held by their
# mean and standard deviation
NORMAL_COORDS = {"rexquadrotor": slice(3, 12)}


def _pair(name, kwargs):
    return jenvs.make_env(name, **kwargs), tenvs.make_env(name, **kwargs)


def _states(env, seed, B=32, scale=1.0):
    """States around the env's goal (or origin) with some far out, and one
    non-finite and one huge-velocity row for _diverged."""
    rng = np.random.RandomState(seed)
    goal = np.asarray(getattr(env, "goal", np.zeros(env.nx)))
    x = goal + scale * rng.uniform(-1.0, 1.0, (B, env.nx))
    x[:4] = goal + rng.uniform(-0.01, 0.01, (4, env.nx))  # at the goal
    x[-1, 0] = np.nan
    x[-2, -1] = 50.0
    x[-3, 0] = 20.0
    return x


@pytest.mark.parametrize("name,kwargs", ENVS, ids=IDS)
def test_env_constants_match_jax(name, kwargs):
    je, te = _pair(name, kwargs)
    assert te.spec_id == je.spec_id
    assert (te.nx, te.nu, te.nq, te.dt) == (je.nx, je.nu, je.nq, je.dt)
    assert (te.max_steps, te.success_streak) == (je.max_steps,
                                                 je.success_streak)
    for a in ("Qlqr", "Rlqr"):
        np.testing.assert_array_equal(np.asarray(getattr(te, a)),
                                      np.asarray(getattr(je, a)))
    for space in ("action_space", "observation_space"):
        for bound in ("low", "high"):
            np.testing.assert_array_equal(
                getattr(getattr(te, space), bound),
                getattr(getattr(je, space), bound))
    if hasattr(je, "goal"):
        np.testing.assert_array_equal(te.goal, np.asarray(je.goal))
    assert type(te.model).__name__ == type(je.model).__name__


@pytest.mark.parametrize("name,kwargs", ENVS, ids=IDS)
def test_env_predicates_match_jax(name, kwargs):
    je, te = _pair(name, kwargs)
    x = _states(je, seed=0)
    np.testing.assert_array_equal(npy(te._success(t(x))),
                                  np.asarray(je._success(j(x))))
    np.testing.assert_array_equal(npy(te._diverged(t(x))),
                                  np.asarray(je._diverged(j(x))))
    np.testing.assert_allclose(npy(te.goal_error(t(x))),
                               np.asarray(je.goal_error(j(x))), atol=1e-12)
    u = np.random.RandomState(1).uniform(-1.0, 1.0, (x.shape[0], je.nu))
    np.testing.assert_allclose(npy(te._reward(t(x), t(u))),
                               np.asarray(je._reward(j(x), j(u))),
                               atol=1e-12)


@pytest.mark.parametrize("name,kwargs", ENVS, ids=IDS)
def test_env_steps_match_jax(name, kwargs):
    """From the same initial states, 16 steps with the same actions (some
    beyond the box; the quadrotor's near its hover thrust): state, reward,
    done and the success counter."""
    je, te = _pair(name, kwargs)
    x0 = _states(je, seed=2, scale=0.3)[:-3]
    js, ts = jenvs.EnvState.make(j(x0)), tenvs.EnvState.make(t(x0))
    rng = np.random.RandomState(3)
    high = je.action_space.high
    jstep = jax.jit(je.step)
    for k in range(16):
        u = rng.uniform(-1.5, 1.5, (x0.shape[0], je.nu)) * high * (k % 2)
        if hasattr(je.model, "hover_thrust"):
            # a hover task: near the hover thrust, inside the box (far from
            # it the quadrotor tumbles and its MRP blows up within the 16
            # steps, where rounding alone sets where a NaN appears)
            u = np.asarray(je.model.hover_thrust()) + 0.05 * high * \
                rng.uniform(-1.0, 1.0, (x0.shape[0], je.nu))
        js, jr, jd = jstep(js, j(u))
        ts, tr, td = te.step(ts, t(u))
        np.testing.assert_allclose(npy(ts.x), np.asarray(js.x), atol=1e-12,
                                   err_msg=f"step {k}")
        np.testing.assert_allclose(npy(tr), np.asarray(jr), atol=1e-12)
        np.testing.assert_array_equal(npy(td), np.asarray(jd))
        np.testing.assert_array_equal(npy(ts.num_successes),
                                      np.asarray(js.num_successes))
        np.testing.assert_array_equal(npy(ts.steps), np.asarray(js.steps))


@pytest.mark.parametrize("name,kwargs", ENVS, ids=IDS)
def test_env_reset_draws_within_jax_box(name, kwargs):
    """The port draws from a torch.Generator, the JAX package from a PRNG
    key: the draws differ, but both fill the same box."""
    je, te = _pair(name, kwargs)
    B = 4096
    jx = np.asarray(je.reset(jax.random.PRNGKey(0), B).x)
    tx = npy(te.reset(torch.Generator().manual_seed(0), B,
                      dtype=torch.float64).x)
    normal = NORMAL_COORDS.get(name)
    if normal is not None:
        # the standard error of a mean of 4096 draws is 1.6% of their
        # standard deviation, of a standard deviation 1.1%
        jn, tn = jx[:, normal], tx[:, normal]
        np.testing.assert_allclose(tn.std(0), jn.std(0), rtol=0.05)
        np.testing.assert_allclose(tn.mean(0), jn.mean(0),
                                   atol=0.1 * jn.std(0).min())
        keep = np.ones(jx.shape[1], bool)
        keep[normal] = False
        jx, tx = jx[:, keep], tx[:, keep]
    lo, hi = jx.min(0), jx.max(0)
    span = hi - lo
    assert (tx.min(0) >= lo - 0.01 * span).all()
    assert (tx.max(0) <= hi + 0.01 * span).all()
    np.testing.assert_allclose(tx.mean(0), jx.mean(0),
                               atol=0.05 * span.max())
    again = npy(te.reset(torch.Generator().manual_seed(0), B,
                         dtype=torch.float64).x)
    if normal is not None:
        again = again[:, keep]
    np.testing.assert_array_equal(tx, again)


def test_make_env_names():
    for name in ("pendulum", "integrator", "cartpole1link",
                 "cartpole2link", "rexquadrotor"):
        assert type(tenvs.make_env(name)).__name__ == type(
            jenvs.make_env(name)).__name__
    with pytest.raises(ValueError):
        tenvs.make_env("no_such_env")
