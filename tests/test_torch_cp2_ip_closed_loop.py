"""The cp2 ip checkpoint's closed loop in both packages from the JAX
package's own initial states, on the CPU, step by step.

Run as a script, it rolls ``logs/deqmpc_cp2_ip_term_v1`` (Cartpole2L
stabilize, ip tracker, terminal LQR cost, T 5) from the JAX evaluator's
draw of initial states (``evaluate_policy``: ``env.reset`` with the first
key split from ``PRNGKey(seed)``, 64 episodes): the first ``--states`` of
them for up to ``--steps`` steps (the evaluators' 200 by default), by the
JAX policy (scan path, float64: its Pallas K4 in interpret mode is too slow
on the CPU) and by the port's policy on its scan and fused paths (kernels'
plain versions, float64). It prints, per step, the largest |Δ| of the
applied actions against the JAX run, and at the end each run's success
share and mean episode length (success as the evaluators count it: the
env's success streak reached before the episode ends):

    JAX_PLATFORMS=cpu PYTHONPATH=$PWD python \\
        tests/test_torch_cp2_ip_closed_loop.py \\
        [--states 16] [--steps 200] [--seed 0] [--out PATH]

At 64 states on an 8-core CPU the JAX run takes ~15 min (~5 of them
tracing) and each port path ~3 s a step, ~10 min: too long for the suite; the test below holds the script's loop on both
packages' envs with a fixed action sequence (no policy): the same states,
the same done and success bookkeeping."""
from __future__ import annotations

import argparse
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

CKPT = "logs/deqmpc_cp2_ip_term_v1/ckpt_best.msgpack"


def _argv(fused):
    return (["--env", "cartpole2link", "--stabilization", "--deq",
             "--deq_iter", "6", "--T", "5", "--hdim", "128", "--qp_solve",
             "--solver_type", "ip", "--qp_iter", "2", "--tracking_r", "0.01",
             "--terminal_lqr", "--deq_out_type", "1", "--policy_out_type",
             "1", "--solver_carry", "off"] + (["--fused"] if fused else []))


def jax_run(x0, steps):
    """The JAX policy's closed loop from ``x0`` (``_loop``'s dict)."""
    from diff_qp_mpc_tpu.envs import make_env
    from diff_qp_mpc_tpu.envs.base import EnvState
    from diff_qp_mpc_tpu.learning.train import build_parser, make_policy
    from diff_qp_mpc_tpu.utils.checkpoint import load_checkpoint

    args = build_parser().parse_args(_argv(False))
    env = make_env("cartpole2link", stabilization=True)
    policy = make_policy(args, env)
    template = policy.init(jax.random.PRNGKey(0), jnp.zeros((2, env.nx)),
                           qp_solve=False)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), load_checkpoint(
        CKPT, {"params": template})["params"])

    @jax.jit
    def act(obs):
        its, _ = policy.apply(params, obs, qp_solve=True)
        return its[-1].actions[:, 0]

    state = EnvState.make(jnp.asarray(x0, jnp.float64))
    return _loop(env, state, lambda x: np.asarray(act(x)),
                 lambda s, u: env.step(s, jnp.asarray(u)), steps,
                 lambda s: np.asarray(s.num_successes >= env.success_streak))


def jax_init_states(n, seed):
    """The JAX evaluator's initial states: env.reset with the first key
    split from PRNGKey(seed), at its default 64 episodes."""
    from diff_qp_mpc_tpu.envs import make_env

    env = make_env("cartpole2link", stabilization=True)
    k_reset, _ = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(env.reset(k_reset, 64).x, np.float64)[:n]


def port_run(x0, steps, fused):
    from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
    from diff_qp_mpc_tpu_torch.learning.train import build_parser, make_policy
    from diff_qp_mpc_tpu_torch.utils.checkpoint import load_policy_params

    args = build_parser().parse_args(_argv(fused) + ["--device", "cpu"])
    env = make_env("cartpole2link", stabilization=True)
    policy = make_policy(args, env)
    policy.load_state_dict(load_policy_params(CKPT))
    policy.to(torch.float64)

    def act(x):
        with torch.no_grad():
            its, _ = policy(x, qp_solve=True)
        return its[-1].actions[:, 0]

    state = EnvState.make(torch.as_tensor(x0, dtype=torch.float64))
    return _loop(env, state, act, env.step, steps,
                 lambda s: (s.num_successes >= env.success_streak).numpy())


def _loop(env, state, act, step, steps, succeeded):
    """Roll ``steps`` steps (or until every episode is done); the applied
    actions and resulting states, and success/done as the evaluators
    count them."""
    B = state.x.shape[0]
    us, xs = [], []
    done_at = np.full(B, steps, np.int32)
    ever_done = np.zeros(B, bool)
    ever_success = np.zeros(B, bool)
    t0 = time.perf_counter()
    for t in range(steps):
        u = act(state.x)
        state, _, done = step(state, u)
        us.append(np.asarray(u, np.float64))
        xs.append(np.asarray(state.x, np.float64))
        d = np.asarray(done)
        ever_success |= succeeded(state) & ~ever_done
        done_at[d & ~ever_done] = t + 1
        ever_done |= d
        if ever_done.all():
            break
    return dict(actions=np.stack(us), states=np.stack(xs),
                success=ever_success, done_at=done_at,
                seconds=time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--states", type=int, default=16)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    torch.set_num_threads(4)
    x0 = jax_init_states(a.states, a.seed)
    runs = {"jax-scan": jax_run(x0, a.steps),
            "port-scan": port_run(x0, a.steps, fused=False),
            "port-fused": port_run(x0, a.steps, fused=True)}
    ref = runs["jax-scan"]
    rows = {}
    for name, r in runs.items():
        n = min(len(r["actions"]), len(ref["actions"]))
        du = np.abs(r["actions"][:n] - ref["actions"][:n]).max(axis=(1, 2))
        dx = np.abs(r["states"][:n] - ref["states"][:n]).max(axis=(1, 2))
        rows[name] = dict(
            steps_run=len(r["actions"]), seconds=r["seconds"],
            success_share=float(r["success"].mean()),
            successes=r["success"].astype(int).tolist(),
            mean_episode_len=float(r["done_at"].mean()),
            max_action_diff_per_step=du.tolist(),
            max_state_diff_per_step=dx.tolist(),
            first_step_action_diff_over_1e_6=(
                int(np.argmax(du > 1e-6)) if (du > 1e-6).any() else None))
        print(name, json.dumps({k: v for k, v in rows[name].items()
                                if "per_step" not in k}), flush=True)
        print(name, "max |du| by step", " ".join(f"{v:.1e}" for v in du))
    out = dict(ckpt=CKPT, states=a.states, steps=a.steps, seed=a.seed,
               x0=x0.tolist(), runs=rows)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f)
    return out


def test_loop_agrees_on_both_envs_from_jax_initial_states():
    """The script's loop on both packages' cp2 stabilize envs from the JAX
    evaluator's first 16 initial states, with the same seeded open-loop
    forces (no policy): states within 1e-9 (float64), and identical done
    steps and successes over 40 steps."""
    from diff_qp_mpc_tpu.envs import make_env as jax_make_env
    from diff_qp_mpc_tpu.envs.base import EnvState as JaxEnvState
    from diff_qp_mpc_tpu_torch.envs import EnvState, make_env

    x0 = jax_init_states(16, 0)
    forces = np.random.RandomState(0).uniform(-2.0, 2.0, (40, 16, 1))
    jenv = jax_make_env("cartpole2link", stabilization=True)
    env = make_env("cartpole2link", stabilization=True)
    jstep = jax.jit(jenv.step)
    ticks = iter(range(40))
    ref = _loop(jenv, JaxEnvState.make(jnp.asarray(x0)),
                lambda x: forces[next(ticks)],
                lambda s, u: jstep(s, jnp.asarray(u)), 40,
                lambda s: np.asarray(s.num_successes >= jenv.success_streak))
    ticks = iter(range(40))
    ours = _loop(env, EnvState.make(torch.tensor(x0)),
                 lambda x: torch.tensor(forces[next(ticks)]), env.step, 40,
                 lambda s: (s.num_successes >= env.success_streak).numpy())
    assert ours["actions"].shape == ref["actions"].shape
    np.testing.assert_allclose(ours["states"], ref["states"], rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(ours["done_at"], ref["done_at"])
    np.testing.assert_array_equal(ours["success"], ref["success"])
    # the forces move the states: not a test of an idle loop
    assert np.abs(ref["states"][-1] - x0).max() > 1e-2


if __name__ == "__main__":
    main()
