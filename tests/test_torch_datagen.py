"""The port's MPC expert and DAgger pieces against the JAX package's, on the
CPU in float64 (JAX with x64 on, tests/conftest.py; the port's K3 runs its
plain PyTorch version).

``mpc_expert_rollouts`` from the same initial states (numpy, seeded), 4
trajectories × 5 steps, on Cartpole2l-v0-stabilize (T 10, qp_iter 4, the
terminal LQR cost) and Pendulum-v0-stabilize (T 20, qp_iter 5): every
state and every action within 1e-6 of the largest |state| or |action| of
the JAX expert's trajectories (cp2's forces reach ~120 N, its states ~4).
The plans meet near-ties: the SQP's best-iterate comparison and its
rollout line search (the largest improving α of 0.2ʲ) choose between
candidates whose costs agree to rounding, so two correct float64
implementations agree to ~1e-7 relative, not to bits. On cp2 the terminal
P (entries to 2.5e5) flattens the valley: from one of these states the
two packages' plans at qp_iter 3 differ by 4.7e-5 N on a 75 N plan while
their costs agree to 3.4e-16 relative (measured on the CPU). The pickles
store float32, whose rounding is inside the tolerance too.
``save_expert_pickle`` round-trips through the JAX package's
``load_expert_pickle``, and ``select_relabel_states`` draws the JAX
package's subsample from the same RandomState, exactly. The entry point's
RL experts (``--expert sac``) run on the CPU when asked. The JAX expert's
env step and its terminal cost's model run jitted here (the same
computation; eager JAX re-traces cp2's dynamics at every call)."""
import pickle

import jax
import numpy as np
import pytest
import torch

from _torch_port_common import jitted_jax_terminal_cost
from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.learning import dagger as jax_dagger
from diff_qp_mpc_tpu.learning import data as jax_data
from diff_qp_mpc_tpu.learning import datagen as jax_datagen
from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import dagger, data, datagen
from diff_qp_mpc_tpu_torch.ops import riccati_cuda

TOL = 1e-6
CASES = [("cartpole2link", "Cartpole2l-v0-stabilize"),
         ("pendulum", "Pendulum-v0-stabilize")]


def _init_states(env, n, seed):
    """Initial states uniform in the env's stabilize box, from numpy."""
    high = {6: np.array([0.1, 0.05, 0.05, 0.05, 0.05, 0.05]),
            2: np.array([0.05, 0.5])}[env.nx]
    goal = np.asarray(getattr(env, "goal", np.zeros(env.nx)))
    return goal + np.random.RandomState(seed).uniform(-high, high,
                                                      (n, env.nx))


@pytest.mark.parametrize("name,spec", CASES, ids=["cp2", "pendulum"])
def test_expert_rollouts_match_jax(name, spec):
    env = make_env(name, stabilization=True)
    jenv = jax_make_env(name, stabilization=True)
    jenv.step = jax.jit(jenv.step)  # eager JAX re-traces cp2 every step
    assert env.spec_id == jenv.spec_id == spec
    assert datagen.EXPERT_PLANNER == jax_datagen.EXPERT_PLANNER
    init = _init_states(env, 4, seed=3)
    before = (riccati_cuda.launches, riccati_cuda.horizon_launches)
    ours = datagen.mpc_expert_rollouts(env, 4, max_steps=5, init_states=init,
                                       device="cpu")
    # CPU tensors take the plain version: no kernel is counted
    assert (riccati_cuda.launches, riccati_cuda.horizon_launches) == before
    with jitted_jax_terminal_cost():
        ref = jax_datagen.mpc_expert_rollouts(jenv, 4, max_steps=5,
                                              init_states=init)
    assert len(ours) == len(ref) == 4
    assert [len(a) for a in ours] == [len(b) for b in ref] == [5] * 4
    stack = lambda trajs, i: np.stack([p[i] for t in trajs for p in t])
    for i in (0, 1):  # states, actions
        got, want = stack(ours, i), stack(ref, i)
        assert got.dtype == np.float32
        err = np.abs(got.astype(np.float64) - want).max()
        assert err <= TOL * np.abs(want).max(), (i, err)
    # the expert moves the states: not a test of an idle loop
    assert max(np.abs(t[-1][0] - t[0][0]).max() for t in ours) > 1e-3


def test_expert_cost_matches_jax_terminal_cost():
    """The cp2 stabilize expert's dense cost: P from the DARE on the last
    stage's state block, c = −C·(goal, 0), as the JAX expert builds it."""
    from diff_qp_mpc_tpu.solvers.lqr import terminal_value_cost

    env = make_env("cartpole2link", stabilization=True)
    jenv = jax_make_env("cartpole2link", stabilization=True)
    planner = datagen.planner_settings(env)
    cost = datagen.expert_cost(env, planner, 2)
    T, n = planner["T"], env.nx + env.nu
    P = np.asarray(terminal_value_cost(jenv.model, jenv.goal, None,
                                       np.asarray(planner["Q"]),
                                       np.asarray(planner["R"])))
    C = np.broadcast_to(np.diag(planner["Q"] + planner["R"]),
                        (2, T, n, n)).copy()
    C[:, -1, :env.nx, :env.nx] += P
    xu_goal = np.concatenate([np.asarray(jenv.goal), np.zeros(env.nu)])
    np.testing.assert_allclose(cost.C.numpy(), C, rtol=1e-9, atol=0)
    np.testing.assert_allclose(cost.c.numpy(), -C @ xu_goal, rtol=1e-9,
                               atol=1e-9)


def test_save_expert_pickle_round_trips_through_jax_loader(tmp_path):
    rng = np.random.RandomState(0)
    trajs = [[(rng.randn(6).astype(np.float32),
               rng.randn(1).astype(np.float32)) for _ in range(k)]
             for k in (3, 5, 1)]
    path = str(tmp_path / "expert.pkl")
    data.save_expert_pickle(path, trajs)
    got = jax_data.load_expert_pickle(path)
    want = data.merge_trajectories(trajs)
    for k in ("state", "action", "mask"):
        np.testing.assert_array_equal(np.asarray(got[k]), want[k])
    np.testing.assert_array_equal(want["mask"],
                                  [1, 1, 0, 1, 1, 1, 1, 0, 0])


@pytest.mark.parametrize("n,num", [(50, 20), (7, 20)])
def test_select_relabel_states_matches_jax(n, num):
    states = np.random.RandomState(1).randn(n, 4).astype(np.float32)
    ours = dagger.select_relabel_states(states, num,
                                        np.random.RandomState(5))
    ref = jax_dagger.select_relabel_states(states, num,
                                           np.random.RandomState(5))
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) == min(n, num)


def test_expert_refuses_rl_experts_and_runs_on_the_cpu_when_asked(tmp_path):
    """The RL experts no longer raise: ``--expert sac`` trains SAC at a tiny
    iteration count (``--sac_iters 1``: the warmup and one block of 100
    iterations) and rolls its mean action out into a pickle of the
    reference layout, which the JAX package's loader reads. Then the MPC
    expert on the CPU, and the card required without ``--device cpu``."""
    out = str(tmp_path / "sac.pkl")
    trajs = datagen.main(["--env", "pendulum", "--expert", "sac",
                          "--sac_iters", "1", "--num_traj", "3",
                          "--max_steps", "5", "--device", "cpu", "--out",
                          out])
    with open(out, "rb") as f:
        raw = pickle.load(f)
    assert isinstance(raw, list) and len(raw) == len(trajs) == 3
    for traj in raw:
        assert len(traj) == 5
        for state, action in traj:
            assert state.dtype == action.dtype == np.float32
            assert state.shape == (2,) and action.shape == (1,)
            assert np.abs(action).max() <= 3.0
    ref = jax_data.load_expert_pickle(out)
    np.testing.assert_array_equal(np.asarray(ref["state"]),
                                  data.load_expert_pickle(out)["state"])
    out = str(tmp_path / "p.pkl")
    trajs = datagen.main(["--env", "pendulum", "--stabilization",
                          "--num_traj", "2", "--max_steps", "2", "--device",
                          "cpu", "--out", out])
    loaded = data.load_expert_pickle(out)
    assert len(trajs) == 2 and loaded["state"].shape == (4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            datagen.main(["--env", "pendulum", "--num_traj", "1",
                          "--max_steps", "1", "--out", out])


def test_dagger_entry_point_relabels_on_the_cpu(tmp_path):
    """DAgger from the cp1 checkpoint through its entry point, at a tiny
    size on the CPU: the policy's visited states, filtered to the goal's
    neighbourhood, subsampled and relabeled by the cp1 stabilize expert
    (T 60), written in the reference format."""
    out = str(tmp_path / "dagger.pkl")
    steps = []
    summary = dagger.main(
        ["--env", "cartpole1link", "--deq", "--T", "10", "--qp_iter", "4",
         "--solver_carry", "on", "--deq_out_type", "1", "--fused", "--ckpt",
         "logs/deqmpc_cp1_fused_v10_T10/ckpt_best.msgpack", "--episodes",
         "3", "--max_steps", "2", "--num_relabel", "2", "--relabel_steps",
         "2", "--filter_goal_dist", "10", "--device", "cpu", "--out", out],
        on_expert_step=steps.append)
    assert summary["expert_env"] == "Cartpole1l-v0-stabilize"
    assert summary["visited"] == 6 and summary["num_traj"] == 2
    assert steps == [0, 1]
    loaded = data.load_expert_pickle(out)
    assert loaded["state"].shape == (summary["steps"], 4)
    assert np.isfinite(loaded["state"]).all()

