"""The port's evaluate entry point: a short closed loop of the committed
pendulum checkpoint against the JAX package's evaluate_policy from the same
initial states, the meta.json adoption rules, the device rule, and a short
CPU evaluation of the ip checkpoint on both ip solver paths."""
import jax
import numpy as np
import pytest
import torch

from _torch_port_common import (
    CKPT,
    IP_CKPT,
    jax_params,
    jax_policy,
    policy_argv,
    t,
    torch_policy,
)
from diff_qp_mpc_tpu.envs import EnvState as JaxEnvState
from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.learning.evaluate import (
    evaluate_policy as jax_evaluate_policy,
)
from diff_qp_mpc_tpu_torch.learning import evaluate

# two starts at upright (they reach the 10-step success streak within 20
# steps) and two swing-ups
X0 = np.array([[0.01, 0.0], [0.03, -0.05], [2.5, 0.0], [-3.0, 0.5]])


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_closed_loop_matches_jax(fused):
    """4 episodes × 20 steps in float64: the metrics (success, reward,
    episode length, final goal error) of the port's evaluate_policy match
    the JAX one's from the same initial states. Rewards sum θ² over the
    trajectory, so they agree to the solver's float64 tolerance."""
    argv = policy_argv(fused=fused)
    jpol, _ = jax_policy(argv)
    jenv = jax_make_env("pendulum")
    jenv.reset = lambda key, bsz: JaxEnvState.make(jax.numpy.asarray(X0))
    ref = jax_evaluate_policy(jenv, jpol, jax_params(jpol), episodes=4,
                              max_steps=20)
    pol, env = torch_policy(argv)
    got = evaluate.evaluate_policy(env, pol, episodes=4, max_steps=20,
                                   device=torch.device("cpu"),
                                   dtype=torch.float64, x_init=t(X0))
    assert 0.0 < ref["success_rate"] < 1.0  # the run is not vacuous
    for k in ("success_rate", "mean_episode_len", "episodes"):
        assert got[k] == ref[k], k
    for k in ("mean_reward", "median_final_goal_err"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)
    assert got["steps_run"] == 20


def _argv(*extra):
    return ["--env", "pendulum", "--deq", "--ckpt", CKPT, *extra]


def test_meta_adoption():
    """The checkpoint's meta.json shapes the policy unless a flag is given;
    fused is not adopted; a fused-trained checkpoint without solver_carry
    gets 'off' on either path (fresh λ/ρ per solve, its training operator)."""
    args = evaluate.parse_args(_argv())
    assert (args.deq_iter, args.qp_iter, args.deq_out_type, args.T,
            args.hdim, args.layer_type) == (6, 2, 2, 5, 128, "mlp")
    assert args.fused is False and args.solver_carry == "off"
    args = evaluate.parse_args(_argv("--fused", "--deq_iter", "3"))
    assert args.fused is True and args.deq_iter == 3
    assert args.solver_carry == "off"
    assert evaluate.parse_args(_argv("--solver_carry", "on")) \
        .solver_carry == "on"


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_adopted_policy_solves_fresh(fused):
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import make_policy

    args = evaluate.parse_args(_argv(*(["--fused"] if fused else [])))
    pol = make_policy(args, make_env(args.env))
    assert pol.tracking.use_fused is fused
    assert pol.tracking.carry is False
    assert pol.tracking.cfg.al_iter == 2 and pol.deq_iter == 6


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_ip_checkpoint_adopts_its_solver(fused):
    """The ip checkpoint's meta.json sets solver_type ip and out_type 1;
    make_policy builds the SQP tracker (K4's IPM with --fused)."""
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning.train import make_policy

    args = evaluate.parse_args(["--env", "pendulum", "--deq", "--ckpt",
                                IP_CKPT] + (["--fused"] if fused else []))
    assert (args.solver_type, args.deq_out_type, args.qp_iter,
            args.terminal_lqr) == ("ip", 1, 2, False)
    pol = make_policy(args, make_env(args.env))
    assert pol.tracking.solver_type == "ip" and pol.out_type == 1
    assert pol.tracking.sqp_cfg.qp_iter == 2
    assert pol.tracking.sqp_cfg.qp.kernel == ("fused" if fused else "scan")


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_ip_closed_loop_on_cpu(fused):
    """8 episodes × 30 steps of the ip checkpoint through evaluate.main on
    the CPU (the kernels' plain versions): finite metrics. Thirty steps do
    not finish the swing-ups, so success is not required here; the card's
    64-episode run (chip_smoke.py) holds it to 0.95."""
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda, trajqp_fused_cuda

    k3, k4 = riccati_cuda.launches, trajqp_fused_cuda.launches
    metrics = evaluate.main(["--env", "pendulum", "--deq", "--ckpt", IP_CKPT,
                             "--device", "cpu", "--episodes", "8",
                             "--max_steps", "30"]
                            + (["--fused"] if fused else []))
    assert (riccati_cuda.launches, trajqp_fused_cuda.launches) == (k3, k4)
    assert metrics["episodes"] == 8 and 0 < metrics["steps_run"] <= 30
    for k in ("success_rate", "mean_reward", "mean_episode_len",
              "median_final_goal_err"):
        assert np.isfinite(metrics[k]), k


def test_entry_point_needs_cuda_unless_cpu_is_asked(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.main(_argv("--episodes", "2", "--max_steps", "1"))
    metrics = evaluate.main(_argv("--device", "cpu", "--episodes", "2",
                                  "--max_steps", "2", "--fused"))
    assert metrics["steps_run"] == 2 and metrics["episodes"] == 2
    assert '"success_rate"' in capsys.readouterr().out


@pytest.mark.parametrize("noise_type", range(7))
def test_noise_modes(noise_type):
    """corrupt_observation: same generator seed, same noise; the JAX
    package's semantics per mode (its random bits differ: torch.Generator
    vs jax.random). noise_mean is the drop probability of modes 3-6."""
    from diff_qp_mpc_tpu_torch.learning import noise

    x = t(np.random.RandomState(0).randn(64, 5, 2))
    draw = lambda: noise.corrupt_observation(
        torch.Generator().manual_seed(1), x, noise_type, 0.1, 0.3)
    a = draw()
    assert a.shape == x.shape and a.dtype == x.dtype
    assert torch.equal(a, draw())
    if noise_type == 0:
        assert torch.equal(a, x)
        return
    if noise_type in (1, 2):
        d = a - x - 0.3
        assert (d != 0).all()
        if noise_type == 2:
            assert d.abs().max() <= 0.1
        return
    fill = torch.zeros_like(x) if noise_type in (3, 4) \
        else torch.roll(x, 1, dims=1)
    kept = a == x
    assert torch.equal(torch.where(kept, x, fill), a)
    assert 0.2 < 1.0 - kept.double().mean() < 0.4
    if noise_type in (4, 6):  # whole state vectors drop together
        assert torch.equal(kept[..., 0], kept[..., 1])


# ------------------------------------ the integrator's and cartpoles' ----
CP1 = "logs/deqmpc_cp1_fused_v10_T10/ckpt_best.msgpack"
INTEGRATOR = "logs/deqmpc_integrator_mpc_T5_bsz256/ckpt.msgpack"
CP2_V8 = "logs/deqmpc_cp2_fused_v8_T10/ckpt_best.msgpack"
QUAD = "logs/deqmpc_quadrotor_fused_v8/ckpt_best.msgpack"


def test_new_checkpoints_adopt_their_flags():
    """Each checkpoint's meta.json gives its env and solver: the env's
    variant, horizon, AL budget and penalty cap, the tracking weight, and
    the warm-start carry (the integrator's meta predates solver_carry and
    was trained on the scan path: carried)."""
    args = evaluate.parse_args(["--ckpt", CP1])
    assert (args.env, args.stabilization, args.T, args.qp_iter,
            args.deq_out_type, args.solver_carry, args.fused) == (
        "cartpole1link", False, 10, 4, 1, "on", False)
    args = evaluate.parse_args(["--ckpt", INTEGRATOR])
    assert (args.env, args.T, args.qp_iter, args.deq_out_type,
            args.solver_carry) == ("integrator", 5, 2, 2, "on")
    args = evaluate.parse_args(["--ckpt", CP2_V8, "--fused"])
    assert (args.env, args.stabilization, args.T, args.qp_iter,
            args.rho_max, args.al_reg, args.tracking_r) == (
        "cartpole2link", True, 10, 4, 1e4, 1e-6, 0.01)
    args = evaluate.parse_args(["--ckpt", QUAD, "--fused"])
    assert (args.env, args.T, args.deq_iter, args.hdim, args.qp_iter,
            args.rho_max, args.al_reg, args.solver_carry,
            args.deq_out_type) == ("rexquadrotor", 5, 6, 128, 2, 1e4, None,
                                   "on", 1)


@pytest.mark.parametrize("name,kwargs,expert", [
    ("integrator", {}, "mpc"), ("cartpole1link", {}, "sac"),
    ("cartpole1link", {"stabilization": True}, "mpc"),
    ("cartpole2link", {"stabilization": True}, "mpc"),
    ("rexquadrotor", {}, "mpc")])
def test_default_data_paths_exist(name, kwargs, expert):
    """train's default expert pickle, from the env's spec_id, is committed
    for each new env (as the JAX trainer names it)."""
    import os

    from diff_qp_mpc_tpu.learning.train import (
        default_data_path as jax_default_data_path,
    )
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import train

    args = train.build_parser().parse_args(["--env", name,
                                            "--expert_type", expert])
    env = make_env(name, **kwargs)
    path = train.default_data_path(args, env)
    assert path == jax_default_data_path(args, jax_make_env(name, **kwargs))
    assert os.path.exists(path), path


def test_comma_separated_data_is_concatenated():
    """cp1's training data, two pickles in one --data: each keeps its
    episode ends."""
    from diff_qp_mpc_tpu_torch.learning import data

    a, b = ("data/expert_traj_sac-Cartpole1l-v0_new.pkl",
            "data/expert_traj_mpc-Cartpole1l-v0-hold_new.pkl")
    both = data.load_expert_pickle(f"{a},{b}")
    da, db = data.load_expert_pickle(a), data.load_expert_pickle(b)
    for k in ("state", "action", "mask"):
        np.testing.assert_array_equal(both[k],
                                      np.concatenate([da[k], db[k]]))
    assert both["state"].shape[1] == 4


@pytest.mark.parametrize("ckpt,flags", [(CP1, ["--fused"]),
                                        (INTEGRATOR, []),
                                        (CP2_V8, ["--fused"]),
                                        (QUAD, ["--fused"])],
                         ids=["cp1-fused", "integrator-scan", "cp2-fused",
                              "quad-fused"])
def test_new_checkpoints_evaluate_on_cpu(ckpt, flags):
    """The evaluate entry point on each new checkpoint, kernels through
    their plain versions: two episodes, three steps."""
    m = evaluate.main(["--ckpt", ckpt, "--device", "cpu", "--episodes", "2",
                       "--max_steps", "3", *flags])
    assert m["steps_run"] == 3 and np.isfinite(m["mean_reward"])
