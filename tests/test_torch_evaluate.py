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
