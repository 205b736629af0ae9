"""The RL experts (learning.rl) on the card against the CPU, float64.

This file imports no JAX, so it runs on the GPU machine:

    python -m pytest -p no:xdist -p no:cacheprovider -o addopts="" \\
        -m cuda tests/test_torch_cuda_rl.py

Without a CUDA device every test skips. From the same state and draws,
one SAC and one CGAC update, a PPO update (its epochs × minibatches Adam
steps) and the committed CGAC actors' closed-loop actions agree within
RL_TOL (1e-9) of each quantity's largest entry, as chip_smoke.py holds
them; the trainers' loops run on the card with no host draw but the env
resets'."""
import copy

import pytest
import torch

from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning import rl
from diff_qp_mpc_tpu_torch.learning.optim import Adam

pytestmark = pytest.mark.cuda
RL_TOL = 1e-9
F64 = torch.float64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


@pytest.mark.parametrize("algo,cfg", [
    (rl.SAC, rl.SACConfig(batch_size=64, buffer_size=4096)),
    (rl.CGAC, rl.CGACConfig(n_envs=32, batch_size=128))],
    ids=["sac", "cgac"])
def test_soft_actor_critic_update_card_vs_cpu(cuda, algo, cfg):
    env = make_env("pendulum")
    cpu = algo(env, cfg, dtype=F64, device="cpu")
    card = algo(env, cfg, dtype=F64, device=cuda)
    draws = rl.Draws(3, "cpu")
    st = cpu.init_state(3, draws)
    cpu.warmup(st, draws)
    st_card = rl.state_to(st, cuda)
    B, nu = cfg.batch_size, env.nu
    for _ in range(2):
        idx = draws.randint(cpu.batch_high(st), B)
        eps = (draws.normal((B, nu), F64), draws.normal((B, nu), F64))
        got = card.grad_update(st_card, idx.to(cuda),
                               *(e.to(cuda) for e in eps))
        want = cpu.grad_update(st, idx, *eps)
        for g, w in zip(got, want):
            assert _rel(g, w) <= RL_TOL
    for name in ("actor", "q", "q_targ"):
        for g, w in zip(getattr(st_card, name).parameters(),
                        getattr(st, name).parameters()):
            assert g.device.type == "cuda"
            assert _rel(g, w) <= RL_TOL, name
    assert _rel(st_card.log_alpha, st.log_alpha) <= RL_TOL


def test_ppo_update_card_vs_cpu(cuda):
    env = make_env("pendulum")
    cfg = rl.PPOConfig(n_envs=16, rollout_len=32)
    cpu = rl.PPO(env, cfg, dtype=F64, device="cpu")
    card = rl.PPO(env, cfg, dtype=F64, device=cuda)
    d = rl.Draws(1, "cpu")
    net, opt = cpu.init(1)
    L, n = cfg.rollout_len, cfg.n_envs
    es = EnvState.make(d.fresh(env, (1, n), F64)[0])
    _, traj, last_v = cpu.collect(net, es, d.normal((L, n, env.nu), F64),
                                  d.fresh(env, (L, n), F64))
    advs, returns = cpu.gae(traj, last_v)
    perms = torch.stack([d.permutation(L * n) for _ in range(cfg.epochs)])
    net_g = copy.deepcopy(net).to(cuda)
    opt_g = Adam(dict(net_g.named_parameters()), cfg.lr)
    to = lambda a: a.to(cuda)
    loss_g = card.update(net_g, opt_g, rl.Transition(*map(to, traj)),
                         to(advs), to(returns), to(perms))
    loss = cpu.update(net, opt, traj, advs, returns, perms)
    assert _rel(loss_g, loss) <= RL_TOL
    for g, w in zip(net_g.parameters(), net.parameters()):
        assert _rel(g, w) <= RL_TOL


@pytest.mark.parametrize("env_name,path", [
    ("pendulum", "data/expert_traj_cgac-Pendulum-v0_new.pkl"
     ".cgac_ckpt.msgpack"),
    ("cartpole1link", "data/expert_traj_cgac-Cartpole1l-v0_new.pkl"
     ".cgac_ckpt.msgpack")], ids=["pendulum", "cp1"])
def test_committed_cgac_actor_card_vs_cpu(cuda, env_name, path):
    env = make_env(env_name)
    init = env.reset(torch.Generator().manual_seed(0), 64, dtype=F64).x
    actions = {}
    for device in ("cpu", cuda):
        actor, m, v = rl.load_cgac_actor(path, device=device, dtype=F64)
        act = rl.actor_act_fn(env, actor, m, v)
        state, us = EnvState.make(init.to(device)), []
        for _ in range(20):
            us.append(act(state.x))
            state, _, _ = env.step(state, us[-1])
        actions[str(device)] = torch.stack(us)
    assert _rel(actions["cuda"], actions["cpu"]) <= RL_TOL


def test_training_loops_run_on_the_card(cuda):
    """A block of each trainer and a PPO iteration at small sizes on the
    card: finite losses, the state on the card."""
    env = make_env("pendulum")
    for algo in (rl.SAC(env, rl.SACConfig(block=2, buffer_size=1024),
                        device=cuda),
                 rl.CGAC(env, rl.CGACConfig(block=2, n_envs=32,
                                            batch_size=128), device=cuda)):
        draws = rl.Draws(0, cuda)
        st = algo.init_state(0, draws)
        algo.warmup(st, draws)
        out = algo.train_block(st, draws)
        assert all(bool(torch.isfinite(v).all()) for v in out)
        assert st.buf_obs.device.type == "cuda"
    ppo = rl.PPO(env, rl.PPOConfig(n_envs=8, rollout_len=16), device=cuda)
    draws = rl.Draws(0, cuda)
    net, opt = ppo.init(0)
    es = EnvState.make(draws.fresh(env, (1, 8), torch.float32)[0])
    es, loss, mean_r = ppo.iteration(net, opt, es, draws)
    assert bool(torch.isfinite(loss)) and es.x.device.type == "cuda"
