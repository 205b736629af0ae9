"""RL experts (port of diff_qp_mpc_tpu.learning.rl): PPO, SAC and CGAC, their
deterministic rollouts into expert datasets, and the entry point.

- PPO: clipped surrogate with GAE over a batch of auto-resetting envs.
- SAC: twin-Q soft actor-critic with automatic entropy tuning, the
  tanh-squashed Gaussian actor with the action-bound log-det correction, a
  device-resident ring replay buffer and an optional running mean/std
  observation normalizer (Chan's parallel update).
- CGAC: the same actor-critic over many parallel envs with a short FIFO
  window of the freshest transitions in place of the replay buffer, an ELU
  actor trunk (512, 256), always-on observation normalization, and a TD
  target without a done mask (as the JAX package's).

Every update is a function of its random draws, so that a test can pass in
the JAX package's: ``grad_update(st, idx, eps_act, eps_next)``,
``env_step(st, draw, fresh)``, PPO's ``collect(net, env_state, eps, fresh)``
and ``update(..., perms)``. The loops draw them from ``Draws``: a
``torch.Generator`` on the device, and the env's fresh initial states on the
CPU as ``Env.reset`` draws them, a block of env steps at a time. Variances
and standard deviations are population ones (``correction=0``), as
``jnp.var`` and ``jnp.std``. The networks are ``nn.Module``s whose Linear
layers keep flax's ``Dense_i`` order (``DENSE``), initialised as flax does
(``deq.flax_init``); ``params_from_flax`` and ``params_to_flax`` carry their
weights to and from the JAX package's trees, and ``save_expert_checkpoint``
writes the SAC and CGAC checkpoints (``<save_data>.{sac,cgac}_ckpt.msgpack``)
in its layout.

Usage:
    python -m diff_qp_mpc_tpu_torch.learning.rl --env pendulum --algo sac \\
        --iters 30000 --save_data build/expert_traj_sac-Pendulum-v0_new.pkl \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import math
import os
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning.data import save_expert_pickle
from diff_qp_mpc_tpu_torch.learning.deq import flax_init
from diff_qp_mpc_tpu_torch.learning.optim import (
    Adam,
    clip_by_global_norm,
    global_norm,
)
from diff_qp_mpc_tpu_torch.utils import checkpoint
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

Tensor = torch.Tensor

LOG_SIG_MIN, LOG_SIG_MAX = -20.0, 2.0
_LOG_2PI = math.log(2 * math.pi)


# ---------------------------------------------------------------------------
# networks and their flax weights
# ---------------------------------------------------------------------------


class ActorCritic(nn.Module):
    """PPO's Gaussian actor and value head: a tanh trunk to the mean, a
    state-independent ``log_std`` (starting at −0.5), and a value head with
    its own tanh layer from the observation. In flax's
    ``Dense(1)(tanh(Dense(hdim)(x)))`` the outer layer is built first, so
    the value head's output layer is Dense_3 and its hidden one Dense_4."""

    DENSE = ("fc1", "fc2", "mean", "v_out", "v_fc")
    EXTRA = ("log_std",)

    def __init__(self, nx: int, nu: int, hdim: int = 128):
        super().__init__()
        self.fc1 = nn.Linear(nx, hdim)
        self.fc2 = nn.Linear(hdim, hdim)
        self.mean = nn.Linear(hdim, nu)
        self.log_std = nn.Parameter(torch.full((nu,), -0.5))
        self.v_fc = nn.Linear(nx, hdim)
        self.v_out = nn.Linear(hdim, 1)
        flax_init(self)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        h = torch.tanh(self.fc2(torch.tanh(self.fc1(x))))
        v = self.v_out(torch.tanh(self.v_fc(x)))[..., 0]
        return self.mean(h), self.log_std, v


class GaussianActor(nn.Module):
    """SAC's actor: a relu trunk, mean and state-dependent log-std heads,
    the log-std clamped to [LOG_SIG_MIN, LOG_SIG_MAX]."""

    DENSE = ("fc1", "fc2", "mean", "log_std")
    EXTRA = ()

    def __init__(self, nx: int, nu: int, hdim: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(nx, hdim)
        self.fc2 = nn.Linear(hdim, hdim)
        self.mean = nn.Linear(hdim, nu)
        self.log_std = nn.Linear(hdim, nu)
        flax_init(self)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = torch.relu(self.fc2(torch.relu(self.fc1(x))))
        return self.mean(h), torch.clamp(self.log_std(h), LOG_SIG_MIN,
                                         LOG_SIG_MAX)


class TwinQ(nn.Module):
    """Twin Q networks on (x, u). flax's module calls one inner function
    twice, so it holds six Dense layers, Dense_0..2 the first Q and
    Dense_3..5 the second, initialised by separate draws."""

    DENSE = ("q1_fc1", "q1_fc2", "q1_out", "q2_fc1", "q2_fc2", "q2_out")
    EXTRA = ()

    def __init__(self, nx: int, nu: int, hdim: int = 256):
        super().__init__()
        for q in ("q1", "q2"):
            setattr(self, f"{q}_fc1", nn.Linear(nx + nu, hdim))
            setattr(self, f"{q}_fc2", nn.Linear(hdim, hdim))
            setattr(self, f"{q}_out", nn.Linear(hdim, 1))
        flax_init(self)

    def _q(self, q: str, xu: Tensor) -> Tensor:
        h = torch.relu(getattr(self, f"{q}_fc1")(xu))
        h = torch.relu(getattr(self, f"{q}_fc2")(h))
        return getattr(self, f"{q}_out")(h)[..., 0]

    def forward(self, x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
        xu = torch.cat([x, u], dim=-1)
        return self._q("q1", xu), self._q("q2", xu)


class CGACActor(nn.Module):
    """CGAC's actor: an ELU trunk (512, 256), mean and state-dependent
    log-std heads, the log-std clamped to [−20, 2]."""

    EXTRA = ()

    def __init__(self, nx: int, nu: int, hidden: Tuple[int, ...] = (512, 256)):
        super().__init__()
        widths = (nx,) + tuple(hidden)
        self.trunk = nn.ModuleList(nn.Linear(a, b)
                                   for a, b in zip(widths, widths[1:]))
        self.mean = nn.Linear(widths[-1], nu)
        self.log_std = nn.Linear(widths[-1], nu)
        self.DENSE = tuple(f"trunk.{i}" for i in range(len(hidden))) + (
            "mean", "log_std")
        flax_init(self)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        h = x
        for layer in self.trunk:
            h = F.elu(layer(h))
        return self.mean(h), torch.clamp(self.log_std(h), LOG_SIG_MIN,
                                         LOG_SIG_MAX)


def _flax_modules(net: nn.Module) -> Tuple[Tuple[str, str], ...]:
    return tuple((f"Dense_{i}", name) for i, name in enumerate(net.DENSE))


def params_from_flax(net: nn.Module, tree: Dict) -> Dict[str, Tensor]:
    """The flax parameter tree of ``net``'s network (the dict holding
    ``Dense_0``, ...) -> ``net``'s ``state_dict``."""
    state = checkpoint.params_from_flax(tree, _flax_modules(net))
    state.update({k: torch.tensor(np.asarray(tree[k])) for k in net.EXTRA})
    return state


def params_to_flax(net: nn.Module) -> Dict:
    """``net``'s parameters as the JAX package's flax tree (numpy leaves of
    the parameters' dtype)."""
    state = net.state_dict()
    tree = checkpoint.params_to_flax(state, _flax_modules(net))
    tree.update({k: state[k].detach().cpu().numpy() for k in net.EXTRA})
    return tree


def load_flax(net: nn.Module, tree: Dict) -> nn.Module:
    """``net`` with the weights of a flax tree, in ``net``'s dtype."""
    net.load_state_dict(params_from_flax(net, tree))
    return net


def save_expert_checkpoint(path: str, actor: nn.Module, obs_mean: Tensor,
                           obs_var: Tensor) -> None:
    """The SAC and CGAC trainers' checkpoint as the JAX package writes it
    (``save_checkpoint(path, {"actor": ..., "obs_mean": ..., "obs_var":
    ...})``): {"params": {"actor": {"params": <flax tree>}, "obs_mean",
    "obs_var"}} in flax's msgpack."""
    payload = {"params": {
        "actor": {"params": params_to_flax(actor)},
        "obs_mean": obs_mean.detach().cpu().numpy(),
        "obs_var": obs_var.detach().cpu().numpy()}}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(checkpoint.dumps(payload))


def load_cgac_actor(path: str, device=None, dtype=torch.float32
                    ) -> Tuple[CGACActor, Tensor, Tensor]:
    """(actor, obs_mean, obs_var) of a CGAC checkpoint (the committed
    ``data/*.cgac_ckpt.msgpack`` or ``save_expert_checkpoint``'s), its
    widths read from the kernels, on ``device`` in ``dtype``."""
    device = resolve_device(device)
    tree = checkpoint.load_msgpack(path)["params"]
    dense = tree["actor"]["params"]
    n_hidden = len(dense) - 2
    hidden = tuple(int(dense[f"Dense_{i}"]["kernel"].shape[1])
                   for i in range(n_hidden))
    nx = int(dense["Dense_0"]["kernel"].shape[0])
    nu = int(dense[f"Dense_{n_hidden}"]["kernel"].shape[1])
    actor = load_flax(CGACActor(nx, nu, hidden), dense)
    as_t = lambda a: torch.tensor(np.asarray(a), dtype=dtype,
                                  device=device)
    return (actor.to(device=device, dtype=dtype), as_t(tree["obs_mean"]),
            as_t(tree["obs_var"]))


# ---------------------------------------------------------------------------
# deterministic policies, evaluation and expert rollouts
# ---------------------------------------------------------------------------


def norm_obs(obs: Tensor, obs_mean: Tensor, obs_var: Tensor) -> Tensor:
    """The running normalizer's forward: (obs − mean)/√(var + 1e-5),
    clamped to ±5."""
    return torch.clamp((obs - obs_mean) / torch.sqrt(obs_var + 1e-5),
                       -5.0, 5.0)


def action_affine(env, dtype=torch.float32, device=None
                  ) -> Tuple[Tensor, Tensor]:
    """(act_scale, act_bias) = ((high − low)/2, (high + low)/2) of the env's
    action box."""
    kw = dict(dtype=dtype, device=device)
    lo = torch.as_tensor(env.action_space.low, **kw)
    hi = torch.as_tensor(env.action_space.high, **kw)
    return (hi - lo) / 2.0, (hi + lo) / 2.0


def actor_act_fn(env, actor: nn.Module, obs_mean: Optional[Tensor] = None,
                 obs_var: Optional[Tensor] = None) -> Callable:
    """The deterministic (mean) action of a SAC or CGAC actor,
    tanh(mean)·act_scale + act_bias, on observations normalized by
    (obs_mean, obs_var) where they are given."""
    p = next(actor.parameters())
    scale, bias = action_affine(env, p.dtype, p.device)

    def act(obs: Tensor) -> Tensor:
        with torch.no_grad():
            if obs_mean is not None:
                obs = norm_obs(obs, obs_mean, obs_var)
            return torch.tanh(actor(obs)[0]) * scale + bias

    return act


def ppo_act_fn(env, net: ActorCritic) -> Callable:
    """PPO's deterministic action, tanh(mean)·high."""
    p = next(net.parameters())
    high = torch.as_tensor(env.action_space.high, dtype=p.dtype,
                           device=p.device)

    def act(obs: Tensor) -> Tensor:
        with torch.no_grad():
            return torch.tanh(net(obs)[0]) * high

    return act


def _initial_state(env, num: int, seed: int, init_states, dtype, device
                   ) -> EnvState:
    if init_states is None:
        return env.reset(torch.Generator().manual_seed(seed), num,
                         dtype=dtype, device=device)
    return EnvState.make(torch.as_tensor(np.asarray(init_states),
                                         dtype=dtype, device=device))


def evaluate_policy(env, act_fn: Callable, n: int = 64, seed: int = 0,
                    max_steps: Optional[int] = None, dtype=torch.float32,
                    device=None) -> float:
    """Mean episode return of a deterministic policy over ``n`` parallel
    envs, from the env's reset draw seeded by ``seed``."""
    device = resolve_device(device)
    state = _initial_state(env, n, seed, None, dtype, device)
    total = torch.zeros(n, dtype=dtype, device=device)
    alive = torch.ones(n, dtype=torch.bool, device=device)
    for _ in range(max_steps or env.max_steps):
        state, r, done = env.step(state, act_fn(state.x))
        total = total + r * alive
        alive = alive & ~done
    return float(total.mean())


def sac_expert_rollouts(env, act_fn: Callable, num_traj: int = 300,
                        max_steps: Optional[int] = None, seed: int = 0,
                        init_states=None, dtype=torch.float32,
                        device=None) -> List:
    """Deterministic expert rollouts in the reference pickle format:
    ``num_traj`` trajectories of (state, action) float32 numpy pairs, each
    truncated at its first done step. Initial states are the env's reset
    draw from ``torch.Generator`` seeded by ``seed``, or ``init_states``
    [num_traj, nx]."""
    device = resolve_device(device)
    state = _initial_state(env, num_traj, seed, init_states, dtype, device)
    num_traj = state.x.shape[0]
    xs, us, dones = [], [], []
    ever = np.zeros(num_traj, bool)
    for _ in range(max_steps or env.max_steps):
        u = act_fn(state.x)
        xs.append(state.x.cpu().numpy().astype(np.float32))
        us.append(u.cpu().numpy().astype(np.float32))
        state, _, done = env.step(state, u)
        ever |= done.cpu().numpy()
        dones.append(ever.copy())
        if ever.all():
            break
    steps = len(xs)
    trajs = []
    for b in range(num_traj):
        end = next((t + 1 for t in range(steps) if dones[t][b]), steps)
        trajs.append([(xs[t][b], us[t][b]) for t in range(end)])
    return trajs


def ppo_expert_rollouts(env, net: ActorCritic, num_traj: int,
                        max_steps: int = 200, seed: int = 0,
                        init_states=None, device=None) -> List:
    """``sac_expert_rollouts`` of PPO's deterministic action, in the
    network's dtype."""
    return sac_expert_rollouts(env, ppo_act_fn(env, net), num_traj,
                               max_steps, seed, init_states,
                               next(net.parameters()).dtype, device)


# ---------------------------------------------------------------------------
# the random draws of the training loops
# ---------------------------------------------------------------------------


class Draws:
    """The training loops' random numbers: normals, uniforms, indices and
    permutations from a ``torch.Generator`` on ``device``; the env's fresh
    initial states from a CPU generator, as ``Env.reset`` draws them, then
    moved (one copy, and so one wait for the device, per call)."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.env_gen = torch.Generator().manual_seed(seed)

    def normal(self, shape, dtype) -> Tensor:
        return torch.randn(shape, generator=self.gen, dtype=dtype,
                           device=self.device)

    def uniform(self, lo: Tensor, hi: Tensor, shape) -> Tensor:
        return lo + (hi - lo) * torch.rand(shape, generator=self.gen,
                                           dtype=lo.dtype, device=self.device)

    def randint(self, high: int, n: int) -> Tensor:
        return torch.randint(0, high, (n,), generator=self.gen,
                             device=self.device)

    def permutation(self, n: int) -> Tensor:
        return torch.randperm(n, generator=self.gen, device=self.device)

    def fresh(self, env, shape: Tuple[int, int], dtype) -> Tensor:
        """[steps, n, nx] initial states: ``steps`` resets of ``n`` envs."""
        steps, n = shape
        x = env.reset(self.env_gen, steps * n, dtype=dtype,
                      device=self.device).x
        return x.reshape(steps, n, -1)


def _adam_step(opt: Adam, loss: Tensor) -> None:
    names = list(opt.params)
    grads = torch.autograd.grad(loss, [opt.params[k] for k in names])
    opt.step(dict(zip(names, grads)))


# ---------------------------------------------------------------------------
# SAC and CGAC
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SACConfig:
    n_envs: int = 16
    buffer_size: int = 200_000
    batch_size: int = 256
    updates_per_iter: int = 8      # grad updates per vectorized env step
    gamma: float = 0.99
    tau: float = 0.005             # target-net Polyak rate
    lr: float = 3e-4
    warmup_steps: int = 1_000      # random-action transitions before training
    auto_alpha: bool = True        # automatic entropy-temperature tuning
    init_alpha: float = 0.2
    normalize_obs: bool = False    # running mean/std observation normalizer
    reward_scale: float = 1.0      # buffer-side reward scaling
    block: int = 100               # iterations between logs


@dataclasses.dataclass(frozen=True)
class CGACConfig:
    n_envs: int = 256            # parallel envs
    window: int = 16             # on-policy FIFO depth, in env steps
    batch_size: int = 1024
    updates_per_iter: int = 4
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    warmup_steps: int = 4        # env steps before training (fills window)
    init_alpha: float = 0.2
    reward_scale: float = 1.0
    block: int = 100


@dataclasses.dataclass
class SoftACState:
    """The networks, their Adam states, the entropy temperature, the
    running observation statistics and the envs; SAC's and CGAC's buffers
    in the subclasses. Updated in place."""
    actor: nn.Module
    q: TwinQ
    q_targ: TwinQ
    log_alpha: Tensor  # 0-d, a leaf that opt_alpha updates
    opt_a: Adam
    opt_q: Adam
    opt_alpha: Adam
    obs_mean: Tensor
    obs_var: Tensor
    obs_count: Tensor  # 0-d
    env_state: EnvState


@dataclasses.dataclass
class SACState(SoftACState):
    # ring replay buffer on the device; ptr and size on the host
    buf_obs: Tensor
    buf_act: Tensor
    buf_rew: Tensor
    buf_next: Tensor
    buf_mask: Tensor
    ptr: int
    size: int


@dataclasses.dataclass
class CGACState(SoftACState):
    buf_obs: Tensor   # [window, n_envs, nx], the newest step last
    buf_act: Tensor
    buf_rew: Tensor
    buf_next: Tensor
    filled: int


def state_to(st: SoftACState, device) -> SoftACState:
    """A copy of a SAC or CGAC state on ``device``, the Adam states
    following their parameters."""
    device = torch.device(device)

    def move(t: Tensor) -> Tensor:
        return t.detach().to(device).clone()

    def net(m: nn.Module) -> nn.Module:
        return copy.deepcopy(m).to(device)

    def adam(opt: Adam, params: Dict[str, Tensor]) -> Adam:
        new = Adam(params, opt.lr, opt.b1, opt.b2, opt.eps)
        new.count = opt.count
        new.mu = {k: move(v) for k, v in opt.mu.items()}
        new.nu = {k: move(v) for k, v in opt.nu.items()}
        return new

    fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
    out = {k: move(v) if isinstance(v, Tensor) else v
           for k, v in fields.items()}
    for k in ("actor", "q", "q_targ"):
        out[k] = net(fields[k])
    out["log_alpha"] = move(st.log_alpha).requires_grad_(True)
    out["opt_a"] = adam(st.opt_a, dict(out["actor"].named_parameters()))
    out["opt_q"] = adam(st.opt_q, dict(out["q"].named_parameters()))
    out["opt_alpha"] = adam(st.opt_alpha, {"log_alpha": out["log_alpha"]})
    out["env_state"] = EnvState(*(move(v) for v in (
        st.env_state.x, st.env_state.num_successes, st.env_state.steps)))
    return type(st)(**out)


class _SoftActorCritic:
    """What SAC and CGAC share: the squashed Gaussian actor's sampling, the
    observation normalizer, the twin-Q/actor/temperature update with
    Polyak-averaged targets, the env step with auto-reset, and the loops."""

    normalize: bool
    auto_alpha: bool

    def __init__(self, env, cfg, actor_factory: Callable[[], nn.Module],
                 dtype=torch.float32, device=None):
        self.env, self.cfg, self.dtype = env, cfg, dtype
        self.device = resolve_device(device)
        self.actor_factory = actor_factory
        kw = dict(dtype=dtype, device=self.device)
        self.lo = torch.as_tensor(env.action_space.low, **kw)
        self.hi = torch.as_tensor(env.action_space.high, **kw)
        self.act_scale, self.act_bias = action_affine(env, **kw)
        self.target_entropy = -float(env.nu)

    # -- pieces --
    def norm_obs(self, st: SoftACState, obs: Tensor) -> Tensor:
        if not self.normalize:
            return obs
        return norm_obs(obs, st.obs_mean, st.obs_var)

    def update_obs_stats(self, st: SoftACState, batch_obs: Tensor) -> None:
        """Chan's parallel-moments update of the running statistics."""
        if not self.normalize:
            return
        bm = batch_obs.mean(0)
        bv = batch_obs.var(0, correction=0)
        bc = batch_obs.shape[0]
        delta = bm - st.obs_mean
        tot = st.obs_count + bc
        new_mean = st.obs_mean + delta * bc / tot
        m2 = (st.obs_var * st.obs_count + bv * bc
              + delta ** 2 * st.obs_count * bc / tot)
        st.obs_mean, st.obs_var, st.obs_count = new_mean, m2 / tot, tot

    def sample_action(self, actor: nn.Module, obs: Tensor, eps: Tensor
                      ) -> Tuple[Tensor, Tensor]:
        """The reparameterized sample mean + std·eps, squashed by tanh and
        scaled to the action box, and its log-probability with the
        bound correction log(act_scale·(1 − y²) + 1e-6)."""
        mean, log_std = actor(obs)
        std = torch.exp(log_std)
        x_t = mean + std * eps
        y_t = torch.tanh(x_t)
        action = y_t * self.act_scale + self.act_bias
        logp = -0.5 * (((x_t - mean) / std) ** 2 + 2 * log_std + _LOG_2PI)
        logp = logp - torch.log(self.act_scale * (1 - y_t ** 2) + 1e-6)
        return action, logp.sum(-1)

    def act_fn(self, st: SoftACState) -> Callable:
        """The deterministic policy of the state's actor and statistics."""
        if self.normalize:
            return actor_act_fn(self.env, st.actor, st.obs_mean, st.obs_var)
        return actor_act_fn(self.env, st.actor)

    def _learn(self, st: SoftACState, obs, act, rew, nxt, mask, eps_act,
               eps_next) -> Tuple[Tensor, Tensor]:
        """The critic step toward the soft Bellman target of the target
        nets, the actor step against the new critic, the temperature step
        on the detached logp + target_entropy, then Polyak with τ. ``mask``
        None: no done mask in the target (CGAC)."""
        cfg = self.cfg
        alpha = torch.exp(st.log_alpha.detach())
        with torch.no_grad():
            a2, logp2 = self.sample_action(st.actor, nxt, eps_next)
            q1t, q2t = st.q_targ(nxt, a2)
            soft = torch.minimum(q1t, q2t) - alpha * logp2
            target = rew + (cfg.gamma * soft if mask is None
                            else cfg.gamma * mask * soft)
        q1, q2 = st.q(obs, act)
        q_loss = torch.mean((q1 - target) ** 2) + torch.mean((q2 - target)
                                                             ** 2)
        _adam_step(st.opt_q, q_loss)

        a, logp = self.sample_action(st.actor, obs, eps_act)
        q1, q2 = st.q(obs, a)
        a_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        _adam_step(st.opt_a, a_loss)

        if self.auto_alpha:
            _adam_step(st.opt_alpha, -torch.mean(
                torch.exp(st.log_alpha)
                * (logp.detach() + self.target_entropy)))
        with torch.no_grad():
            targ = list(st.q_targ.parameters())
            torch._foreach_mul_(targ, 1 - cfg.tau)
            torch._foreach_add_(targ, torch._foreach_mul(
                list(st.q.parameters()), cfg.tau))
        return q_loss.detach(), a_loss.detach()

    @torch.no_grad()
    def env_step(self, st: SoftACState, draw: Tensor, fresh: Tensor,
                 random_policy: bool = False) -> Tensor:
        """One step of the envs: the action is ``draw`` itself under the
        random policy, else the actor's sample with noise ``draw`` (on the
        observations normalized by the statistics before this step); the
        transition goes to the buffer, the statistics take the
        observations, and the envs that are done restart from ``fresh``.
        Returns the mean reward."""
        obs = st.env_state.x
        if random_policy:
            u = draw
        else:
            u, _ = self.sample_action(st.actor, self.norm_obs(st, obs), draw)
        env2, reward, done = self.env.step(st.env_state, u)
        self._store(st, obs, u, self.cfg.reward_scale * reward, env2.x)
        self.update_obs_stats(st, obs)
        st.env_state = self.env.reset_where(env2, done, fresh=fresh)
        return reward.mean()

    # -- loops --
    def init_state(self, seed: int, draws: Draws) -> SoftACState:
        """Networks from ``torch.manual_seed(seed)`` (flax's initial
        distributions), float32 unless the trainer's dtype says otherwise;
        the envs' first states from ``draws``."""
        nx, nu = self.env.nx, self.env.nu
        torch.manual_seed(seed)
        kw = dict(dtype=self.dtype, device=self.device)
        actor = self.actor_factory().to(**kw)
        q = TwinQ(nx, nu).to(**kw)
        q_targ = copy.deepcopy(q)
        log_alpha = torch.tensor(math.log(self.cfg.init_alpha),
                                 **kw).requires_grad_(True)
        x0 = draws.fresh(self.env, (1, self.cfg.n_envs), self.dtype)[0]
        return self._make_state(
            actor=actor, q=q, q_targ=q_targ, log_alpha=log_alpha,
            opt_a=Adam(dict(actor.named_parameters()), self.cfg.lr),
            opt_q=Adam(dict(q.named_parameters()), self.cfg.lr),
            opt_alpha=Adam({"log_alpha": log_alpha}, self.cfg.lr),
            obs_mean=torch.zeros(nx, **kw), obs_var=torch.ones(nx, **kw),
            obs_count=torch.tensor(1e-4, **kw),
            env_state=EnvState.make(x0))

    def warmup(self, st: SoftACState, draws: Draws) -> Tensor:
        """The random-action warmup; returns its mean rewards."""
        n = self.cfg.n_envs
        steps = self.warmup_steps()
        fresh = draws.fresh(self.env, (steps, n), self.dtype)
        return torch.stack([self.env_step(
            st, draws.uniform(self.lo, self.hi, (n, self.env.nu)), fresh[i],
            random_policy=True) for i in range(steps)])

    def iteration(self, st: SoftACState, draws: Draws, fresh: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
        """One env step (the envs that are done restart from ``fresh``),
        then ``updates_per_iter`` gradient updates; returns the mean reward
        and the updates' mean losses."""
        cfg, nu = self.cfg, self.env.nu
        mean_r = self.env_step(st, draws.normal((cfg.n_envs, nu), self.dtype),
                               fresh)
        losses = [self.grad_update(
            st, draws.randint(self.batch_high(st), cfg.batch_size),
            draws.normal((cfg.batch_size, nu), self.dtype),
            draws.normal((cfg.batch_size, nu), self.dtype))
            for _ in range(cfg.updates_per_iter)]
        q_loss, a_loss = (torch.stack(v).mean() for v in zip(*losses))
        return mean_r, q_loss, a_loss

    def train_block(self, st: SoftACState, draws: Draws
                    ) -> Tuple[Tensor, Tensor, Tensor]:
        """``block`` iterations, the block's fresh initial states drawn
        at once; returns (mean rewards, q losses, actor losses) [block]."""
        fresh = draws.fresh(self.env, (self.cfg.block, self.cfg.n_envs),
                            self.dtype)
        rows = [self.iteration(st, draws, fresh[i])
                for i in range(self.cfg.block)]
        return tuple(torch.stack(v) for v in zip(*rows))

    def train(self, iters: int, seed: int = 0, log_every: int = 2_000,
              eval_rollouts: int = 64, ckpt_path: Optional[str] = None,
              on_log: Optional[Callable] = None):
        """The trainer: the warmup, then ``max(1, iters // block)`` blocks,
        evaluating and logging (as the JAX trainer prints) and
        checkpointing every ``log_every`` iterations. ``on_log(it, st,
        act_fn, row)`` is called at each log point and stops the run by
        returning True. Returns (actor, the deterministic act_fn)."""
        cfg = self.cfg
        draws = Draws(seed, self.device)
        st = self.init_state(seed, draws)
        self.warmup(st, draws)
        for b in range(max(1, iters // cfg.block)):
            mean_r, q_loss, a_loss = self.train_block(st, draws)
            if (b * cfg.block) % log_every < cfg.block:
                act = self.act_fn(st)
                ep_r = evaluate_policy(self.env, act, n=eval_rollouts,
                                       seed=seed + b, dtype=self.dtype,
                                       device=self.device)
                row = dict(iter=b * cfg.block, step_r=float(mean_r[-1]),
                           q_loss=float(q_loss[-1]),
                           a_loss=float(a_loss[-1]),
                           alpha=float(torch.exp(st.log_alpha.detach())),
                           eval_ep_r=ep_r)
                print(f"iter {row['iter']:6d} step_r {row['step_r']:+8.4f} "
                      f"q_loss {row['q_loss']:8.4f} "
                      f"a_loss {row['a_loss']:+8.4f} "
                      f"alpha {row['alpha']:.4f} "
                      f"eval_ep_r {ep_r:+9.2f}", flush=True)
                if ckpt_path is not None:
                    save_expert_checkpoint(ckpt_path, st.actor, st.obs_mean,
                                           st.obs_var)
                if on_log is not None and on_log(row["iter"], st, act, row):
                    break
        return st.actor, self.act_fn(st)


class SAC(_SoftActorCritic):
    """SAC over a uniform ring replay buffer; done mask always 1 (resets
    are time or success limits, so the target bootstraps through them)."""

    def __init__(self, env, cfg: SACConfig = SACConfig(),
                 dtype=torch.float32, device=None):
        super().__init__(env, cfg, lambda: GaussianActor(env.nx, env.nu),
                         dtype, device)
        self.normalize = cfg.normalize_obs
        self.auto_alpha = cfg.auto_alpha

    def _make_state(self, **kw) -> SACState:
        n, cfg = self.cfg.buffer_size, self.cfg
        z = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                       device=self.device)
        nx, nu = self.env.nx, self.env.nu
        return SACState(**kw, buf_obs=z(n, nx), buf_act=z(n, nu),
                        buf_rew=z(n), buf_next=z(n, nx), buf_mask=z(n),
                        ptr=0, size=0)

    def warmup_steps(self) -> int:
        return max(1, self.cfg.warmup_steps // self.cfg.n_envs)

    def batch_high(self, st: SACState) -> int:
        return st.size

    def _store(self, st: SACState, obs, act, rew, nxt) -> None:
        n, size = obs.shape[0], self.cfg.buffer_size
        idx = (st.ptr + torch.arange(n, device=obs.device)) % size
        st.buf_obs[idx] = obs
        st.buf_act[idx] = act
        st.buf_rew[idx] = rew
        st.buf_next[idx] = nxt
        st.buf_mask[idx] = 1.0
        st.ptr = (st.ptr + n) % size
        st.size = min(st.size + n, size)

    def grad_update(self, st: SACState, idx: Tensor, eps_act: Tensor,
                    eps_next: Tensor) -> Tuple[Tensor, Tensor]:
        """One update on the buffer's transitions ``idx``, the actions'
        noise ``eps_act`` (the actor's step) and ``eps_next`` (the
        target's)."""
        return self._learn(st, self.norm_obs(st, st.buf_obs[idx]),
                           st.buf_act[idx], st.buf_rew[idx],
                           self.norm_obs(st, st.buf_next[idx]),
                           st.buf_mask[idx], eps_act, eps_next)


class CGAC(_SoftActorCritic):
    """CGAC over the FIFO window of the freshest ``window`` env steps of
    ``n_envs`` envs; observations always normalized; no done mask."""

    normalize = True
    auto_alpha = True

    def __init__(self, env, cfg: CGACConfig = CGACConfig(),
                 dtype=torch.float32, device=None):
        super().__init__(env, cfg, lambda: CGACActor(env.nx, env.nu),
                         dtype, device)

    def _make_state(self, **kw) -> CGACState:
        W, N = self.cfg.window, self.cfg.n_envs
        z = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                       device=self.device)
        nx, nu = self.env.nx, self.env.nu
        return CGACState(**kw, buf_obs=z(W, N, nx), buf_act=z(W, N, nu),
                         buf_rew=z(W, N), buf_next=z(W, N, nx), filled=0)

    def warmup_steps(self) -> int:
        return max(1, self.cfg.warmup_steps)

    def batch_high(self, st: CGACState) -> int:
        return st.filled * self.cfg.n_envs

    def _store(self, st: CGACState, obs, act, rew, nxt) -> None:
        roll = lambda buf, new: torch.cat([buf[1:], new[None]], 0)
        st.buf_obs = roll(st.buf_obs, obs)
        st.buf_act = roll(st.buf_act, act)
        st.buf_rew = roll(st.buf_rew, rew)
        st.buf_next = roll(st.buf_next, nxt)
        st.filled = min(st.filled + 1, self.cfg.window)

    def grad_update(self, st: CGACState, flat_idx: Tensor, eps_act: Tensor,
                    eps_next: Tensor) -> Tuple[Tensor, Tensor]:
        """One update on the window's transitions ``flat_idx`` in [0,
        filled·n_envs): the valid steps sit at the window's end, so the
        time index is offset by window − filled."""
        cfg = self.cfg
        t_idx = cfg.window - st.filled + flat_idx // cfg.n_envs
        e_idx = flat_idx % cfg.n_envs
        return self._learn(st, self.norm_obs(st, st.buf_obs[t_idx, e_idx]),
                           st.buf_act[t_idx, e_idx],
                           st.buf_rew[t_idx, e_idx],
                           self.norm_obs(st, st.buf_next[t_idx, e_idx]),
                           None, eps_act, eps_next)


def train_sac(env, cfg: SACConfig = SACConfig(), iters: int = 30_000,
              seed: int = 0, log_every: int = 2_000, eval_rollouts: int = 64,
              ckpt_path: Optional[str] = None, device=None):
    """Train SAC; returns (actor, act_fn), ``act_fn(obs)`` the deterministic
    action (see ``_SoftActorCritic.train``)."""
    return SAC(env, cfg, device=device).train(
        iters, seed, log_every, eval_rollouts, ckpt_path)


def train_cgac(env, cfg: CGACConfig = CGACConfig(), iters: int = 30_000,
               seed: int = 0, log_every: int = 2_000,
               eval_rollouts: int = 64, ckpt_path: Optional[str] = None,
               device=None):
    """Train CGAC; returns (actor, act_fn)."""
    return CGAC(env, cfg, device=device).train(
        iters, seed, log_every, eval_rollouts, ckpt_path)


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    n_envs: int = 64
    rollout_len: int = 128
    epochs: int = 4
    minibatches: int = 8
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    # returns of these envs are O(100) negative; scaling keeps the value
    # loss from drowning the policy gradient early
    reward_scale: float = 0.05


class Transition(NamedTuple):
    obs: Tensor
    action: Tensor
    logp: Tensor
    value: Tensor
    reward: Tensor
    done: Tensor


class PPO:
    """PPO over ``n_envs`` auto-resetting envs: rollouts of ``rollout_len``
    steps (the env takes tanh(a)·high, the log-probability is of the
    unsquashed a), GAE, and ``epochs`` passes of ``minibatches`` permuted
    minibatches through optax.chain(clip_by_global_norm, adam)."""

    def __init__(self, env, cfg: PPOConfig = PPOConfig(),
                 dtype=torch.float32, device=None):
        self.env, self.cfg, self.dtype = env, cfg, dtype
        self.device = resolve_device(device)
        self.act_scale = torch.as_tensor(env.action_space.high, dtype=dtype,
                                         device=self.device)

    def init(self, seed: int) -> Tuple[ActorCritic, Adam]:
        torch.manual_seed(seed)
        net = ActorCritic(self.env.nx, self.env.nu).to(dtype=self.dtype,
                                                        device=self.device)
        return net, Adam(dict(net.named_parameters()), self.cfg.lr)

    @staticmethod
    def policy_sample(net: ActorCritic, obs: Tensor, eps: Tensor):
        mean, log_std, v = net(obs)
        std = torch.exp(log_std)
        a = mean + std * eps
        logp = -0.5 * torch.sum(((a - mean) / std) ** 2 + 2 * log_std
                                + _LOG_2PI, dim=-1)
        return a, logp, v

    @staticmethod
    def logp_of(net: ActorCritic, obs: Tensor, action: Tensor):
        mean, log_std, v = net(obs)
        std = torch.exp(log_std)
        logp = -0.5 * torch.sum(((action - mean) / std) ** 2 + 2 * log_std
                                + _LOG_2PI, dim=-1)
        ent = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        return logp, v, ent

    @torch.no_grad()
    def collect(self, net: ActorCritic, env_state: EnvState, eps: Tensor,
                fresh: Tensor) -> Tuple[EnvState, Transition, Tensor]:
        """``rollout_len`` steps with the action noise ``eps`` [L, n, nu];
        the envs done at step t restart from ``fresh[t]`` [L, n, nx].
        Returns the last state, the stacked transitions and the value of
        the last state."""
        rows = []
        for t in range(self.cfg.rollout_len):
            obs = env_state.x
            a, logp, v = self.policy_sample(net, obs, eps[t])
            env_state, reward, done = self.env.step(
                env_state, torch.tanh(a) * self.act_scale)
            env_state = self.env.reset_where(env_state, done, fresh=fresh[t])
            rows.append(Transition(obs, a, logp, v,
                                   self.cfg.reward_scale * reward,
                                   done.to(torch.float32)))
        traj = Transition(*(torch.stack(v) for v in zip(*rows)))
        return env_state, traj, net(env_state.x)[2]

    def gae(self, traj: Transition, last_v: Tensor
            ) -> Tuple[Tensor, Tensor]:
        """Generalized advantage estimates and returns, a reverse scan."""
        cfg = self.cfg
        adv_next, v_next = torch.zeros_like(last_v), last_v
        advs = []
        for t in reversed(range(traj.reward.shape[0])):
            nonterm = 1.0 - traj.done[t]
            delta = traj.reward[t] + cfg.gamma * v_next * nonterm \
                - traj.value[t]
            adv_next = delta + cfg.gamma * cfg.lam * nonterm * adv_next
            v_next = traj.value[t]
            advs.append(adv_next)
        advs = torch.stack(advs[::-1])
        return advs, advs + traj.value

    def update(self, net: ActorCritic, opt: Adam, traj: Transition,
               advs: Tensor, returns: Tensor, perms: Tensor) -> Tensor:
        """``epochs`` passes over the batch in the orders ``perms``
        [epochs, B], each split into ``minibatches``; advantages normalized
        by their population std. Returns the mean loss."""
        cfg = self.cfg
        B = traj.reward.numel()
        flat = Transition(*(v.reshape((B,) + v.shape[2:]) for v in traj))
        advs = advs.reshape(B)
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        returns = returns.reshape(B)
        names = list(opt.params)
        epoch_losses = []
        for perm in perms:
            losses = []
            for idx in perm.reshape(cfg.minibatches, B // cfg.minibatches):
                logp, v, ent = self.logp_of(net, flat.obs[idx],
                                            flat.action[idx])
                ratio = torch.exp(logp - flat.logp[idx])
                a = advs[idx]
                pg = -torch.minimum(
                    ratio * a,
                    torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * a).mean()
                vf = torch.mean((v - returns[idx]) ** 2)
                loss = pg + cfg.vf_coef * vf - cfg.ent_coef * ent
                grads = dict(zip(names, torch.autograd.grad(
                    loss, [opt.params[k] for k in names])))
                opt.step(clip_by_global_norm(grads, cfg.max_grad_norm,
                                             global_norm(grads)))
                losses.append(loss.detach())
            epoch_losses.append(torch.stack(losses).mean())
        return torch.stack(epoch_losses).mean()

    def iteration(self, net, opt, env_state: EnvState, draws: Draws):
        """Collect, GAE, update; returns (env_state, loss, mean reward of
        the rollout)."""
        cfg, env = self.cfg, self.env
        L, n = cfg.rollout_len, cfg.n_envs
        env_state, traj, last_v = self.collect(
            net, env_state, draws.normal((L, n, env.nu), self.dtype),
            draws.fresh(env, (L, n), self.dtype))
        advs, returns = self.gae(traj, last_v)
        perms = torch.stack([draws.permutation(L * n)
                             for _ in range(cfg.epochs)])
        loss = self.update(net, opt, traj, advs, returns, perms)
        return env_state, loss, traj.reward.mean()


def train_ppo(env, cfg: PPOConfig = PPOConfig(), iters: int = 300,
              seed: int = 0, log_every: int = 20, device=None
              ) -> ActorCritic:
    """Train PPO; returns the network (its mean action is the expert's)."""
    ppo = PPO(env, cfg, device=device)
    draws = Draws(seed, ppo.device)
    net, opt = ppo.init(seed)
    env_state = EnvState.make(draws.fresh(env, (1, cfg.n_envs),
                                          ppo.dtype)[0])
    for i in range(iters):
        env_state, loss, mean_r = ppo.iteration(net, opt, env_state, draws)
        if i % log_every == 0:
            print(f"iter {i:4d} loss {float(loss):+.4f} "
                  f"mean_step_reward {float(mean_r):+.4f}", flush=True)
    return net


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="RL experts (PyTorch port)")
    p.add_argument("--env", type=str, default="pendulum")
    p.add_argument("--algo", type=str, default="ppo",
                   choices=["ppo", "sac", "cgac"])
    p.add_argument("--iters", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_data", type=str, default=None,
                   help="write expert pickle after training")
    p.add_argument("--num_traj", type=int, default=100)
    p.add_argument("--normalize_obs", action="store_true",
                   help="SAC: running mean/std observation normalization "
                        "(CGAC always normalizes)")
    p.add_argument("--reward_scale", type=float, default=1.0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' only when "
                        "asked)")
    return p


def main(argv=None):
    """Train the expert; with --save_data, roll it out and write the
    pickle (and, for SAC and CGAC, the actor's checkpoint beside it).
    Returns the trajectories, or None without --save_data."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    env = make_env(args.env)
    if args.algo == "ppo":
        net = train_ppo(env, iters=args.iters, seed=args.seed, device=device)
        if not args.save_data:
            return None
        trajs = ppo_expert_rollouts(env, net, args.num_traj, device=device)
        save_expert_pickle(args.save_data, trajs)
        print(f"wrote {len(trajs)} expert trajectories to {args.save_data}")
        return trajs
    ckpt = (f"{args.save_data}.{args.algo}_ckpt.msgpack"
            if args.save_data else None)
    if args.algo == "cgac":
        _, act_fn = train_cgac(env, CGACConfig(reward_scale=args.reward_scale),
                               iters=args.iters, seed=args.seed,
                               ckpt_path=ckpt, device=device)
    else:
        _, act_fn = train_sac(env, SACConfig(
            normalize_obs=args.normalize_obs,
            reward_scale=args.reward_scale), iters=args.iters,
            seed=args.seed, ckpt_path=ckpt, device=device)
    if not args.save_data:
        return None
    trajs = sac_expert_rollouts(env, act_fn, args.num_traj, device=device)
    save_expert_pickle(args.save_data, trajs)
    lens = [len(t) for t in trajs]
    print(f"wrote {len(trajs)} expert trajectories (len min/mean/max "
          f"{min(lens)}/{np.mean(lens):.1f}/{max(lens)}) to "
          f"{args.save_data}")
    return trajs


if __name__ == "__main__":
    main()
