"""DEQ-MPC imitation-learning trainer (port of
diff_qp_mpc_tpu.learning.train).

Same flags as the JAX trainer, with ``--device`` (default cuda; ``cpu`` only
when asked) in place of ``--platform``. A training step: observation noise,
input noise, the loss by phase (the raw DEQ proposals while pretraining,
the MPC-projected iterates after), the gradient through the tracking
solves' implicit backwards, its global norm, a skip of the whole update on
a non-finite norm, then optax's ``clip_by_global_norm`` and ``adam`` (with
optax's cosine schedule under ``--lr_decay``), written out by hand. Batches
come from ``np.random.RandomState(seed)`` in the JAX trainer's order;
metrics go to ``<logdir>/<name>/metrics.jsonl`` and checkpoints to
``ckpt.msgpack`` / ``ckpt_best.msgpack`` beside it, in the JAX trainer's
layout (``utils.checkpoint``).

Usage:
    python -m diff_qp_mpc_tpu_torch.learning.train --env pendulum --deq \\
        --deq_iter 6 --bsz 256 --T 5 --qp_solve --fused --pretrain \\
        --deq_out_type 2 --policy_out_type 2 --expert_type sac \\
        --grad_clip 10 --iters 8000 --save [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import data as data_mod
from diff_qp_mpc_tpu_torch.learning import losses as losses_mod
from diff_qp_mpc_tpu_torch.learning import noise as noise_mod
from diff_qp_mpc_tpu_torch.learning.policies import DEQMPCPolicy, TrackingMPC
from diff_qp_mpc_tpu_torch.solvers import al_mpc
from diff_qp_mpc_tpu_torch.solvers.lqr import terminal_value_cost
from diff_qp_mpc_tpu_torch.solvers.sqp_mpc import SQPConfig
from diff_qp_mpc_tpu_torch.solvers.trajqp import TrajQPConfig
from diff_qp_mpc_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from diff_qp_mpc_tpu_torch.utils.device import resolve_device
from diff_qp_mpc_tpu_torch.utils.metrics import MetricsWriter

Tensor = torch.Tensor


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags, in its order, with --device in place of
    --platform (evaluate adds its own)."""
    p = argparse.ArgumentParser(description="DEQ-MPC imitation learning "
                                            "(PyTorch port)")
    p.add_argument("--env", type=str, default="integrator")
    p.add_argument("--stabilization", action="store_true",
                   help="use the env's -stabilize variant")
    p.add_argument("--deq", action="store_true")
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--bsz", type=int, default=256)
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--hdim", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_decay", action="store_true",
                   help="cosine-decay the lr to 10%% of --lr over --iters")
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="global-norm gradient clip (0 = off)")
    p.add_argument("--iters", type=int, default=20000)
    p.add_argument("--solver_type", type=str, default="al",
                   choices=["al", "ip"],
                   help="tracking MPC: augmented Lagrangian or the "
                        "interior-point SQP")
    p.add_argument("--qp_solve", action="store_true")
    p.add_argument("--lastqp_solve", action="store_true")
    p.add_argument("--pretrain", action="store_true")
    p.add_argument("--pretrain_iters", type=int, default=1000)
    p.add_argument("--qp_iter", type=int, default=2,
                   help="AL outer iterations (reference al_iter); SQP "
                        "iterations on the ip path")
    p.add_argument("--rho_max", type=float, default=None,
                   help="cap on the AL penalty rho (default: ALConfig's 1e6)")
    p.add_argument("--al_reg", type=float, default=None,
                   help="Levenberg damping for the AL Newton solves "
                        "(default: ALConfig's 1e-7)")
    p.add_argument("--tracking_r", type=float, default=None,
                   help="override the tracking-cost control weight R")
    p.add_argument("--terminal_lqr", action="store_true",
                   help="DARE terminal value cost at the goal "
                        "(solvers/lqr.py; ip solver path only)")
    p.add_argument("--deq_out_type", type=int, default=1)
    p.add_argument("--layer_type", type=str, default="mlp",
                   choices=["mlp", "conv"])
    p.add_argument("--fused", action="store_true",
                   help="solve the tracking MPC with the fused kernel (AL: "
                        "K2; ip: the whole trajectory-QP IPM, K4)")
    p.add_argument("--solver_carry", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="carry AL warm-start state across successive "
                        "tracking solves. 'auto' = legacy per-path default "
                        "(scan carried, fused fresh)")
    p.add_argument("--policy_out_type", type=int, default=1)
    p.add_argument("--data_noise_type", type=int, default=0)
    p.add_argument("--data_noise_std", type=float, default=0.0)
    p.add_argument("--data_noise_mean", type=float, default=0.0)
    p.add_argument("--action_weight", type=float, default=0.0,
                   help="weight on a scale-normalized action L1 added to "
                        "state-only supervision (out_type 1/3)")
    p.add_argument("--input_noise_std", type=float, default=0.0,
                   help="Gaussian noise std added to the policy input x0 "
                        "only (supervision stays clean)")
    p.add_argument("--ws_mode", type=str, default="proposal",
                   choices=["proposal", "solution"])
    p.add_argument("--unwrap_angles", type=str, default="none",
                   choices=["none", "pendulum", "cartpole"],
                   help="phase-align wrapped angles in each sampled window")
    p.add_argument("--data", type=str, default=None,
                   help="expert pickle path (default: data/expert_traj_*)")
    p.add_argument("--expert_type", type=str, default="mpc")
    p.add_argument("--name", type=str, default=None)
    p.add_argument("--load", action="store_true",
                   help="resume params and optimizer from --ckpt")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint path (default: "
                        "<logdir>/<name>/ckpt.msgpack)")
    p.add_argument("--save", action="store_true")
    p.add_argument("--logdir", type=str, default="./logs")
    p.add_argument("--ckpt_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--x64", action="store_true")
    return p


def make_policy(args, env) -> DEQMPCPolicy:
    """The DEQ-MPC policy the flags describe."""
    solver_type = getattr(args, "solver_type", "al")
    if solver_type not in ("al", "ip"):
        raise ValueError(f"--solver_type must be 'al' or 'ip', got "
                         f"{solver_type!r}")
    if not args.deq:
        raise NotImplementedError("only the DEQ-MPC policy (--deq) is ported")
    R = np.asarray(env.Rlqr, dtype=float)
    if getattr(args, "tracking_r", None) is not None:
        R = np.full_like(R, args.tracking_r)
    terminal_P = None
    if getattr(args, "terminal_lqr", False):
        u_goal = (env.model.hover_thrust()
                  if hasattr(env.model, "hover_thrust") else None)
        P = terminal_value_cost(env.model,
                                getattr(env, "goal", np.zeros(env.nx)),
                                u_goal, np.asarray(env.Qlqr), R)
        terminal_P = tuple(tuple(float(v) for v in row) for row in P)
    cfg = al_mpc.ALConfig(al_iter=args.qp_iter, **{
        k: v for k, v in (("rho_max", getattr(args, "rho_max", None)),
                          ("reg", getattr(args, "al_reg", None)))
        if v is not None})
    tracking = TrackingMPC(
        model=env.model, T=args.T,
        Q=tuple(float(v) for v in np.asarray(env.Qlqr)),
        R=tuple(float(v) for v in R),
        u_lo=tuple(float(v) for v in env.action_space.low),
        u_hi=tuple(float(v) for v in env.action_space.high),
        cfg=cfg, use_fused=getattr(args, "fused", False),
        carry_state={"auto": None, "on": True, "off": False}[
            getattr(args, "solver_carry", "auto")],
        solver_type=solver_type,
        # --fused on the ip path runs the whole IPM as kernel K4, otherwise
        # the scan IPM over kernel K3
        sqp_cfg=SQPConfig(qp_iter=args.qp_iter, qp=TrajQPConfig(
            kernel="fused" if solver_type == "ip" and getattr(
                args, "fused", False) else "scan")),
        terminal_P=terminal_P)
    return DEQMPCPolicy(
        nx=env.nx, nu=env.nu, nq=env.nq, T=args.T, hdim=args.hdim,
        dt=env.dt, tracking=tracking, deq_iter=args.deq_iter,
        out_type=args.deq_out_type, layer_type=args.layer_type,
        ws_mode=getattr(args, "ws_mode", "proposal"))


# ---------------------------------------------------------------------------
# optax's transformations, by hand
# ---------------------------------------------------------------------------


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.1
                 ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha): lr·((1−α)·½(1 +
    cos(π·min(t, decay_steps)/decay_steps)) + α) at update count t."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t
                                                       / decay_steps))
                     + alpha)

    return schedule


def global_norm(grads: Dict[str, Tensor]) -> Tensor:
    """optax.global_norm: the 2-norm of all leaves together."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float,
                        norm: Tensor) -> Dict[str, Tensor]:
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else each
    leaf (g / norm)·max_norm."""
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm) * max_norm for k, g in grads.items()}


class Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected moments, on named parameters; ``lr`` is a float or a
    schedule of the update count (optax evaluates it at the count before
    the update). ``step`` updates the parameters in place."""

    def __init__(self, params: Dict[str, Tensor],
                 lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> None:
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            p -= lr * ((self.mu[k] / c1)
                       / (torch.sqrt(self.nu[k] / c2) + self.eps))

    def state_dict(self) -> Dict:
        """The checkpoint's ``opt_state``: the update count and both
        moments, numpy leaves keyed by parameter name."""
        as_np = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}
        return {"count": self.count, "mu": as_np(self.mu),
                "nu": as_np(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for k, p in self.params.items():
                moments[k] = torch.tensor(state[name][k]).to(p)


# ---------------------------------------------------------------------------
# the training step and loop
# ---------------------------------------------------------------------------


def compute_loss(policy: DEQMPCPolicy, args, batch: Dict[str, Tensor],
                 qp_solve: bool, generator: torch.Generator):
    """(loss, loss_end, dyn_res) of one batch: observation noise on the
    states, input noise on x0, then the DEQ loss on the raw proposals
    (pretraining) or the DEQ-MPC loss on the projected iterates."""
    gt_states = noise_mod.corrupt_observation(
        generator, batch["state"], args.data_noise_type,
        args.data_noise_std, args.data_noise_mean)
    gt_actions, gt_mask = batch["action"], batch["mask"]
    x0 = gt_states[:, 0]
    if args.input_noise_std > 0:
        x0 = x0 + args.input_noise_std * torch.randn(
            x0.shape, generator=generator, dtype=x0.dtype).to(x0.device)
    iterates, dyn_res = policy(x0, qp_solve=qp_solve,
                               lastqp_solve=args.lastqp_solve)
    if qp_solve:
        loss, loss_end = losses_mod.compute_loss_deqmpc(
            args.policy_out_type, gt_states, gt_actions, gt_mask, iterates,
            action_weight=args.action_weight)
    else:
        loss, loss_end = losses_mod.compute_loss_deq(
            gt_states, gt_actions, gt_mask, iterates)
    return loss, loss_end, dyn_res


def make_train_step(policy: DEQMPCPolicy, optimizer: Adam, args,
                    generator: torch.Generator):
    """step(batch, qp_solve) -> (loss, loss_end, dyn_res, grad_norm), the
    parameters and ``optimizer`` updated in place. On a non-finite gradient
    norm the whole update is skipped, Adam's moments and count included."""
    params = optimizer.params

    def step(batch: Dict[str, Tensor], qp_solve: bool):
        loss, loss_end, dyn_res = compute_loss(policy, args, batch,
                                               qp_solve, generator)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        gnorm = global_norm(grads)
        if bool(torch.isfinite(gnorm)):
            if args.grad_clip > 0:
                grads = clip_by_global_norm(grads, args.grad_clip, gnorm)
            optimizer.step(grads)
        return loss.detach(), loss_end.detach(), dyn_res.detach(), gnorm

    return step


def default_data_path(args, env) -> str:
    return os.path.join(
        "data", f"expert_traj_{args.expert_type}-{env.spec_id}_new.pkl")


def to_batch(batch: Dict[str, np.ndarray], device, dtype
             ) -> Dict[str, Tensor]:
    return {k: torch.as_tensor(v).to(device=device, dtype=dtype)
            for k, v in batch.items()}


class _Training(NamedTuple):
    env: Any
    dataset: Dict[str, np.ndarray]
    policy: DEQMPCPolicy
    optimizer: Adam
    step: Callable  # make_train_step's
    rng: np.random.RandomState  # the batches'
    generator: torch.Generator  # the noise's
    device: torch.device
    dtype: torch.dtype


def _setup(args) -> _Training:
    """Everything a training run of ``args`` needs, resumed from the
    checkpoint under ``--load``. One batch is drawn and dropped, as the JAX
    trainer draws one to initialize its parameters, so that the batches
    that follow are the JAX trainer's."""
    if not args.deq:
        raise NotImplementedError("only the DEQ-MPC policy (--deq) is "
                                  "ported")
    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    env = make_env(args.env, **({"stabilization": True}
                                if args.stabilization else {}))
    data_path = args.data or default_data_path(args, env)
    dataset = data_mod.load_expert_pickle(data_path)
    print(f"loaded {len(dataset['state'])} steps from {data_path}")
    torch.manual_seed(args.seed)
    policy = make_policy(args, env).to(device=device, dtype=dtype)
    rng = np.random.RandomState(args.seed)
    data_mod.sample_window_batch(dataset, args.bsz, args.T, rng)
    lr = cosine_decay(args.lr, args.iters) if args.lr_decay else args.lr
    optimizer = Adam(dict(policy.named_parameters()), lr)
    if args.load:
        path = args.ckpt or os.path.join(args.logdir, run_name(args),
                                         "ckpt.msgpack")
        state, opt_state = load_checkpoint(path)
        policy.load_state_dict(state)
        optimizer.load_state_dict(opt_state)
        print(f"resumed params+optimizer from {path}")
    generator = torch.Generator().manual_seed(args.seed)
    step = make_train_step(policy, optimizer, args, generator)
    return _Training(env, dataset, policy, optimizer, step, rng, generator,
                     device, dtype)


def run_name(args) -> str:
    return args.name or (f"{'deqmpc' if args.deq else 'bc'}_{args.env}"
                         f"_T{args.T}_bsz{args.bsz}_deq_iter{args.deq_iter}")


def _next_batch(dataset, args, rng, device, dtype) -> Dict[str, Tensor]:
    batch = data_mod.sample_window_batch(dataset, args.bsz, args.T, rng)
    if args.unwrap_angles != "none":
        batch["state"] = data_mod.unwrap_window_angles(batch["state"],
                                                       args.unwrap_angles)
    return to_batch(batch, device, dtype)


def main(argv=None, on_step: Optional[Callable[[dict], None]] = None):
    """Train; returns the policy. ``on_step`` is called after every step
    with its record (iteration, phase, loss, loss_end, dyn_res, grad_norm,
    ms)."""
    args = build_parser().parse_args(argv)
    run = _setup(args)
    logdir = os.path.join(args.logdir, run_name(args))
    writer = MetricsWriter(logdir)
    losses, losses_end, dyn_resids, times = [], [], [], []
    best_loss_end = float("inf")
    for i in range(args.iters):
        batch = _next_batch(run.dataset, args, run.rng, run.device,
                            run.dtype)
        qp_solve = args.qp_solve and not (args.pretrain
                                          and i < args.pretrain_iters)
        t0 = time.perf_counter()
        loss, loss_end, dyn_res, gnorm = run.step(batch, qp_solve)
        loss = float(loss)  # waits for the step's work on the device
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        losses_end.append(float(loss_end))
        dyn_resids.append(float(dyn_res))
        mode = "deqmpc" if qp_solve else "deq"
        if on_step is not None:
            on_step(dict(iter=i, mode=mode, loss=loss,
                         loss_end=losses_end[-1], dyn_res=dyn_resids[-1],
                         grad_norm=float(gnorm), ms=times[-1] * 1e3))
        if i % args.ckpt_every == 0:
            print(f"iter {i} [{mode}] loss "
                  f"{np.mean(losses) / max(args.deq_iter, 1):.4f} "
                  f"loss_end {np.mean(losses_end):.4f} dyn_res "
                  f"{np.mean(dyn_resids):.4f} step_time "
                  f"{np.mean(times) * 1e3:.1f}ms grad_norm "
                  f"{float(gnorm):.2f}", flush=True)
            writer.scalar("losses/loss_avg",
                          np.mean(losses) / max(args.deq_iter, 1), i)
            writer.scalar("losses/loss_end", np.mean(losses_end), i)
            writer.scalar("stats/dyn_res", np.mean(dyn_resids), i)
            writer.scalar("stats/step_time_ms", np.mean(times) * 1e3, i)
            if args.save:
                meta = vars(args)
                save_checkpoint(os.path.join(logdir, "ckpt.msgpack"),
                                run.policy.state_dict(),
                                run.optimizer.state_dict(), meta=meta)
                # keep the best window's parameters; skip the pretrain ->
                # DEQ-MPC boundary window, whose average still mixes the
                # (much smaller) pretrain losses
                first_full = (args.pretrain_iters if args.pretrain else 0) \
                    + args.ckpt_every
                if qp_solve and i >= first_full and \
                        np.mean(losses_end) < best_loss_end:
                    best_loss_end = float(np.mean(losses_end))
                    save_checkpoint(os.path.join(logdir,
                                                 "ckpt_best.msgpack"),
                                    run.policy.state_dict(),
                                    run.optimizer.state_dict(), meta=meta)
            losses, losses_end, dyn_resids, times = [], [], [], []
    writer.close()
    return run.policy


if __name__ == "__main__":
    main()
