"""Expert-trajectory generation with the receding-horizon SQP-MPC expert
(port of diff_qp_mpc_tpu.learning.datagen).

Each episode step solves the expert's plan from the current states (the
SQP MPC of ``solvers.sqp_mpc`` over the scan IPM, whose Riccati solves are
kernel K3: ``csrc/riccati.cu`` at T 5, ``csrc/riccati_horizon.cu`` at the
planners' horizons), applies its first action, and shifts the plan one
stage as the next step's warm start. Output is the reference pickle format
(a list of trajectories, each a list of (state, action) float32 numpy
pairs), written by ``data.save_expert_pickle`` to
``data/expert_traj_<expert>-<spec_id>_new.pkl`` unless ``--out`` names a
path. ``--expert ppo|sac`` trains an RL expert instead (``learning.rl``,
float32, ``--ppo_iters`` / ``--sac_iters``) and rolls out its mean action.

The expert computes in float64 by default, as the JAX package's expert
does under x64 (its ``--platform cpu`` route); ``--dtype float32`` is the
counterpart of its TPU run, which is float32. ``--device`` defaults to the
card; ``--device cpu`` runs the kernels' plain PyTorch versions.

Usage:
    python -m diff_qp_mpc_tpu_torch.learning.datagen --env cartpole2link \\
        --stabilization --num_traj 200 --max_steps 120 --init_scale 4 \\
        --no_success_term --out build/expert_cp2.pkl [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost, QuadCost
from diff_qp_mpc_tpu_torch.envs import EnvState, make_env
from diff_qp_mpc_tpu_torch.learning import rl
from diff_qp_mpc_tpu_torch.learning.data import save_expert_pickle
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc
from diff_qp_mpc_tpu_torch.solvers.lqr import terminal_value_cost
from diff_qp_mpc_tpu_torch.solvers.sqp_mpc import SQPConfig
from diff_qp_mpc_tpu_torch.utils.device import resolve_device

# Per-env expert planner settings, in this repo's state conventions
# (cartpole upright at θ = π), as the JAX package's table sets them.
# "terminal_lqr": the DARE value-function terminal cost (solvers/lqr.py),
# which lets the cp2 stabilize expert lock in at T 10 without the
# multi-radian excursions of its T 60 plans. u_goal "hover": the control
# penalty centered at the hover thrust, not 0, so the quadrotor's plans do
# not trade altitude for thrust.
EXPERT_PLANNER = {
    "Cartpole1l-v0": dict(T=80, Q=(1.0, 10.0, 1.0, 1.0), R=(1e-4,),
                          qp_iter=6, max_ls=5),
    "Cartpole1l-v0-stabilize": dict(T=60, Q=(1.0, 10.0, 1.0, 1.0), R=(1e-4,),
                                    qp_iter=10),
    "Cartpole2l-v0": dict(T=120, Q=(1.0, 10.0, 10.0, 1.0, 1.0, 1.0),
                          R=(1e-4,), qp_iter=12),
    "Cartpole2l-v0-stabilize": dict(T=10, Q=(1.0,) * 6, R=(0.01,),
                                    qp_iter=4, terminal_lqr=True),
    "Pendulum-v0": dict(T=40, Q=(10.0, 1.0), R=(1e-3,), qp_iter=10),
    "Pendulum-v0-stabilize": dict(T=20, Q=(10.0, 1.0), R=(1e-3,), qp_iter=5),
    "RexQuadrotor-v0": dict(T=20, Q=(10.0,) * 3 + (1.0,) * 9, R=(0.1,) * 4,
                            qp_iter=5, u_goal="hover"),
}

# Per-coordinate half-widths of the capture-corridor box of initial states
# around env.goal (--capture): poles near upright at the velocities a
# swing-up arrives with, the corner where closed-loop swing-up policies
# fail to lock in.
CAPTURE_BOX = {
    "Pendulum": (0.5, 2.0),
    "Cartpole1l": (1.0, 0.4, 2.0, 3.0),
    "Cartpole2l": (0.8, 0.3, 0.3, 1.5, 2.0, 2.0),
}


def planner_settings(env, T: int = 30, qp_iter: int = 5) -> dict:
    """The expert's planner for ``env``: EXPERT_PLANNER's entry overriding
    T and qp_iter (and the env's LQR weights), keyed by the env's spec
    id."""
    planner = dict(EXPERT_PLANNER.get(env.spec_id, {}))
    planner.setdefault("T", T)
    planner.setdefault("qp_iter", qp_iter)
    planner.setdefault("Q", tuple(float(v) for v in env.Qlqr))
    planner.setdefault("R", tuple(float(v) for v in env.Rlqr))
    planner.setdefault("max_ls", 10)
    return planner


def expert_cost(env, planner: dict, bsz: int, dtype=torch.float64,
                device=None):
    """The expert's tracking cost toward (goal, u_goal) over the planner's
    horizon: diag(Q, R), with the terminal value cost's P added to the
    last stage's state block where the planner asks for it (a dense
    QuadCost then); c = −C·(goal, u_goal)."""
    model, nx, nu, T = env.model, env.nx, env.nu, planner["T"]
    kw = dict(dtype=torch.float64, device=device)
    Cd = torch.tensor(planner["Q"] + planner["R"], **kw)
    goal = torch.as_tensor(np.asarray(getattr(env, "goal", np.zeros(nx)),
                                      np.float64), **kw)
    u_goal = (model.hover_thrust().to(**kw)
              if planner.get("u_goal") == "hover"
              else torch.zeros(nu, **kw))
    xu_goal = torch.cat([goal, u_goal])
    if planner.get("terminal_lqr"):
        P = terminal_value_cost(model, goal,
                                u_goal if planner.get("u_goal") else None,
                                planner["Q"], planner["R"])
        C = torch.diag(Cd).expand(bsz, T, nx + nu, nx + nu).clone()
        C[:, -1, :nx, :nx] += P.to(**kw)
        return QuadCost(C=C.to(dtype), c=(-(C @ xu_goal)).to(dtype))
    return DiagQuadCost(Cd=Cd.expand(bsz, T, nx + nu).to(dtype),
                        c=(-Cd * xu_goal).expand(bsz, T, nx + nu).to(dtype))


def mpc_expert_rollouts(env, num_traj: int, T: int = 30,
                        max_steps: int = 200, seed: int = 0,
                        qp_iter: int = 5, success_filter: bool = False,
                        init_states=None, dtype=torch.float64, device=None,
                        on_step=None):
    """Batched receding-horizon SQP-MPC expert rollouts.

    The planner comes from EXPERT_PLANNER where the env has an entry
    (overriding T, qp_iter and the env's LQR weights). Initial states are
    the env's reset draw from ``torch.Generator`` seeded by ``seed``, or
    ``init_states`` [N, nx] (DAgger relabeling, the capture corridor).
    With ``success_filter``, twice the batch is rolled out (or the caller
    passes twice the states it wants kept) and the trajectories whose last
    state passes env._success are kept, topped up with failures if too
    few. Each trajectory ends at its first done step. ``on_step`` is called
    after every MPC step with the step's index. Returns the list of
    trajectories, each a list of (state, action) float32 numpy pairs."""
    device = resolve_device(device)
    planner = planner_settings(env, T, qp_iter)
    T = planner["T"]
    if init_states is not None:
        bsz = len(init_states)
        num_traj = bsz // 2 if success_filter else bsz
    else:
        bsz = 2 * num_traj if success_filter else num_traj
    cost = expert_cost(env, planner, bsz, dtype, device)
    bounds = Bounds(
        u_lo=torch.as_tensor(env.action_space.low, dtype=dtype,
                             device=device),
        u_hi=torch.as_tensor(env.action_space.high, dtype=dtype,
                             device=device))
    cfg = SQPConfig(qp_iter=planner["qp_iter"], max_ls=planner["max_ls"])

    if init_states is None:
        state = env.reset(torch.Generator().manual_seed(seed), bsz,
                          dtype=dtype, device=device)
    else:
        state = EnvState.make(torch.as_tensor(
            np.asarray(init_states), dtype=dtype, device=device))
    u_ws = torch.zeros(bsz, T, env.nu, dtype=dtype, device=device)

    xs, us, dones = [], [], []
    done_seen = torch.zeros(bsz, dtype=torch.bool, device=device)
    for step in range(max_steps):
        x = state.x
        with torch.no_grad():
            u_plan = sqp_mpc.solve(env.model, cost, x, bounds, u_ws,
                                   cfg=cfg, differentiable=False).u
        u0 = u_plan[:, 0]
        xs.append(x.cpu().numpy().astype(np.float32))
        us.append(u0.cpu().numpy().astype(np.float32))
        state, _, done = env.step(state, u0)
        done_seen = done_seen | done
        dones.append(done_seen.cpu().numpy())
        u_ws = torch.cat([u_plan[:, 1:], u_plan[:, -1:]], dim=1)
        if on_step is not None:
            on_step(step)
        if bool(dones[-1].all()):
            break

    # split the batch into trajectories, each truncated at its first done
    trajs, succ = [], []
    steps = len(xs)
    for b in range(bsz):
        end = next((t + 1 for t in range(steps) if dones[t][b]), steps)
        trajs.append([(xs[t][b], us[t][b]) for t in range(end)])
        succ.append(bool(env._success(torch.as_tensor(xs[end - 1][b]))))
    if success_filter:
        good = [t for t, s in zip(trajs, succ) if s]
        print(f"success filter: {len(good)}/{bsz} trajectories reached goal")
        if len(good) < num_traj:
            rest = [t for t, s in zip(trajs, succ) if not s]
            good = good + rest[: num_traj - len(good)]
        return good[:num_traj]
    return trajs


def capture_init_states(env, n: int, seed: int,
                        box: Optional[np.ndarray] = None) -> np.ndarray:
    """``n`` initial states uniform in the capture box around env.goal
    (CAPTURE_BOX's entry unless ``box`` is given), from
    ``np.random.RandomState(seed)``."""
    if box is None:
        box = np.asarray(CAPTURE_BOX[env.spec_id.split("-v0")[0]])
    goal = np.asarray(env.goal)
    rng = np.random.RandomState(seed)
    return goal + rng.uniform(-box, box, size=(n, env.nx))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MPC expert datasets (PyTorch "
                                            "port)")
    p.add_argument("--env", type=str, default="integrator")
    p.add_argument("--num_traj", type=int, default=100)
    p.add_argument("--T", type=int, default=30,
                   help="planner horizon where EXPERT_PLANNER has none")
    p.add_argument("--max_steps", type=int, default=200)
    p.add_argument("--qp_iter", type=int, default=5,
                   help="SQP iterations where EXPERT_PLANNER has none")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--stabilization", action="store_true")
    p.add_argument("--init_scale", type=float, default=None,
                   help="widen the env's initial-state box (stabilize-data"
                        " basin coverage)")
    p.add_argument("--no_success_term", action="store_true",
                   help="run episodes to the step limit after the success "
                        "streak (goal-holding tails)")
    p.add_argument("--expert", type=str, default="mpc",
                   choices=["mpc", "ppo", "sac"],
                   help="mpc: receding-horizon SQP expert; ppo/sac: train an"
                        " RL expert first (learning.rl), then roll it out")
    p.add_argument("--ppo_iters", type=int, default=500)
    p.add_argument("--sac_iters", type=int, default=40000)
    p.add_argument("--success_filter", action="store_true",
                   help="roll out twice the batch and keep the "
                        "trajectories that reach the goal")
    p.add_argument("--capture", action="store_true",
                   help="initial states from a per-coordinate capture box "
                        "around the goal instead of the env's reset box")
    p.add_argument("--capture_box", type=str, default=None,
                   help="comma-separated half-widths of the capture box "
                        "(default: CAPTURE_BOX's entry for the env)")
    p.add_argument("--dtype", type=str, default="float64",
                   choices=["float64", "float32"],
                   help="the expert's arithmetic: float64 (the JAX "
                        "expert under x64) or float32 (its TPU run)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain PyTorch versions)")
    return p


def main(argv=None, on_step=None):
    """Generate and write an expert dataset (the MPC expert's, or an RL
    expert's trained by ``learning.rl`` and rolled out); returns the
    trajectories. ``on_step`` is passed to ``mpc_expert_rollouts``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    kwargs = {}
    if args.stabilization:
        kwargs["stabilization"] = True
    if args.init_scale is not None:
        kwargs["init_scale"] = args.init_scale
    env = make_env(args.env, **kwargs)
    if args.no_success_term:
        env.terminate_on_success = False
    if args.expert == "ppo":
        net = rl.train_ppo(env, iters=args.ppo_iters, seed=args.seed,
                           device=device)
        trajs = rl.ppo_expert_rollouts(env, net, args.num_traj,
                                       args.max_steps, args.seed,
                                       device=device)
    elif args.expert == "sac":
        _, act = rl.train_sac(env, rl.SACConfig(), iters=args.sac_iters,
                              seed=args.seed, device=device)
        trajs = rl.sac_expert_rollouts(env, act, args.num_traj,
                                       args.max_steps, args.seed,
                                       device=device)
    else:
        init = None
        if args.capture:
            box = (np.array([float(v) for v in args.capture_box.split(",")])
                   if args.capture_box is not None else None)
            n_init = (2 * args.num_traj if args.success_filter
                      else args.num_traj)
            init = capture_init_states(env, n_init, args.seed, box)
        trajs = mpc_expert_rollouts(
            env, args.num_traj, args.T, args.max_steps, args.seed,
            args.qp_iter, success_filter=args.success_filter,
            init_states=init, dtype=dtype, device=device, on_step=on_step)
    suffix = "-capture" if args.capture else ""
    out = args.out or os.path.join(
        "data", f"expert_traj_{args.expert}-{env.spec_id}{suffix}_new.pkl")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_expert_pickle(out, trajs)
    lens = [len(t) for t in trajs]
    print(f"wrote {len(trajs)} trajectories (len min/mean/max "
          f"{min(lens)}/{np.mean(lens):.1f}/{max(lens)}) to {out}")
    return trajs


if __name__ == "__main__":
    main()
