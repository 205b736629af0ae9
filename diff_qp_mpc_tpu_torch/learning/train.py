"""The DEQ-MPC trainer's command line and policy factory (port of the
matching parts of diff_qp_mpc_tpu.learning.train). The training loop itself
is not ported yet; ``evaluate`` shares these."""
from __future__ import annotations

import argparse

import numpy as np

from diff_qp_mpc_tpu_torch.learning.policies import DEQMPCPolicy, TrackingMPC
from diff_qp_mpc_tpu_torch.solvers import al_mpc


def build_parser() -> argparse.ArgumentParser:
    """The reference trainer's flags that shape a policy, plus --device."""
    p = argparse.ArgumentParser(description="DEQ-MPC (PyTorch port)")
    p.add_argument("--env", type=str, default="integrator")
    p.add_argument("--stabilization", action="store_true",
                   help="use the env's -stabilize variant")
    p.add_argument("--deq", action="store_true")
    p.add_argument("--deq_iter", type=int, default=6)
    p.add_argument("--T", type=int, default=5)
    p.add_argument("--hdim", type=int, default=128)
    p.add_argument("--solver_type", type=str, default="al")
    p.add_argument("--qp_iter", type=int, default=2,
                   help="AL outer iterations (reference al_iter)")
    p.add_argument("--rho_max", type=float, default=None,
                   help="cap on the AL penalty rho (default: ALConfig's 1e6)")
    p.add_argument("--al_reg", type=float, default=None,
                   help="Levenberg damping for the AL Newton solves "
                        "(default: ALConfig's 1e-7)")
    p.add_argument("--tracking_r", type=float, default=None,
                   help="override the tracking-cost control weight R")
    p.add_argument("--terminal_lqr", action="store_true",
                   help="LQR terminal cost (ip solver path; not ported)")
    p.add_argument("--deq_out_type", type=int, default=1)
    p.add_argument("--layer_type", type=str, default="mlp",
                   choices=["mlp", "conv"])
    p.add_argument("--fused", action="store_true",
                   help="solve the tracking MPC with the fused AL kernel")
    p.add_argument("--solver_carry", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="carry AL warm-start state across successive "
                        "tracking solves. 'auto' = legacy per-path default "
                        "(scan carried, fused fresh)")
    p.add_argument("--ws_mode", type=str, default="proposal",
                   choices=["proposal", "solution"])
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint path (flax msgpack)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--x64", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    return p


def make_policy(args, env) -> DEQMPCPolicy:
    """The DEQ-MPC policy the flags describe (AL solver path)."""
    if getattr(args, "solver_type", "al") != "al":
        raise NotImplementedError("only --solver_type al is ported")
    if getattr(args, "terminal_lqr", False):
        raise NotImplementedError("--terminal_lqr needs the ip solver path")
    if not args.deq:
        raise NotImplementedError("only the DEQ-MPC policy (--deq) is ported")
    R = np.asarray(env.Rlqr, dtype=float)
    if getattr(args, "tracking_r", None) is not None:
        R = np.full_like(R, args.tracking_r)
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
            getattr(args, "solver_carry", "auto")])
    return DEQMPCPolicy(
        nx=env.nx, nu=env.nu, nq=env.nq, T=args.T, hdim=args.hdim,
        dt=env.dt, tracking=tracking, deq_iter=args.deq_iter,
        out_type=args.deq_out_type, layer_type=args.layer_type,
        ws_mode=getattr(args, "ws_mode", "proposal"))
