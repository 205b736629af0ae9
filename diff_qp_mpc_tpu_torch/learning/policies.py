"""DEQ-MPC policy: an equilibrium network interleaved with the tracking MPC
(port of diff_qp_mpc_tpu.learning.policies; AL and ip tracking solvers),
and the feedforward baseline NNMPCPolicy.

The DEQ cell proposes a reference trajectory, the tracking MPC projects it
onto the dynamics, and the solution feeds the next equilibrium iteration.
Solver warm-start state is explicit and reinitialized per forward.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from diff_qp_mpc_tpu_torch.core.types import (
    ALState,
    Bounds,
    DiagQuadCost,
    QuadCost,
)
from diff_qp_mpc_tpu_torch.learning.deq import (
    DEQLayer,
    FFDNetwork,
    Modules,
    prefixed,
)
from diff_qp_mpc_tpu_torch.models.base import DynamicsModel
from diff_qp_mpc_tpu_torch.solvers import al_mpc, sqp_mpc

Tensor = torch.Tensor


@dataclasses.dataclass
class TrackingMPC:
    """Diagonal-cost tracking MPC: Cd = diag(Q, R), c = −Cd·τ_ref.

    ``solver_type`` "al" solves it with the box-constrained AL solver (scan
    path, or kernel K2 with ``use_fused``); "ip" with the interior-point SQP
    solver ``solvers.sqp_mpc`` (scan IPM over kernel K3, or kernel K4 when
    ``sqp_cfg.qp.kernel`` is "fused"). ``terminal_P`` (ip only) adds the
    dense terminal value cost x_Tᵀ P x_T about the terminal reference
    (``solvers.lqr.terminal_value_cost``).
    """

    model: DynamicsModel
    T: int
    Q: Tuple[float, ...]  # per-state weights (nx)
    R: Tuple[float, ...]  # per-control weights (nu)
    u_lo: Tuple[float, ...]
    u_hi: Tuple[float, ...]
    cfg: al_mpc.ALConfig = dataclasses.field(default_factory=al_mpc.ALConfig)
    use_fused: bool = False
    # Warm-start carry across successive solves. None: the legacy per-path
    # default (scan carried, fused fresh), kept so old checkpoints evaluate
    # with the operator they were trained with. True/False apply to both
    # paths.
    carry_state: Optional[bool] = None
    solver_type: str = "al"  # "al" | "ip"
    sqp_cfg: sqp_mpc.SQPConfig = sqp_mpc.SQPConfig(qp_iter=2)
    # the terminal value cost's P as a tuple of row tuples (hashable, as
    # the JAX package's frozen-dataclass attribute), or None. The AL
    # solvers' cost is diagonal, so only the ip path takes it.
    terminal_P: Optional[Tuple[Tuple[float, ...], ...]] = None

    @property
    def carry(self) -> bool:
        if self.carry_state is None:
            return not self.use_fused
        return self.carry_state

    def bounds(self, like: Tensor) -> Bounds:
        kw = dict(dtype=like.dtype, device=like.device)
        return Bounds(u_lo=torch.tensor(self.u_lo, **kw),
                      u_hi=torch.tensor(self.u_hi, **kw))

    def cost(self, xu_ref: Tensor) -> DiagQuadCost:
        bsz, T, n = xu_ref.shape
        Cd = torch.tensor(self.Q + self.R, dtype=xu_ref.dtype,
                          device=xu_ref.device).expand(bsz, T, n)
        return DiagQuadCost(Cd=Cd, c=-Cd * xu_ref)

    def cost_with_terminal(self, xu_ref: Tensor) -> QuadCost:
        """The dense tracking cost with P added to the last stage's state
        block; c = −C·τ_ref, so each stage's minimum is still the
        reference."""
        bsz, T, n = xu_ref.shape
        nx = self.model.nx
        kw = dict(dtype=xu_ref.dtype, device=xu_ref.device)
        C = torch.diag(torch.tensor(self.Q + self.R, **kw)).expand(
            bsz, T, n, n).clone()
        C[:, -1, :nx, :nx] += torch.tensor(self.terminal_P, **kw)
        return QuadCost(C=C, c=-(C @ xu_ref[..., None])[..., 0])

    def init_state(self, bsz: int, dtype=torch.float32, device=None
                   ) -> ALState:
        return ALState.init(bsz, self.T, self.model.nx, self.model.nu,
                            hist_len=self.cfg.al_iter + 1, dtype=dtype,
                            device=device)

    def solve(self, x0: Tensor, x_ref: Tensor, u_ref: Tensor, state: ALState,
              x_init: Optional[Tensor] = None,
              u_init: Optional[Tensor] = None):
        """Returns (x, u, new_state, diagnostics): the AL stats or residual,
        or the last QP residual on the ip path."""
        xu_ref = torch.cat([x_ref, u_ref], dim=-1)
        if self.terminal_P is not None and self.solver_type != "ip":
            raise NotImplementedError(
                "terminal_P needs the dense-cost ip (trajectory-QP) path; "
                "the AL solvers' cost is diagonal by construction")
        cost = (self.cost_with_terminal(xu_ref)
                if self.terminal_P is not None else self.cost(xu_ref))
        if self.solver_type == "ip":
            # the fused trajectory-QP kernel takes the box as python floats
            ip_bounds = (Bounds(u_lo=self.u_lo, u_hi=self.u_hi)
                         if self.sqp_cfg.qp.kernel == "fused"
                         else self.bounds(x0))
            res = sqp_mpc.solve(
                self.model, cost, x0, ip_bounds,
                u_init=u_init if u_init is not None else u_ref,
                x_init=x_init, cfg=self.sqp_cfg, differentiable=True)
            return res.x, res.u, state, res.qp_resid
        if self.use_fused:
            bounds = Bounds(u_lo=self.u_lo, u_hi=self.u_hi)
            if self.carry:
                return al_mpc.solve_fused_stateful(
                    self.model, cost, x0, bounds, state, self.cfg,
                    x_init=x_init, u_init=u_init)
            x, u, res = al_mpc.solve_fused(self.model, cost, x0, bounds,
                                           self.cfg, x_init=x_init,
                                           u_init=u_init)
            return x, u, state, res
        if not self.carry:
            # fresh-state scan solve: the fused fresh-λ operator
            state = self.init_state(x0.shape[0], x0.dtype, x0.device)
        return al_mpc.solve(self.model, cost, x0, self.bounds(x0), state,
                            self.cfg, x_init=x_init, u_init=u_init)


class DEQMPCRollout(NamedTuple):
    """One DEQ-MPC iterate."""

    net_states: Tensor  # [bsz, T, nx] network proposal
    states: Tensor  # [bsz, T, nx] MPC-projected states
    actions: Tensor  # [bsz, T, nu] MPC actions


class DEQMPCPolicy(nn.Module):
    """forward(x, qp_solve, lastqp_solve) -> (iterates, dyn_res): every
    DEQ-MPC iterate, and the mean dynamics residual of the final one.

    ws_mode "proposal" seeds each tracking solve from the fresh DEQ
    proposal; "solution" seeds only the first, later ones from the previous
    solution (and the cost's u_ref is the previous solution's actions).
    The layer may be the mlp or the conv cell; its out_type must be 1 or 2,
    a state reference for the tracking MPC (the JAX package's policy fails
    on 0, 3 and 4).
    """

    def __init__(self, nx: int, nu: int, nq: int, T: int, hdim: int,
                 dt: float, tracking: TrackingMPC, deq_iter: int = 6,
                 out_type: int = 2, layer_type: str = "mlp",
                 ws_mode: str = "proposal"):
        super().__init__()
        if out_type not in (1, 2):
            raise ValueError(
                f"DEQMPCPolicy out_type {out_type}: the tracking MPC takes "
                f"a state reference, out_type 1 or 2")
        if ws_mode not in ("proposal", "solution"):
            raise ValueError(f"ws_mode must be 'proposal' or 'solution', "
                             f"got {ws_mode!r}")
        self.nx, self.nu, self.T = nx, nu, T
        self.tracking = tracking
        self.deq_iter = deq_iter
        self.out_type = out_type
        self.ws_mode = ws_mode
        self.layer = DEQLayer(nx=nx, nu=nu, nq=nq, T=T, hdim=hdim, dt=dt,
                              out_type=out_type, layer_type=layer_type)

    def flax_modules(self) -> Modules:
        return prefixed(("DEQLayer_0", "layer"), self.layer.flax_modules())

    def forward(self, x: Tensor, qp_solve: bool = True,
                lastqp_solve: bool = False
                ) -> Tuple[List[DEQMPCRollout], Tensor]:
        bsz = x.shape[0]
        z = self.layer.init_z(bsz, x.dtype, x.device)
        x_ref_flat = x.repeat(1, self.T)  # initial estimate: x repeated
        actions = x.new_zeros(bsz, self.T, self.nu)
        al_state = self.tracking.init_state(bsz, x.dtype, x.device)
        iterates = []
        x_ref = None
        x_ws = None
        u_ws = actions
        for it in range(self.deq_iter):
            x_ref, z = self.layer(x, x_ref_flat, z)
            if self.out_type == 1:
                x_ref = torch.cat([x[:, None], x_ref], dim=1)
            states, acts = x_ref, actions
            if qp_solve:
                if self.ws_mode == "solution" and it > 0:
                    xi, ui = ((None, None) if self.tracking.carry
                              else (x_ws, u_ws))
                else:
                    xi, ui = x_ref, actions
                states, acts, al_state, _ = self.tracking.solve(
                    x, x_ref, actions, al_state, x_init=xi, u_init=ui)
            iterates.append(DEQMPCRollout(net_states=x_ref, states=states,
                                          actions=acts))
            actions = acts.detach()
            x_ws = states.detach()
            u_ws = actions
            x_ref_flat = states.detach().reshape(bsz, -1)

        if lastqp_solve and not qp_solve:
            states, acts, al_state, _ = self.tracking.solve(
                x, x_ref, actions, al_state, x_init=x_ref, u_init=actions)
            iterates[-1] = DEQMPCRollout(net_states=iterates[-1].net_states,
                                         states=states, actions=acts)

        xr = iterates[-1].states
        x_next = self.tracking.model(
            xr[:, :-1].reshape(-1, self.nx),
            iterates[-1].actions[:, :-1].reshape(-1, self.nu),
        ).reshape(bsz, self.T - 1, self.nx)
        dyn_res = torch.linalg.vector_norm(
            (xr[:, 1:] - x_next).reshape(bsz, -1), dim=-1).mean()
        return iterates, dyn_res


class NNMPCPolicy(nn.Module):
    """Feedforward net + tracking MPC: FFDNetwork's positions with zero
    velocities are the reference of one tracking solve from fresh solver
    state; forward returns its (states, actions)."""

    def __init__(self, nx: int, nu: int, nq: int, T: int, hdim: int,
                 tracking: TrackingMPC):
        super().__init__()
        self.nx, self.nu, self.T = nx, nu, T
        self.tracking = tracking
        self.net = FFDNetwork(nx=nx, nq=nq, T=T, hdim=hdim)

    def flax_modules(self) -> Modules:
        return prefixed(("FFDNetwork_0", "net"), self.net.flax_modules())

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        bsz = x.shape[0]
        pos_ref = self.net(x)
        x_ref = torch.cat([pos_ref, pos_ref.new_zeros(
            bsz, self.T, self.nx - pos_ref.shape[-1])], dim=-1)
        al_state = self.tracking.init_state(bsz, x.dtype, x.device)
        u0 = x.new_zeros(bsz, self.T, self.nu)
        states, actions, _, _ = self.tracking.solve(x, x_ref, u0, al_state)
        return states, actions
