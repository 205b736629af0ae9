"""Concrete environments (port of diff_qp_mpc_tpu.envs): the pendulum, the
integrator, the 1- and 2-link cartpoles and the Rex quadrotor. Each draws
its initial states from an explicit ``torch.Generator``."""
from __future__ import annotations

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs.base import Env, EnvState, Spaces
from diff_qp_mpc_tpu_torch.models import (
    Cartpole1L,
    Cartpole2L,
    Integrator,
    Pendulum,
    RexQuadrotor,
    angle_normalize,
)

__all__ = ["Env", "EnvState", "Spaces", "PendulumEnv", "IntegratorEnv",
           "Cartpole1LEnv", "Cartpole2LEnv", "QuadrotorEnv", "make_env"]


def _uniform(generator, bsz, high):
    """[bsz, len(high)] uniform in [−high, high], float64 on the CPU."""
    high = torch.as_tensor(high, dtype=torch.float64)
    u = torch.rand(bsz, high.shape[0], generator=generator,
                   dtype=torch.float64)
    return (2.0 * u - 1.0) * high


class PendulumEnv(Env):
    """θ from upright, swing-up or stabilization."""

    def __init__(self, stabilization: bool = False):
        self.model = Pendulum()
        self.stabilization = stabilization
        self.spec_id = "Pendulum-v0" + ("-stabilize" if stabilization else "")
        self.Qlqr = np.array([10.0, 1.0])
        self.Rlqr = np.array([0.01])
        self.observation_space = Spaces(
            -np.array([np.pi, np.inf]), np.array([np.pi, np.inf]))
        self.action_space = Spaces(
            -np.array([self.model.max_torque]),
            np.array([self.model.max_torque]))

    def _sample_init(self, generator, bsz):
        return _uniform(generator, bsz, [0.05, 0.5] if self.stabilization
                        else [np.pi, 1.0])

    def _success(self, x):
        return torch.abs(angle_normalize(x[..., 0])) < 0.05

    def goal_error(self, x):
        return torch.abs(angle_normalize(x[..., 0]))

    def _reward(self, x, u):
        return -(angle_normalize(x[..., 0]) ** 2)


class IntegratorEnv(Env):
    """Drive the double integrator's position to 0."""

    def __init__(self, nx: int = 2, nu: int = 1, dt: float = 0.1,
                 max_acc: float = 2.0, max_vel: float = 2.0):
        self.model = Integrator(nx=nx, nu=nu, dt=dt, max_acc=max_acc,
                                max_vel=max_vel)
        self.spec_id = "Integrator-v0"
        self.Qlqr = np.array([10.0, 1.0] * (nx // 2))
        self.Rlqr = np.full((nu,), 0.01)
        low = np.concatenate([np.full(nx // 2, -np.inf),
                              np.full(nx // 2, -max_vel)])
        self.observation_space = Spaces(low, -low)
        self.action_space = Spaces(np.full(nu, -max_acc),
                                   np.full(nu, max_acc))

    def _sample_init(self, generator, bsz):
        nq = self.nq
        return _uniform(generator, bsz,
                        [2.0] * nq + [self.model.max_vel] * nq)

    def _success(self, x):
        return torch.linalg.vector_norm(x[..., :self.nq], dim=-1) < 0.01

    def goal_error(self, x):
        return torch.linalg.vector_norm(x[..., :self.nq], dim=-1)

    def _reward(self, x, u):
        norm = lambda a: torch.linalg.vector_norm(a, dim=-1)
        return -(norm(x[..., :self.nq]) + norm(x[..., self.nq:]) + norm(u))


class _CartpoleEnvBase(Env):
    """Swing-up or stabilization of a cartpole (pole angles from down, so
    upright is θ = π; later joints relative): the goal is the cart at 0,
    every link up, at rest. ``init_scale`` widens the stabilization's
    initial-state box."""

    def __init__(self, stabilization: bool, init_scale: float = 1.0):
        self.stabilization = stabilization
        self.init_scale = init_scale
        nq = self.model.nq
        high = np.concatenate([np.full(nq, np.pi), np.full(nq, np.pi * 5)])
        self.observation_space = Spaces(-high, high)
        self.action_space = Spaces(np.full(1, -self.u_bounds),
                                   np.full(1, self.u_bounds))
        self.Qlqr = np.ones((self.nx,))
        self.Rlqr = np.full((self.nu,), 1e-8)
        # all links up: θ = (π, 0, ...) with the later joints relative
        self.goal = np.concatenate([[0.0, np.pi], np.zeros(nq - 2),
                                    np.zeros(nq)])

    def _delta_upright(self, x):
        """The largest distance of a link's absolute angle from up."""
        th_abs = torch.cumsum(x[..., 1:self.nq], dim=-1)
        return torch.amax(torch.abs(angle_normalize(th_abs - np.pi)),
                          dim=-1)

    def _sample_init(self, generator, bsz):
        nq = self.nq
        if self.stabilization:
            high = self.init_scale * np.concatenate(
                [[0.1], np.full(nq - 1, 0.05), np.full(nq, 0.05)])
            offset = torch.as_tensor(np.concatenate(
                [[0.0, np.pi], np.zeros(nq - 2), np.zeros(nq)]))
            return offset + _uniform(generator, bsz, high)
        return _uniform(generator, bsz, np.full(2 * nq, np.pi))

    def _success(self, x):
        return self._delta_upright(x) < 0.05

    def goal_error(self, x):
        return self._delta_upright(x)

    def _reward(self, x, u):
        cart = torch.abs(x[..., 0])
        return -(self._delta_upright(x) + cart + (cart > 10) * 80.0)

    def _diverged(self, x):
        """A cart run away or a velocity blown up: unrecoverable within the
        force budget."""
        nq = self.nq
        return (super()._diverged(x) | (torch.abs(x[..., 0]) > 15.0)
                | (torch.abs(x[..., nq:]) > 40.0).any(dim=-1))


class Cartpole1LEnv(_CartpoleEnvBase):
    def __init__(self, stabilization: bool = False, dt: float = 0.05,
                 init_scale: float = 1.0):
        self.model = Cartpole1L(dt=dt, max_force=100.0)
        self.u_bounds = 100.0
        self.max_steps = 200
        self.spec_id = "Cartpole1l-v0" + ("-stabilize" if stabilization
                                          else "")
        super().__init__(stabilization, init_scale)


class Cartpole2LEnv(_CartpoleEnvBase):
    """The reference's live 2-link robot (``Cartpole2L.pkg()``), 250 N."""

    def __init__(self, stabilization: bool = False, dt: float = 0.05,
                 init_scale: float = 1.0):
        self.model = Cartpole2L.pkg(dt=dt, max_force=250.0)
        self.u_bounds = 250.0
        self.max_steps = 300
        self.spec_id = "Cartpole2l-v0" + ("-stabilize" if stabilization
                                          else "")
        super().__init__(stabilization, init_scale)


class QuadrotorEnv(Env):
    """Hover at the origin from a random pose: position uniform in [−1, 1]³,
    attitude (MRP), velocity and body rates normal with standard
    deviations 0.1, 0.2 and 0.1. The rotors' box [0, 20]⁴ is not
    symmetric about 0."""

    def __init__(self):
        self.model = RexQuadrotor()
        self.spec_id = "RexQuadrotor-v0"
        self.max_steps = 100
        self.Qlqr = np.concatenate([np.full(3, 10.0), np.full(3, 1.0),
                                    np.full(3, 1.0), np.full(3, 1.0)])
        self.Rlqr = np.full(4, 0.01)
        self.observation_space = Spaces(np.full(12, -np.inf),
                                        np.full(12, np.inf))
        self.action_space = Spaces(np.full(4, 0.0), np.full(4, 20.0))

    def _sample_init(self, generator, bsz):
        normal = lambda std: std * torch.randn(
            bsz, 3, generator=generator, dtype=torch.float64)
        return torch.cat([_uniform(generator, bsz, [1.0] * 3), normal(0.1),
                          normal(0.2), normal(0.1)], dim=-1)

    def _success(self, x):
        return self.goal_error(x) < 0.05

    def goal_error(self, x):
        return torch.linalg.vector_norm(x[..., :3], dim=-1)

    def _reward(self, x, u):
        norm = lambda a: torch.linalg.vector_norm(a, dim=-1)
        return -(norm(x[..., :3]) + 0.1 * norm(x[..., 6:9]))


def make_env(name: str, **kwargs) -> Env:
    """Env registry by name, as the JAX package's ``make_env``."""
    table = {"pendulum": PendulumEnv, "integrator": IntegratorEnv,
             "cartpole1link": Cartpole1LEnv,
             "cartpole2link": Cartpole2LEnv, "rexquadrotor": QuadrotorEnv}
    if name not in table:
        raise ValueError(f"unknown env '{name}' (have {sorted(table)})")
    return table[name](**kwargs)
