"""Concrete environments (port of diff_qp_mpc_tpu.envs; the pendulum)."""
from __future__ import annotations

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.envs.base import Env, EnvState, Spaces
from diff_qp_mpc_tpu_torch.models import Pendulum, angle_normalize

__all__ = ["Env", "EnvState", "Spaces", "PendulumEnv", "make_env"]


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
        high = torch.tensor([0.05, 0.5] if self.stabilization
                            else [np.pi, 1.0], dtype=torch.float64)
        u = torch.rand(bsz, 2, generator=generator, dtype=torch.float64)
        return (2.0 * u - 1.0) * high

    def _success(self, x):
        return torch.abs(angle_normalize(x[..., 0])) < 0.05

    def goal_error(self, x):
        return torch.abs(angle_normalize(x[..., 0]))

    def _reward(self, x, u):
        return -(angle_normalize(x[..., 0]) ** 2)


def make_env(name: str, **kwargs) -> Env:
    """Env registry by name (only the pendulum is ported)."""
    table = {"pendulum": PendulumEnv}
    if name not in table:
        raise ValueError(f"unknown env '{name}' (have {sorted(table)})")
    return table[name](**kwargs)
