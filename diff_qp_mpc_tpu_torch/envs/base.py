"""Batched environments (port of diff_qp_mpc_tpu.envs.base).

Environments are stateless objects; the mutable state (x, success counter,
step counter) lives in an ``EnvState`` and randomness comes from an explicit
``torch.Generator``. State is [bsz, nx].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.models.base import DynamicsModel

Tensor = torch.Tensor


@dataclasses.dataclass
class EnvState:
    x: Tensor  # [bsz, nx]
    num_successes: Tensor  # [bsz] int32
    steps: Tensor  # [bsz] int32

    @staticmethod
    def make(x: Tensor) -> "EnvState":
        zeros = torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        return EnvState(x=x, num_successes=zeros, steps=zeros.clone())


class Spaces:
    """Box space."""

    def __init__(self, low, high, shape=None):
        self.low = np.asarray(low)
        self.high = np.asarray(high)
        self.shape = shape if shape is not None else self.low.shape


class Env:
    """Base class; subclasses set model, spec_id, Qlqr, Rlqr and implement
    ``_sample_init``, ``_success``, ``_reward``."""

    model: DynamicsModel
    spec_id: str
    max_steps: int = 200
    success_streak: int = 10
    terminate_on_success: bool = True

    @property
    def nx(self) -> int:
        return self.model.nx

    @property
    def nu(self) -> int:
        return self.model.nu

    @property
    def nq(self) -> int:
        return self.model.nq

    @property
    def dt(self) -> float:
        return self.model.dt

    def _sample_init(self, generator: torch.Generator, bsz: int) -> Tensor:
        raise NotImplementedError

    def _success(self, x: Tensor) -> Tensor:
        raise NotImplementedError

    def goal_error(self, x: Tensor) -> Tensor:
        """Continuous distance-to-goal of the true states."""
        return torch.full(x.shape[:-1], float("nan"), dtype=x.dtype,
                          device=x.device)

    def _reward(self, x: Tensor, u: Tensor) -> Tensor:
        raise NotImplementedError

    def _diverged(self, x: Tensor) -> Tensor:
        return ~torch.isfinite(x).all(dim=-1)

    def reset(self, generator: torch.Generator, bsz: int,
              dtype=torch.float32, device=None) -> EnvState:
        """Initial states drawn on the CPU from ``generator``, then moved."""
        x = self._sample_init(generator, bsz).to(dtype=dtype, device=device)
        return EnvState.make(x)

    def step(self, state: EnvState, u: Tensor
             ) -> Tuple[EnvState, Tensor, Tensor]:
        """(state, action) -> (next_state, reward, done)."""
        u = self.model.action_clip(u)
        x = self.model.state_clip(self.model(state.x, u))
        succ = self._success(x)
        num_successes = torch.where(succ, state.num_successes + 1,
                                    torch.zeros_like(state.num_successes))
        steps = state.steps + 1
        done = (steps >= self.max_steps) | self._diverged(x)
        if self.terminate_on_success:
            done = done | (num_successes >= self.success_streak)
        reward = self._reward(x, u)
        return (EnvState(x=x, num_successes=num_successes, steps=steps),
                reward, done)

    def reset_where(self, state: EnvState, mask: Tensor,
                    generator: Optional[torch.Generator] = None,
                    fresh: Optional[Tensor] = None) -> EnvState:
        """The batch elements where ``mask`` is True started anew (the
        auto-reset of batched data collection): a fresh batch of initial
        states is drawn from ``generator`` (or given as ``fresh``, [bsz,
        nx]) and picked per element, with its counters at 0."""
        if fresh is None:
            fresh = self.reset(generator, state.x.shape[0],
                               dtype=state.x.dtype, device=state.x.device).x
        zero = torch.zeros_like(state.steps)
        return EnvState(
            x=torch.where(mask[:, None], fresh.to(state.x), state.x),
            num_successes=torch.where(mask, zero, state.num_successes),
            steps=torch.where(mask, zero, state.steps))
