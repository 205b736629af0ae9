"""Dynamics model base (port of diff_qp_mpc_tpu.models.base).

A model is an object with ``nx, nu, nq, dt`` and a batched ``step(x, u)``
over leading batch axes. Jacobians come from ``torch.func.jacfwd`` under
``vmap`` unless the model overrides ``jac`` with its analytic form (the
form the fused CUDA kernel evaluates in-register).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor


class DynamicsModel:
    nx: int
    nu: int
    nq: int
    dt: float

    def step(self, x: Tensor, u: Tensor) -> Tensor:  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x: Tensor, u: Tensor) -> Tensor:
        """Batched step: [bsz, nx] × [bsz, nu] -> [bsz, nx]."""
        return self.step(x, u)

    def jac(self, x: Tensor, u: Tensor) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
        """Batched (x_next [bsz, nx], (J_x [bsz, nx, nx], J_u [bsz, nx, nu]))."""
        single = lambda xx, uu: self.step(xx, uu)
        jx, ju = torch.func.vmap(
            torch.func.jacfwd(single, argnums=(0, 1)))(x, u)
        return self.step(x, u), (jx, ju)

    def rollout(self, x0: Tensor, u: Tensor) -> Tensor:
        """x0 [bsz, nx], u [bsz, T, nu] -> [bsz, T, nx]; x0 is the first row
        and u[:, T-1] is unused."""
        xs = [x0]
        for t in range(u.shape[1] - 1):
            xs.append(self.step(xs[-1], u[:, t]))
        return torch.stack(xs, dim=1)

    def action_clip(self, u: Tensor) -> Tensor:
        return u

    def state_clip(self, x: Tensor) -> Tensor:
        return x


def step_with_jac(model: DynamicsModel):
    """Batched (x_next, (J_x, J_u)) function of ``model``."""
    return model.jac


def angle_normalize(x: Tensor) -> Tensor:
    """Wrap to [-π, π). Python's ``%`` is a floored modulo, so this is
    ``torch.remainder`` (not ``fmod``, which truncates toward zero)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi
