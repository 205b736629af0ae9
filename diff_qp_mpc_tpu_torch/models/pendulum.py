"""Pendulums (port of diff_qp_mpc_tpu.models.pendulum): the 2-state
(θ, θ̇) one, semi-implicit Euler, θ from upright, gravity destabilizing,
θ̈ = (u + m g l sin θ) / (m l²); and the 3-state (cos θ, sin θ, θ̇) one of
the legacy qpth encoding."""
from __future__ import annotations

import torch

from diff_qp_mpc_tpu_torch.models.base import (
    DynamicsModel,
    Functor,
    angle_normalize,
)

Tensor = torch.Tensor


class Pendulum(DynamicsModel):
    def __init__(self, dt: float = 0.05, m: float = 1.0, l: float = 1.0,
                 g: float = 10.0, max_torque: float = 3.0):
        self.dt = dt
        self.m = m
        self.l = l
        self.g = g
        self.max_torque = max_torque
        self.nx = 2
        self.nu = 1
        self.nq = 1

    def step_parts(self, xs, us):
        """Coordinate-wise step on tuples of same-shaped tensors."""
        th, thdot = xs
        (tau,) = us
        thddot = (tau + self.m * self.g * self.l * torch.sin(th)) \
            / (self.m * self.l ** 2)
        new_thdot = thdot + thddot * self.dt
        new_th = th + new_thdot * self.dt
        return new_th, new_thdot

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.stack(self.step_parts((x[..., 0], x[..., 1]),
                                           (u[..., 0],)), dim=-1)

    def jac(self, x: Tensor, u: Tensor):
        """Analytic Jacobians, in the forward-mode order of evaluation:
        A = [[1 + dt²·k·cos θ, dt], [dt·k·cos θ, 1]] with k = m g l/(m l²),
        B = [[dt²/(m l²)], [dt/(m l²)]]."""
        th = x[..., 0]
        ml2 = self.m * self.l ** 2
        d_thdot = self.m * self.g * self.l * torch.cos(th) / ml2 * self.dt
        one = torch.ones_like(th)
        A = torch.stack([
            torch.stack([1.0 + d_thdot * self.dt, one * self.dt], -1),
            torch.stack([d_thdot, one], -1)], -2)
        b1 = one * (self.dt / ml2)
        B = torch.stack([b1 * self.dt, b1], -1)[..., None]
        return self.step(x, u), (A, B)

    def action_clip(self, u: Tensor) -> Tensor:
        return torch.clamp(u, -self.max_torque, self.max_torque)

    def state_clip(self, x: Tensor) -> Tensor:
        return torch.cat([angle_normalize(x[..., :1]), x[..., 1:]], dim=-1)


class PendulumCosSin(Functor):
    """3-state (cos θ, sin θ, θ̇) pendulum, the legacy qpth encoding: an
    Euler step on θ̇ with gravity toward the down equilibrium (θ from
    upright), the torque clipped inside the step. ``step_parts`` is K2's
    functor (``csrc/al_fused_cossin.cu``) operation for operation, in the
    JAX model's order; the Jacobian comes from its forward-mode pass (the
    clip's tangent ½ at a bound, as JAX's max/min give it)."""

    PARAMS = ("dt", "k_sin", "ml2", "max_torque")

    def __init__(self, dt: float = 0.05, m: float = 1.0, l: float = 1.0,
                 g: float = 10.0, max_torque: float = 2.0):
        self.dt = dt
        self.m = m
        self.l = l
        self.g = g
        self.max_torque = max_torque
        self.nx = 3
        self.nu = 1
        self.nq = 2

    def kernel_params(self):
        # −3g/(2l), folded as the reference's Python constants are
        return (self.dt, -3.0 * self.g / (2.0 * self.l),
                self.m * self.l ** 2, self.max_torque)

    def step_parts(self, xs, us, p=None):
        if p is None:
            p = self.scalars(xs[0])
        cos_th, sin_th, thdot = xs
        th = sin_th.atan2(cos_th)
        tau = us[0].clip(-p["max_torque"], p["max_torque"])
        thddot = p["k_sin"] * -sin_th + 3.0 * tau / p["ml2"]
        new_thdot = thdot + thddot * p["dt"]
        new_th = th + new_thdot * p["dt"]
        return (new_th.cos(), new_th.sin(), new_thdot)
