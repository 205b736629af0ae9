"""Lagrangian-mechanics dynamics from energy functions (port of
diff_qp_mpc_tpu.models.lagrangian, on ``torch.func``).

The manipulator equation, derived by automatic differentiation:

    M(q) q̈ + c(q, q̇) = τ,   M = ∂²T/∂q̇²,   c = (∂²L/∂q̇∂q) q̇ − ∂L/∂q

with L = T − V, so q̈ = M(q)⁻¹ (τ − c). The functions here take one
(unbatched) configuration; models ``torch.func.vmap`` them over a batch.
The fused kernel K2 does not differentiate: its cartpole functors evaluate
the same M and b = τ − c in closed form (``models.cartpole``).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, hessian, jacfwd

Tensor = torch.Tensor
#: energy function (q, q̇) -> scalar
EnergyFn = Callable[[Tensor, Tensor], Tensor]


def manipulator_accel(kinetic: EnergyFn, potential: Callable[[Tensor], Tensor],
                      q: Tensor, qdot: Tensor, tau: Tensor) -> Tensor:
    """q̈ of one configuration: q, q̇, τ [nq]."""

    def L(q_, qdot_):
        return kinetic(q_, qdot_) - potential(q_)

    Mq = hessian(kinetic, argnums=1)(q, qdot)
    # forward-over-reverse can promote a product with a Python number to
    # float64 (torch 2.13); the derivative is cast back to the state's dtype
    dq_dqdot = jacfwd(grad(L, argnums=1), argnums=0)(q, qdot).to(q.dtype)
    c = dq_dqdot @ qdot - grad(L, argnums=0)(q, qdot)
    return torch.linalg.solve(Mq, tau - c)


def lagrangian_ode(kinetic: EnergyFn, potential: Callable[[Tensor], Tensor],
                   input_map: Callable[[Tensor, Tensor], Tensor]):
    """ẋ = f(x, u) of one state x = (q, q̇) [nx]; ``input_map(q, u)`` gives
    the generalized forces τ [nq]."""

    def ode(x: Tensor, u: Tensor) -> Tensor:
        nq = x.shape[-1] // 2
        q, qdot = x[..., :nq], x[..., nq:]
        tau = input_map(q, u)
        qddot = manipulator_accel(kinetic, potential, q, qdot, tau)
        return torch.cat([qdot, qddot], dim=-1)

    return ode
