"""Dynamics model base (port of diff_qp_mpc_tpu.models.base).

A model is an object with ``nx, nu, nq, dt`` and a batched ``step(x, u)``
over leading batch axes. Jacobians come from ``torch.func.jacfwd`` under
``vmap`` unless the model overrides ``jac`` with its analytic form (the
form the fused CUDA kernel evaluates in-register); ``linearize`` evaluates
them along a whole trajectory in one batched call.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch

from diff_qp_mpc_tpu_torch.models.dual import Dual

Tensor = torch.Tensor
Ode = Callable[[Tensor, Tensor], Tensor]


# integrators of an ODE ẋ = f(x, u) over one step dt
def euler(ode: Ode, x: Tensor, u: Tensor, dt: float) -> Tensor:
    return x + dt * ode(x, u)


def midpoint(ode: Ode, x: Tensor, u: Tensor, dt: float) -> Tensor:
    k1 = ode(x, u)
    k2 = ode(x + 0.5 * dt * k1, u)
    return x + dt * k2


def rk4(ode: Ode, x: Tensor, u: Tensor, dt: float) -> Tensor:
    k1 = ode(x, u)
    k2 = ode(x + 0.5 * dt * k1, u)
    k3 = ode(x + 0.5 * dt * k2, u)
    k4 = ode(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def semi_implicit_euler(accel: Ode, x: Tensor, u: Tensor, dt: float,
                        nq: int) -> Tensor:
    """v' = v + a·dt; q' = q + v'·dt, for (q, v) states."""
    q, v = x[..., :nq], x[..., nq:]
    v_n = v + accel(x, u) * dt
    q_n = q + v_n * dt
    return torch.cat([q_n, v_n], dim=-1)


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
        # forward mode can promote a product with a Python number to
        # float64 (torch 2.13); the Jacobians keep the state's dtype
        return self.step(x, u), (jx.to(x.dtype), ju.to(x.dtype))

    def linearize(self, x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(x_next, A, B) along the trajectory; see linearize_trajectory."""
        return linearize_trajectory(self.jac, x, u)

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


def rk4_parts(ode_parts, p, xs, us):
    """RK4 on tuples of coordinates, ``p["h"]`` = dt/2, ``p["dt6"]`` =
    dt/6, as ``rk4`` of csrc/al_fused_common.cuh."""
    add = lambda a, k, s: tuple(ai + s * ki for ai, ki in zip(a, k))
    k1 = ode_parts(p, xs, us)
    k2 = ode_parts(p, add(xs, k1, p["h"]), us)
    k3 = ode_parts(p, add(xs, k2, p["h"]), us)
    k4 = ode_parts(p, add(xs, k3, p["dt"]), us)
    return tuple(x + p["dt6"] * (a + 2 * b + 2 * c + d)
                 for x, a, b, c, d in zip(xs, k1, k2, k3, k4))


class Functor(DynamicsModel):
    """A model whose ``step_parts`` is K2's functor for it operation for
    operation, with the constants ``PARAMS`` names (``kernel_params`` gives
    them in that order, folded in double precision), and whose ``jac`` is
    one forward-mode pass of it per input column."""

    PARAMS: Tuple[str, ...] = ()

    def kernel_params(self) -> Tuple[float, ...]:  # pragma: no cover
        raise NotImplementedError

    def scalars(self, like) -> Dict[str, object]:
        """The constants as 0-dim tensors of ``like``'s dtype and device
        (a dual's value), so each operation on them rounds as the kernel's
        does."""
        like = like.v if isinstance(like, Dual) else like
        return {k: like.new_tensor(v) for k, v in
                zip(self.PARAMS, self.kernel_params())}

    def step_parts(self, xs, us, p=None):  # pragma: no cover
        """The functor's step on tuples of coordinates (tensors, duals, or
        any number type given its own constants ``p``)."""
        raise NotImplementedError

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.stack(self.step_parts(x.unbind(-1), u.unbind(-1)), -1)

    def jac(self, x: Tensor, u: Tensor):
        """(x_next, (A, B)) from one forward-mode pass with a unit seed per
        input column, as the functor's ``jac`` runs them."""
        n = self.nx + self.nu
        seeds = torch.eye(n, dtype=x.dtype, device=x.device).reshape(
            (n, n) + (1,) * (x.ndim - 1))
        xu = torch.cat([x, u], dim=-1)
        duals = [Dual(xu[..., i], seeds[:, i].expand((n,) + xu.shape[:-1]))
                 for i in range(n)]
        out = self.step_parts(duals[:self.nx], duals[self.nx:])
        x_next = torch.stack([o.v for o in out], dim=-1)
        J = torch.stack([o.d for o in out], dim=-1)  # [n, ..., nx]
        J = J.movedim(0, -1)  # [..., nx, n]
        return x_next, (J[..., :self.nx].contiguous(),
                        J[..., self.nx:].contiguous())


class Rk4Functor(Functor):
    """A functor model whose step is RK4 of its ODE ``_ode_parts`` (``Rk4Dyn``
    of csrc/al_fused_common.cuh)."""

    def _ode_parts(self, p, xs, us):  # pragma: no cover
        raise NotImplementedError

    def step_parts(self, xs, us, p=None):
        if p is None:
            p = self.scalars(xs[0])
        return rk4_parts(self._ode_parts, p, tuple(xs), tuple(us))


def step_with_jac(model: DynamicsModel):
    """Batched (x_next, (J_x, J_u)) function of ``model``."""
    return model.jac


def linearize_trajectory(jac, x: Tensor, u: Tensor
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Linearize the dynamics along a trajectory in one batched ``jac`` call
    over all (batch × time) pairs: x [bsz, T, nx], u [bsz, T, nu] ->
    (x_next [bsz, T-1, nx], A [bsz, T-1, nx, nx], B [bsz, T-1, nx, nu])."""
    bsz, T, nx = x.shape
    nu = u.shape[-1]
    x_next, (A, B) = jac(x[:, :-1].reshape(-1, nx), u[:, :-1].reshape(-1, nu))
    return (x_next.reshape(bsz, T - 1, nx), A.reshape(bsz, T - 1, nx, nx),
            B.reshape(bsz, T - 1, nx, nu))


class SlewAugmented(DynamicsModel):
    """State augmentation carrying the previous control: x̃ = [x; u_prev]
    (port of diff_qp_mpc_tpu.models.base.SlewAugmented).

    The structured equivalent of the reference's SlewRateCost wrapper
    (qpth/qp_wrapper.py:30-57): the previous control becomes part of the
    state, step̃([x, u_prev], u) = [f(x, u), u], so the slew penalty
    s·‖u − u_prev‖² is an ordinary stage quadratic with a (u_prev, u)
    cross block, and the trajectory QP keeps the stage-separable structure
    the Riccati kernels take. ``jac`` is built from the inner model's (no
    forward-mode pass through the augmented step): A = blkdiag(A_inner, 0),
    B = [B_inner; I].
    """

    def __init__(self, inner: DynamicsModel):
        self.inner = inner
        self.nx = inner.nx + inner.nu
        self.nu = inner.nu
        self.nq = inner.nq
        self.dt = inner.dt

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.cat([self.inner.step(x[..., :self.inner.nx], u), u],
                         dim=-1)

    def jac(self, x: Tensor, u: Tensor):
        nx, nu = self.inner.nx, self.nu
        x_next, (A_in, B_in) = self.inner.jac(x[..., :nx], u)
        A = A_in.new_zeros(A_in.shape[:-2] + (nx + nu, nx + nu))
        A[..., :nx, :nx] = A_in
        eye = torch.eye(nu, dtype=B_in.dtype, device=B_in.device)
        B = torch.cat([B_in, eye.expand(B_in.shape[:-2] + (nu, nu))], -2)
        return torch.cat([x_next, u], dim=-1), (A, B)

    # configuration-only objects, hashed and compared as the JAX package's
    def __hash__(self):
        return hash((type(self), self.inner))

    def __eq__(self, other):
        return type(self) is type(other) and hash(self) == hash(other)


def angle_normalize(x: Tensor) -> Tensor:
    """Wrap to [-π, π). Python's ``%`` is a floored modulo, so this is
    ``torch.remainder`` (not ``fmod``, which truncates toward zero)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def angle_normalize_2pi(x: Tensor) -> Tensor:
    """Wrap to [0, 2π) (the cartpoles' pole angle, upright at π)."""
    return torch.remainder(x, 2 * math.pi)
