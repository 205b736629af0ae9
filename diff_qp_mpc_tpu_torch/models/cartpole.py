"""1-link and 2-link cartpoles and the cos/sin cartpole (port of
diff_qp_mpc_tpu.models.cartpole).

Pole angles are measured from the downward vertical, anticlockwise
positive, so upright is θ = π; a later joint angle is relative to the link
before it. The control is a horizontal force on the cart.

``Cartpole1L`` and ``Cartpole2L`` step in the closed form that kernel K2's
functors (``csrc/al_fused_cartpole1l.cu``, ``al_fused_cartpole2l.cu``)
evaluate, operation for operation: the mass matrix M(q) and b = τ − c(q, q̇)
written out by hand from the energies, M q̈ = b solved by Gaussian
elimination without pivoting in the order of the JAX package's
``manipulator_accel_parts``, RK4 on the coordinates, and the Jacobian as
one forward-mode pass per input column (``models.dual``). Model constants
enter folded in double precision (``kernel_params``) and are applied in the
state's dtype. The tests hold the closed form to the JAX package's step,
RK4 of the equations of motion that its ``lagrangian`` module derives from
the energies by automatic differentiation.
"""
from __future__ import annotations

import torch

from diff_qp_mpc_tpu_torch.models.base import (
    Functor,
    Rk4Functor,
    angle_normalize,
    angle_normalize_2pi,
)

Tensor = torch.Tensor


class _Cartpole(Rk4Functor):
    """A cartpole whose step is its K2 functor's closed form."""


class Cartpole1L(_Cartpole):
    """State (x, θ, ẋ, θ̇); defaults dt 0.01, max_force 500, M 0.5, m 0.2,
    l 0.5, g 9.81 (a point mass m at the pole's end)."""

    PARAMS = ("m00", "ml", "ml2", "mgl", "dt", "h", "dt6")

    def __init__(self, dt: float = 0.01, M: float = 0.5, m: float = 0.2,
                 l: float = 0.5, g: float = 9.81, max_force: float = 500.0):
        self.dt, self.M, self.m, self.l, self.g = dt, M, m, l, g
        self.max_force = max_force
        self.nx, self.nu, self.nq = 4, 1, 2

    def kernel_params(self):
        M, m, l, g, dt = self.M, self.m, self.l, self.g, self.dt
        return (M + m, m * l, m * l * l, m * g * l, dt, 0.5 * dt, dt / 6.0)

    def _ode_parts(self, p, xs, us):
        """q̈ from M = [[M+m, m l cosθ], [m l cosθ, m l²]] and b = (u + m l
        θ̇² sinθ, −m g l sinθ)."""
        _, th, xd, thd = xs
        s, c = th.sin(), th.cos()
        m01 = p["ml"] * c
        b0 = us[0] + p["ml"] * (thd * thd) * s
        b1 = -(p["mgl"] * s)
        inv0 = 1.0 / p["m00"]
        f = m01 * inv0
        a11 = p["ml2"] - f * m01
        b1 = b1 - f * b0
        qdd1 = b1 / a11
        qdd0 = (b0 - m01 * qdd1) / p["m00"]
        return (xd, thd, qdd0, qdd1)

    def action_clip(self, u: Tensor) -> Tensor:
        return torch.clamp(u, -self.max_force, self.max_force)

    def state_clip(self, x: Tensor) -> Tensor:
        """The pole angle wrapped to [0, 2π)."""
        return torch.cat([x[..., :1], angle_normalize_2pi(x[..., 1:2]),
                          x[..., 2:]], dim=-1)


class Cartpole2L(_Cartpole):
    """State (x, θ₁, θ₂, ẋ, θ̇₁, θ̇₂), θ from down, θ₂ relative to link 1.
    Mass points m₁, m₂ at ``com`` of each link's length and a rotational
    inertia ``link_inertia`` of each link about its absolute rate. The
    default is the reference's analytic model (point masses at the link
    midpoints, cart M 5, m₁ m₂ 1, l₁ l₂ 1); ``pkg()`` its CasADi package
    (masses at the link tips, inertia 1, cart M 10)."""

    PARAMS = ("m00", "k1", "k2", "k3", "k3x2", "m11c", "m12c", "gk1", "gk2",
              "dt", "h", "dt6")

    def __init__(self, dt: float = 0.05, M: float = 5.0, m1: float = 1.0,
                 m2: float = 1.0, l1: float = 1.0, l2: float = 1.0,
                 g: float = 9.81, max_force: float = 500.0,
                 com: float = 0.5, link_inertia: float = 0.0):
        self.dt, self.M, self.m1, self.m2 = dt, M, m1, m2
        self.l1, self.l2, self.g = l1, l2, g
        self.max_force = max_force
        self.com, self.link_inertia = com, link_inertia
        self.nx, self.nu, self.nq = 6, 1, 3

    @classmethod
    def pkg(cls, dt: float = 0.05, max_force: float = 500.0) -> "Cartpole2L":
        """The reference's live 2-link robot (its CasADi C package)."""
        return cls(dt=dt, M=10.0, com=1.0, link_inertia=1.0,
                   max_force=max_force)

    def kernel_params(self):
        M, m1, m2, l1, g = self.M, self.m1, self.m2, self.l1, self.g
        r1, r2 = self.com * self.l1, self.com * self.l2
        inertia = self.link_inertia
        k1, k2, k3 = m1 * r1 + m2 * l1, m2 * r2, m2 * l1 * r2
        return (M + m1 + m2, k1, k2, k3, 2.0 * k3,
                m1 * r1 * r1 + m2 * (l1 * l1 + r2 * r2) + 2.0 * inertia,
                m2 * r2 * r2 + inertia, g * k1, g * k2,
                self.dt, 0.5 * self.dt, self.dt / 6.0)

    def _ode_parts(self, p, xs, us):
        """q̈ from, with c₁ = cos θ₁, c₂ = cos θ₂, c₁₂ = cos(θ₁ + θ₂) (s
        the sines), ω₁₂ = θ̇₁ + θ̇₂, k₁ = m₁r₁ + m₂l₁, k₂ = m₂r₂, k₃ =
        m₂l₁r₂ (r the mass points' distances along the links, I the link
        inertia):

            M = [[M+m₁+m₂, k₁c₁ + k₂c₁₂, k₂c₁₂],
                 [·, m₁r₁² + m₂(l₁² + r₂²) + 2I + 2k₃c₂, m₂r₂² + I + k₃c₂],
                 [·, ·, m₂r₂² + I]]
            b = (u + k₁s₁θ̇₁² + k₂s₁₂ω₁₂²,
                 k₃s₂θ̇₂(2θ̇₁ + θ̇₂) − g(k₁s₁ + k₂s₁₂),
                 −k₃s₂θ̇₁² − g k₂s₁₂)."""
        _, th1, th2, xd, w1, w2 = xs
        s1, c1 = th1.sin(), th1.cos()
        s2, c2 = th2.sin(), th2.cos()
        phi = th1 + th2
        sp, cp = phi.sin(), phi.cos()
        w12 = w1 + w2
        m01 = p["k1"] * c1 + p["k2"] * cp
        m02 = p["k2"] * cp
        m11 = p["m11c"] + p["k3x2"] * c2
        m12 = p["m12c"] + p["k3"] * c2
        m22 = p["m12c"]
        k3s2 = p["k3"] * s2
        gk2sp = p["gk2"] * sp
        b0 = us[0] + p["k1"] * s1 * (w1 * w1) + p["k2"] * sp * (w12 * w12)
        b1 = k3s2 * w2 * (2 * w1 + w2) - (p["gk1"] * s1 + gk2sp)
        b2 = -(k3s2 * (w1 * w1)) - gk2sp
        # M q̈ = b, no pivoting (M is SPD)
        inv0 = 1.0 / p["m00"]
        f = m01 * inv0
        a11 = m11 - f * m01
        a12 = m12 - f * m02
        b1 = b1 - f * b0
        f = m02 * inv0
        a21 = m12 - f * m01
        a22 = m22 - f * m02
        b2 = b2 - f * b0
        inv1 = 1.0 / a11
        f = a21 * inv1
        a22 = a22 - f * a12
        b2 = b2 - f * b1
        qdd2 = b2 / a22
        qdd1 = (b1 - a12 * qdd2) / a11
        qdd0 = (b0 - m01 * qdd1 - m02 * qdd2) / p["m00"]
        return (xd, w1, w2, qdd0, qdd1, qdd2)

    def action_clip(self, u: Tensor) -> Tensor:
        return torch.clamp(u, -self.max_force, self.max_force)

    def state_clip(self, x: Tensor) -> Tensor:
        """θ₁ wrapped to [0, 2π) and θ₂ to [−π, π): θ₂'s goal, 0, lies in
        the middle of its branch, so a tracking cost centred on the goal
        sees no 2π seam there (the reference wraps both to [0, 2π))."""
        return torch.cat([x[..., :1], angle_normalize_2pi(x[..., 1:2]),
                          angle_normalize(x[..., 2:3]), x[..., 3:]], dim=-1)


class CartpoleCosSin(Functor):
    """Five-state (x, ẋ, cosθ, sinθ, θ̇) cartpole: the classic gym physics
    (a half-pole's 4/3 moment factor), Euler steps, θ from upright, the
    force clipped inside the step. ``step_parts`` is K2's functor
    (``csrc/al_fused_cossin.cu``) operation for operation, in the JAX
    model's order; the Jacobian comes from its forward-mode pass (the
    clip's tangent ½ at a bound, as JAX's max/min give it)."""

    PARAMS = ("dt", "g", "total", "pml", "mp", "l", "fm")

    def __init__(self, dt: float = 0.05, g: float = 9.8,
                 masscart: float = 1.0, masspole: float = 0.1,
                 length: float = 0.5, force_mag: float = 100.0):
        self.dt, self.g = dt, g
        self.masscart, self.masspole = masscart, masspole
        self.length, self.force_mag = length, force_mag
        self.nx, self.nu, self.nq = 5, 1, 3

    def kernel_params(self):
        mc, mp, l = self.masscart, self.masspole, self.length
        return (self.dt, self.g, mc + mp, mp * l, mp, l, self.force_mag)

    def step_parts(self, xs, us, p=None):
        if p is None:
            p = self.scalars(xs[0])
        pos, dpos, cos_th, sin_th, dth = xs
        f = us[0].clip(-p["fm"], p["fm"])
        th = sin_th.atan2(cos_th)
        cart_in = (f + p["pml"] * (dth * dth) * sin_th) / p["total"]
        th_acc = (p["g"] * sin_th - cos_th * cart_in) / (
            p["l"] * (4.0 / 3.0 - p["mp"] * (cos_th * cos_th) / p["total"]))
        x_acc = cart_in - p["pml"] * th_acc * cos_th / p["total"]
        pos = pos + p["dt"] * dpos
        dpos = dpos + p["dt"] * x_acc
        th = th + p["dt"] * dth
        dth = dth + p["dt"] * th_acc
        return (pos, dpos, th.cos(), th.sin(), dth)

    def action_clip(self, u: Tensor) -> Tensor:
        return torch.clamp(u, -self.force_mag, self.force_mag)

