"""Rex quadrotor: 12 states, 4 rotors, MRP attitude (port of
diff_qp_mpc_tpu.models.quadrotor).

State (position r, MRP m, body-frame velocity v, body rates ω). Forces:
the rotors' thrust (kf·u plus a bias 4·bf), a quadratic drag on m (cd 0 by
default) and gravity rotated into the body frame; moments: the rotors' yaw
drag (km) and their thrust about the motor arms. ṙ = R(q)·v, ṁ = ¼A(m)ω,
v̇ = F/m − ω×v, ω̇ = J⁻¹(τ − ω×Jω); RK4, controls scaled by act_scale 100.

``step`` is RK4 of the array form ``_ode``, as the JAX package's.
``step_parts`` is the coordinate-wise closed form (the JAX package's
``_quad_ode_parts``, its products with known zeros left out) that kernel
K2's functor (``csrc/al_fused_quadrotor.cu``) evaluates operation for
operation, and ``jac`` one forward-mode pass of it per input column
(``models.dual``). J⁻¹ is inverted once on the host in float64 and applied
in the state's dtype; the JAX package's float32 model inverts J in float32
(its ``quadrotor.py:48``), which moves ω̇ by up to a float32 ulp of J⁻¹
(the tests state the tolerance this costs).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.models.base import Rk4Functor, rk4
from diff_qp_mpc_tpu_torch.models.dual import Dual
from diff_qp_mpc_tpu_torch.models.rotation import (
    mrp_kinematics,
    mrp_to_quat,
    quat_rotate,
)

Tensor = torch.Tensor

_J = np.array([[0.01566089, 0.00000318037, 0.0],
               [0.00000318037, 0.01562078, 0.0],
               [0.0, 0.0, 0.02226868]])
# the motor arms' directions: (±1, ±1, 0)/√2
_SS = np.array([[1.0, 1, 0], [1.0, -1, 0], [-1.0, -1, 0], [-1.0, 1, 0]])
_SS = _SS / np.linalg.norm(_SS, axis=-1, keepdims=True)


def _sign(a):
    """sign of a number or of a dual's value (its derivative is 0)."""
    return (a.v if isinstance(a, Dual) else a).sign()


class RexQuadrotor(Rk4Functor):
    PARAMS = (("act", "kf", "bf", "bf4", "km", "mass", "gz", "kd0", "kd1",
               "kd2")
              + tuple(f"ax{k}" for k in range(4))
              + tuple(f"ay{k}" for k in range(4))
              + tuple(f"J{i}{j}" for i in range(3) for j in range(3))
              + tuple(f"Ji{i}{j}" for i in range(3) for j in range(3))
              + ("dt", "h", "dt6"))

    def __init__(self, mass: float = 2.0, dt: float = 0.05,
                 motor_dist: float = 0.28, kf: float = 0.0244101,
                 bf: float = -30.48576, km: float = 0.00029958,
                 bm: float = -0.367697, act_scale: float = 100.0,
                 cross_A=(0.25, 0.25, 0.25), cd=(0.0, 0.0, 0.0),
                 min_throttle: float = 1148.0, max_throttle: float = 1832.0):
        self.m, self.dt, self.motor_dist = mass, dt, motor_dist
        self.kf, self.bf, self.km, self.bm = kf, bf, km, bm
        self.act_scale = act_scale
        self.min_throttle, self.max_throttle = min_throttle, max_throttle
        self.nx, self.nu, self.nq = 12, 4, 6
        self._J = _J
        self._Jinv = np.linalg.inv(_J)  # float64, once
        self._cd = np.asarray(cd, dtype=float)
        # the reference repeats cross_A[1] for the z axis
        self._cross_A = np.array([cross_A[0], cross_A[1], cross_A[1]],
                                 dtype=float)
        self._ss = _SS

    def _const(self, a, like: Tensor) -> Tensor:
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    # --- the array form (the JAX package's _forces, _moments, _ode) ---
    def _forces(self, x: Tensor, u: Tensor) -> Tensor:
        m = x[..., 3:6]
        q_inv = mrp_to_quat(-m)  # world → body
        F_z = (self.kf * u).sum(dim=-1)
        zero = torch.zeros_like(F_z)
        F = torch.stack([zero, zero, F_z], dim=-1)
        df = (-torch.sign(m) * 0.5 * 1.27 * (m * m)
              * self._const(self._cd, x) * self._const(self._cross_A, x))
        g = self._const([0.0, 0.0, -9.81 * self.m], x)
        Bf = self._const([0.0, 0.0, 4.0 * self.bf], x)
        return F + df + quat_rotate(q_inv, g.expand_as(m)) + Bf

    def _moments(self, x: Tensor, u: Tensor) -> Tensor:
        M = self.km * u
        tau3 = M[..., 0] - M[..., 1] + M[..., 2] - M[..., 3]
        z = torch.zeros_like(tau3)
        torque = torch.stack([z, z, tau3], dim=-1)
        zeros = torch.zeros_like(u)
        thrust = torch.stack([zeros, zeros, self.kf * u + self.bf], dim=-1)
        arms = self._const(self.motor_dist * self._ss, x)
        return torque + torch.linalg.cross(
            arms.expand_as(thrust), thrust, dim=-1).sum(dim=-2)

    def _ode(self, x: Tensor, u: Tensor) -> Tensor:
        u = self.act_scale * u
        m, v, w = x[..., 3:6], x[..., 6:9], x[..., 9:]
        F = self._forces(x, u)
        tau = self._moments(x, u)
        rdot = quat_rotate(mrp_to_quat(m), v)
        mdot = mrp_kinematics(m, w)
        vdot = F / self.m - torch.linalg.cross(w, v, dim=-1)
        J, Jinv = self._const(self._J, x), self._const(self._Jinv, x)
        Jw = w @ J.T
        wdot = (tau - torch.linalg.cross(w, Jw, dim=-1)) @ Jinv.T
        return torch.cat([rdot, mdot, vdot, wdot], dim=-1)

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        return rk4(self._ode, x, u, self.dt)

    def hover_thrust(self) -> Tensor:
        """Per-rotor control that balances gravity and the thrust bias
        (float64)."""
        per_rotor = (self.m * 9.81 - 4.0 * self.bf) / (4.0 * self.kf)
        return torch.full((self.nu,), per_rotor / self.act_scale,
                          dtype=torch.float64)

    # --- the closed form of K2's functor ---
    def kernel_params(self) -> Tuple[float, ...]:
        kd = 0.5 * 1.27 * self._cd * self._cross_A
        arms = self.motor_dist * self._ss
        return ((self.act_scale, self.kf, self.bf, 4.0 * self.bf, self.km,
                 self.m, -9.81 * self.m, *kd, *arms[:, 0], *arms[:, 1])
                + tuple(self._J.reshape(-1)) + tuple(self._Jinv.reshape(-1))
                + (self.dt, 0.5 * self.dt, self.dt / 6.0))

    def _ode_parts(self, p, xs, us):
        """ẋ from the coordinates: q = quat(m) = (qs, q⃗); gravity (0, 0,
        gz) rotated by q's conjugate, drag −sign(m)·kd·m², thrust and bias
        along z; τ from the rotors' yaw drag and arms; ṙ = q v q*, ṁ =
        ¼A(m)ω, v̇ = F/m − ω×v, ω̇ = J⁻¹(τ − ω×Jω)."""
        m0, m1, m2 = xs[3:6]
        v = xs[6:9]
        w = xs[9:12]
        u = [p["act"] * ui for ui in us]
        sq = m0 * m0 + m1 * m1 + m2 * m2
        inv = 1.0 / (1.0 + sq)
        qs = (1.0 - sq) * inv
        q = (2 * m0 * inv, 2 * m1 * inv, 2 * m2 * inv)
        ss = qs * qs - (q[0] * q[0] + q[1] * q[1] + q[2] * q[2])
        # forces in the body frame
        g = p["gz"]
        qg = [qi * g for qi in q]
        df = [-(_sign(mi) * p[f"kd{i}"]) * mi * mi
              for i, mi in enumerate((m0, m1, m2))]
        F_z = p["kf"] * (u[0] + u[1] + u[2] + u[3])
        F = ((2 * q[0]) * qg[2] - (2 * qs) * qg[1] + df[0],
             (2 * q[1]) * qg[2] + (2 * qs) * qg[0] + df[1],
             ss * g + (2 * q[2]) * qg[2] + df[2] + F_z + p["bf4"])
        # moments
        Mk = [p["km"] * ui for ui in u]
        thrust = [p["kf"] * ui + p["bf"] for ui in u]
        t0 = p["ay0"] * thrust[0]
        t1 = -(p["ax0"] * thrust[0])
        for k in range(1, 4):
            t0 = t0 + p[f"ay{k}"] * thrust[k]
            t1 = t1 - p[f"ax{k}"] * thrust[k]
        tau = (t0, t1, Mk[0] - Mk[1] + Mk[2] - Mk[3])
        # kinematics
        dqr = q[0] * v[0] + q[1] * v[1] + q[2] * v[2]
        c = _cross(q, v)
        rdot = tuple(ss * v[i] + (2 * q[i]) * dqr + (2 * qs) * c[i]
                     for i in range(3))
        p00, p11, p22 = m0 * m0, m1 * m1, m2 * m2
        A = ((1 + p00 - p11 - p22, 2 * (m0 * m1 - m2), 2 * (m0 * m2 + m1)),
             (2 * (m1 * m0 + m2), 1 - p00 + p11 - p22, 2 * (m1 * m2 - m0)),
             (2 * (m2 * m0 - m1), 2 * (m2 * m1 + m0), 1 - p00 - p11 + p22))
        mdot = tuple(0.25 * (r[0] * w[0] + r[1] * w[1] + r[2] * w[2])
                     for r in A)
        wxv = _cross(w, v)
        vdot = tuple(F[i] / p["mass"] - wxv[i] for i in range(3))
        Jw = tuple(p[f"J{i}0"] * w[0] + p[f"J{i}1"] * w[1]
                   + p[f"J{i}2"] * w[2] for i in range(3))
        wxJw = _cross(w, Jw)
        rhs = tuple(tau[i] - wxJw[i] for i in range(3))
        wdot = tuple(p[f"Ji{i}0"] * rhs[0] + p[f"Ji{i}1"] * rhs[1]
                     + p[f"Ji{i}2"] * rhs[2] for i in range(3))
        return rdot + mdot + vdot + wdot


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])
