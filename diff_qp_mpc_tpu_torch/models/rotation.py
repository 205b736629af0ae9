"""Quaternion and modified-Rodrigues-parameter (MRP) attitude maths (port of
diff_qp_mpc_tpu.models.rotation).

The standard formulas of Markley & Crassidis, *Fundamentals of Spacecraft
Attitude Determination and Control* (eq. 3.24 for the MRP kinematics).
Quaternions are scalar-first (w, x, y, z); every function works over
leading batch axes.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mrp_to_quat(m: Tensor) -> Tensor:
    """MRP → unit quaternion: q = (1 − |m|², 2m) / (1 + |m|²)."""
    sq = (m * m).sum(dim=-1, keepdim=True)
    return torch.cat([1.0 - sq, 2.0 * m], dim=-1) / (1.0 + sq)


def quat_to_mrp(q: Tensor) -> Tensor:
    """Unit quaternion → MRP: m = q_v / (1 + q_w)."""
    return q[..., 1:] / (1.0 + q[..., :1])


def quat_rotate(q: Tensor, r: Tensor) -> Tensor:
    """Rotate the vector r by the quaternion q (active rotation)."""
    qs, qv = q[..., :1], q[..., 1:]
    cross = torch.linalg.cross(qv, r, dim=-1)
    return ((qs ** 2 - (qv * qv).sum(dim=-1, keepdim=True)) * r
            + 2.0 * qv * (qv * r).sum(dim=-1, keepdim=True)
            + 2.0 * qs * cross)


def mrp_to_rot(m: Tensor) -> Tensor:
    """MRP → rotation matrix [..., 3, 3] (through the quaternion)."""
    q = mrp_to_quat(m)
    qs, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y ** 2 + z ** 2), 2 * (x * y - qs * z),
                     2 * (x * z + qs * y)], -1),
        torch.stack([2 * (x * y + qs * z), 1 - 2 * (x ** 2 + z ** 2),
                     2 * (y * z - qs * x)], -1),
        torch.stack([2 * (x * z - qs * y), 2 * (y * z + qs * x),
                     1 - 2 * (x ** 2 + y ** 2)], -1),
    ], dim=-2)


def mrp_kinematics(p: Tensor, w: Tensor) -> Tensor:
    """ṗ = ¼ A(p) ω, A = (1 + pᵀp)I + 2[p×]² + 2[p×] (Markley & Crassidis
    eq. 3.24)."""
    p0, p1, p2 = p.unbind(-1)
    A = torch.stack([
        torch.stack([1 + p0 ** 2 - p1 ** 2 - p2 ** 2, 2 * (p0 * p1 - p2),
                     2 * (p0 * p2 + p1)], -1),
        torch.stack([2 * (p1 * p0 + p2), 1 - p0 ** 2 + p1 ** 2 - p2 ** 2,
                     2 * (p1 * p2 - p0)], -1),
        torch.stack([2 * (p2 * p0 - p1), 2 * (p2 * p1 + p0),
                     1 - p0 ** 2 - p1 ** 2 + p2 ** 2], -1),
    ], dim=-2)
    return 0.25 * (A @ w[..., None])[..., 0]


def euler_to_quat(roll: Tensor, pitch: Tensor, yaw: Tensor) -> Tensor:
    """XYZ Euler angles → quaternion (scalar-first)."""
    cr, sr = torch.cos(roll / 2), torch.sin(roll / 2)
    cp, sp = torch.cos(pitch / 2), torch.sin(pitch / 2)
    cy, sy = torch.cos(yaw / 2), torch.sin(yaw / 2)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)
