"""Forward-mode numbers: a value and tangents, for exact Jacobians of a
closed-form step without a tracer.

``Dual`` mirrors ``Dual<F>`` of ``csrc/al_fused_common.cuh`` operation for
operation, so a model's ``jac`` that runs its ``step_parts`` on duals does
the arithmetic kernel K2's functor does. The tangent ``d`` may carry one
extra leading axis of columns (one seed each): every column's arithmetic is
then that of a one-tangent run, the value computed once. A binary operation
needs one ``Dual`` operand; the other may be a tensor or a number (a
constant, whose tangent is 0 and costs no operation).
"""
from __future__ import annotations

import torch


def _parts(b):
    return (b.v, b.d) if isinstance(b, Dual) else (b, None)


class Dual:
    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    def __add__(self, other):
        bv, bd = _parts(other)
        return Dual(self.v + bv, self.d if bd is None else self.d + bd)

    def __radd__(self, other):
        return Dual(other + self.v, self.d)

    def __sub__(self, other):
        bv, bd = _parts(other)
        return Dual(self.v - bv, self.d if bd is None else self.d - bd)

    def __rsub__(self, other):
        return Dual(other - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, other):
        bv, bd = _parts(other)
        if bd is None:
            return Dual(self.v * bv, self.d * bv)
        return Dual(self.v * bv, self.d * bv + self.v * bd)

    def __rmul__(self, other):
        return Dual(other * self.v, other * self.d)

    def __truediv__(self, other):
        bv, bd = _parts(other)
        v = self.v / bv
        if bd is None:
            return Dual(v, self.d / bv)
        return Dual(v, (self.d - v * bd) / bv)

    def __rtruediv__(self, other):
        v = other / self.v
        return Dual(v, -(v * self.d) / self.v)

    def sin(self):
        return Dual(self.v.sin(), self.v.cos() * self.d)

    def cos(self):
        return Dual(self.v.cos(), -(self.v.sin() * self.d))

    def atan2(self, other):
        """atan2(self, other), self the sine side as in ``torch.atan2(y,
        x)``; its tangent as JAX's: ẏ·(x/(y² + x²)) + (ẋ·−y)/(y² + x²)."""
        bv, bd = _parts(other)
        den = self.v * self.v + bv * bv
        d = self.d * (bv / den)
        if bd is not None:
            d = d + (bd * -self.v) / den
        return Dual(self.v.atan2(bv), d)

    def clip(self, lo, hi):
        """The value clipped to [lo, hi]; the tangent kept inside, halved at
        a bound and zero beyond, as JAX's maximum-then-minimum gives it."""
        v = self.v
        if not isinstance(v, torch.Tensor):
            # a counting number (benchmarks.flops): the selects cost no
            # operation
            return Dual(v.clip(lo, hi), self.d)
        scale = torch.where((v > lo) & (v < hi), 1.0,
                            torch.where((v == lo) | (v == hi), 0.5, 0.0))
        return Dual(v.clip(lo, hi), self.d * scale.to(v.dtype))
