"""Problem and solver-state dataclasses (port of diff_qp_mpc_tpu.core.types).

Layout is batch-major ``[bsz, T, ...]``; a trajectory decision variable is
``xu`` with shape ``[bsz, T, nx+nu]``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class DiagQuadCost:
    """Diagonal quadratic cost Σₜ ½ τᵀ diag(Cd) τ + cᵀ τ.

    Cd, c: [bsz, T, n] with n = nx + nu.
    """

    Cd: Tensor
    c: Tensor


@dataclasses.dataclass
class Bounds:
    """Box bounds on controls: tensors [nu] or python float tuples (the
    fused kernel takes the bounds as run-time scalars)."""

    u_lo: Union[Tensor, Sequence[float]]
    u_hi: Union[Tensor, Sequence[float]]


@dataclasses.dataclass
class Lambdas:
    """AL multipliers.

    lam_dyn [bsz, T-1, nx] on x_{t+1} − f(x_t, u_t) = 0, lam_init [bsz, nx]
    on x_0 − x0 = 0, lam_hi / lam_lo [bsz, T, nu] on the control bounds.
    """

    lam_dyn: Tensor
    lam_init: Tensor
    lam_hi: Tensor
    lam_lo: Tensor

    @staticmethod
    def zeros(bsz: int, T: int, nx: int, nu: int, dtype=torch.float32,
              device=None) -> "Lambdas":
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return Lambdas(z(bsz, T - 1, nx), z(bsz, nx), z(bsz, T, nu),
                       z(bsz, T, nu))

    def flat(self) -> Tensor:
        bsz = self.lam_init.shape[0]
        return torch.cat([self.lam_dyn.reshape(bsz, -1),
                          self.lam_init.reshape(bsz, -1),
                          self.lam_hi.reshape(bsz, -1),
                          self.lam_lo.reshape(bsz, -1)], dim=-1)

    def map(self, fn, *others: "Lambdas") -> "Lambdas":
        """Apply ``fn`` field by field (with the same fields of ``others``)."""
        return Lambdas(*(fn(getattr(self, f.name),
                            *(getattr(o, f.name) for o in others))
                         for f in dataclasses.fields(self)))


@dataclasses.dataclass
class ALState:
    """Warm-start carry for the AL-MPC solver across receding-horizon calls.

    ``hist_*`` are rolling histories of length ``hist_len`` (most recent
    entry last); ``hist_lam`` is a Lambdas with an extra leading H axis.
    """

    x: Tensor  # [bsz, T, nx]
    u: Tensor  # [bsz, T, nu]
    lam: Lambdas
    rho: Tensor  # [bsz, 1]
    hist_cost: Tensor  # [H, bsz]
    hist_lam: Lambdas
    hist_rho: Tensor  # [H, bsz, 1]
    hist_filled: int
    just_initialized: bool

    @staticmethod
    def init(bsz: int, T: int, nx: int, nu: int, hist_len: int = 3,
             dtype=torch.float32, device=None) -> "ALState":
        """hist_len = al_iter + 1 holds one solve's history exactly."""
        lam = Lambdas.zeros(bsz, T, nx, nu, dtype, device)
        kw = dict(dtype=dtype, device=device)
        return ALState(
            x=torch.zeros(bsz, T, nx, **kw),
            u=torch.zeros(bsz, T, nu, **kw),
            lam=lam,
            rho=torch.ones(bsz, 1, **kw),
            hist_cost=torch.full((hist_len, bsz), float("inf"), **kw),
            hist_lam=lam.map(lambda a: a.new_zeros((hist_len,) + a.shape)),
            hist_rho=torch.ones(hist_len, bsz, 1, **kw),
            hist_filled=0,
            just_initialized=True,
        )


@dataclasses.dataclass
class SolveStats:
    """Per-solve diagnostics."""

    dyn_res: Tensor  # [bsz] final clamped constraint-residual norm
    cost: Tensor  # [bsz] final objective
    merit: Tensor  # [bsz] final merit value
    newton_steps: int  # total Newton iterations executed
    step_size: Tensor  # [bsz] last accepted line-search step
