"""DEQ (deep-equilibrium) network layers, mlp cell (port of
diff_qp_mpc_tpu.learning.deq: DEQCell, DEQLayer).

Parameter names follow ``torch.nn``; ``utils.checkpoint.params_from_flax``
maps a flax parameter tree onto them. LayerNorms use flax's eps of 1e-6,
and parameters start from flax's initial distributions (``flax_init``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

Tensor = torch.Tensor

LN_EPS = 1e-6  # flax.linen.LayerNorm's default (torch's is 1e-5)
# std of the standard normal truncated to [-2, 2]: lecun_normal divides by
# it so that the truncated draw has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def flax_init(module: nn.Module) -> None:
    """flax.linen's initial distributions on every Linear and LayerNorm of
    ``module``: Dense kernels lecun_normal (a normal truncated at two
    standard deviations, variance 1/fan_in), zero biases; LayerNorm scale 1
    and bias 0. (``nn.Linear``'s own are Kaiming-uniform weights and uniform
    biases.)"""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class DEQCell(nn.Module):
    """Weight-tied residual cell:
    z₁ = ln_z1(relu(fc1(z)));  out = ln_out(relu(z₁ + ln_inner(x + fc2(z₁))))."""

    def __init__(self, hdim: int):
        super().__init__()
        self.fc1 = nn.Linear(hdim, hdim)
        self.ln_z1 = nn.LayerNorm(hdim, eps=LN_EPS)
        self.fc2 = nn.Linear(hdim, hdim)
        self.ln_inner = nn.LayerNorm(hdim, eps=LN_EPS)
        self.ln_out = nn.LayerNorm(hdim, eps=LN_EPS)

    def forward(self, x: Tensor, z: Tensor) -> Tensor:
        z1 = self.ln_z1(torch.relu(self.fc1(z)))
        return self.ln_out(torch.relu(z1 + self.ln_inner(x + self.fc2(z1))))


class DEQLayer(nn.Module):
    """One equilibrium iteration: encode the trajectory estimate, run the
    cell, decode a refined trajectory. out_type 1 returns the state
    prediction x₁..x_{T−1} [bsz, T-1, nx], out_type 2 the estimate and
    prediction [bsz, T, nx]; configuration channels integrate Δq·dt from the
    current state."""

    def __init__(self, nx: int, nu: int, nq: int, T: int, hdim: int,
                 dt: float, out_type: int = 2, layer_type: str = "mlp"):
        super().__init__()
        if layer_type != "mlp":
            raise NotImplementedError(f"layer_type {layer_type!r}: only the "
                                      "mlp cell is ported")
        if out_type not in (1, 2):
            raise NotImplementedError(f"out_type {out_type}: only 1 and 2 "
                                      "are ported")
        self.nx, self.nu, self.nq, self.T = nx, nu, nq, T
        self.hdim, self.dt, self.out_type = hdim, dt, out_type
        self.inp = nn.Linear(self.in_dim(), hdim)
        self.inp_ln = nn.LayerNorm(hdim, eps=LN_EPS)
        self.cell = DEQCell(hdim)
        self.out = nn.Linear(hdim, self.out_dim())
        flax_init(self)

    def in_dim(self) -> int:
        return self.nx + self.nx * (self.T - 1)

    def out_dim(self) -> int:
        return self.nx * (self.T - 1 if self.out_type == 1 else self.T)

    def init_z(self, bsz: int, dtype=torch.float32, device=None) -> Tensor:
        return torch.zeros(bsz, self.hdim, dtype=dtype, device=device)

    def _integrate_cfg(self, d: Tensor, x: Tensor) -> Tensor:
        vel = d[..., self.nq:self.nx]
        q = d[..., :self.nq] * self.dt + x[:, None, :self.nq]
        return torch.cat([q, vel], dim=-1)

    def forward(self, x: Tensor, traj_flat: Tensor, z: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """x: [bsz, nx] current state; traj_flat: [bsz, in_dim] flattened
        trajectory estimate; z: [bsz, hdim] equilibrium latent."""
        z_out = self.cell(self.inp_ln(self.inp(traj_flat)), z)
        out = self.out(z_out)
        Td = self.T - 1 if self.out_type == 1 else self.T
        return self._integrate_cfg(out.reshape(-1, Td, self.nx), x), z_out
