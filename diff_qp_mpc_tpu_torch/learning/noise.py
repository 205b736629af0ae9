"""Observation-corruption modes (port of diff_qp_mpc_tpu.learning.noise).

Modes: 0 none; 1 gaussian; 2 uniform; 3 element-drop-to-zero;
4 vector-drop-to-zero; 5 element-hold-previous; 6 vector-hold-previous.
states: [bsz, T, nx]; for modes 3-6 ``noise_mean`` is the drop probability.
Random numbers come from ``generator`` (a CPU ``torch.Generator``) and are
moved to the states' device.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def corrupt_observation(generator: torch.Generator, states: Tensor,
                        noise_type: int, noise_std: float = 0.0,
                        noise_mean: float = 0.0) -> Tensor:
    bsz, T, nx = states.shape
    if noise_type == 0:
        return states

    def draw(fn, *shape):
        return fn(*shape, generator=generator, dtype=states.dtype).to(
            states.device)

    if noise_type == 1:
        return states + draw(torch.randn, bsz, T, nx) * noise_std + noise_mean
    if noise_type == 2:
        return states + 2.0 * (draw(torch.rand, bsz, T, nx) - 0.5) \
            * noise_std + noise_mean
    prev = torch.roll(states, 1, dims=1)
    if noise_type in (3, 5):
        keep = draw(torch.rand, bsz, T, nx) > noise_mean
    elif noise_type in (4, 6):
        keep = (draw(torch.rand, bsz, T) > noise_mean)[:, :, None] \
            .expand(bsz, T, nx)
    else:
        raise NotImplementedError(noise_type)
    fill = torch.zeros_like(states) if noise_type in (3, 4) else prev
    return torch.where(keep, states, fill)
