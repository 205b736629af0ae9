"""Imitation losses (port of diff_qp_mpc_tpu.learning.losses).

Masked L1 supervision of every DEQ-MPC iterate; loss_end reports the final
iterate alone (the trainer logs both as losses/loss_avg and
losses/loss_end).
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from diff_qp_mpc_tpu_torch.learning.policies import DEQMPCRollout

Tensor = torch.Tensor


def _masked_l1(pred: Tensor, gt: Tensor, mask: Tensor) -> Tensor:
    """Σ_features |err| masked per step, mean over (batch, T)."""
    return ((pred - gt) * mask[:, :, None]).abs().sum(dim=-1).mean()


def iterate_loss(out_type: int, gt_states: Tensor, gt_actions: Tensor,
                 mask: Tensor, states: Tensor, actions: Tensor,
                 action_weight: float = 0.0) -> Tensor:
    loss = 0.0
    if out_type in (0, 2):
        loss += _masked_l1(actions, gt_actions, mask)
    if out_type in (1, 2):
        loss += _masked_l1(states, gt_states, mask)
    if out_type == 3:
        nq = gt_states.shape[-1] // 2
        loss += _masked_l1(states[..., :nq], gt_states[..., :nq], mask)
    if action_weight > 0.0 and out_type in (1, 3):
        # scale-normalized action term: the raw action L1 of out_type 2
        # dominates the state term for large-force robots; a small weight
        # (e.g. 1/u_max) keeps the feedback supervision without that
        loss += action_weight * _masked_l1(actions, gt_actions, mask)
    return loss


def compute_loss_deqmpc(out_type: int, gt_states, gt_actions, mask,
                        iterates: List[DEQMPCRollout],
                        action_weight: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Supervise the MPC-projected trajectory of every iterate."""
    loss = 0.0
    for it in iterates:
        loss = loss + iterate_loss(out_type, gt_states, gt_actions, mask,
                                   it.states, it.actions, action_weight)
    last = iterates[-1]
    loss_end = iterate_loss(out_type, gt_states, gt_actions, mask,
                            last.states, last.actions, action_weight)
    return loss, loss_end


def compute_loss_deq(gt_states, gt_actions, mask,
                     iterates: List[DEQMPCRollout]) -> Tuple[Tensor, Tensor]:
    """Pretraining: supervise the raw network proposals, state-only
    (out_type 1)."""
    loss = 0.0
    for it in iterates:
        loss = loss + iterate_loss(1, gt_states, gt_actions, mask,
                                   it.net_states, it.actions)
    last = iterates[-1]
    loss_end = iterate_loss(1, gt_states, gt_actions, mask,
                            last.net_states, last.actions)
    return loss, loss_end


def compute_loss_bc(out_type: int, gt_states, gt_actions, mask,
                    states, actions) -> Tuple[Tensor, Tensor]:
    """Vanilla behavior cloning."""
    loss = iterate_loss(out_type, gt_states, gt_actions, mask, states,
                        actions)
    return loss, torch.zeros((), dtype=gt_states.dtype,
                             device=gt_states.device)
