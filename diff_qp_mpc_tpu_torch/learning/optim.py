"""optax's transformations that the port's trainers use, by hand:
``cosine_decay``, ``global_norm``, ``clip_by_global_norm`` and ``adam`` on
named parameters (the DEQ-MPC trainer, ``learning.train``, and the RL
experts, ``learning.rl``)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Union

import torch

Tensor = torch.Tensor


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.1
                 ) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(lr, decay_steps, alpha): lr·((1−α)·½(1 +
    cos(π·min(t, decay_steps)/decay_steps)) + α) at update count t."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t
                                                       / decay_steps))
                     + alpha)

    return schedule


def global_norm(grads: Dict[str, Tensor]) -> Tensor:
    """optax.global_norm: the 2-norm of all leaves together."""
    return torch.sqrt(sum((g * g).sum() for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, Tensor], max_norm: float,
                        norm: Tensor) -> Dict[str, Tensor]:
    """optax.clip_by_global_norm: unchanged below ``max_norm``, else each
    leaf (g / norm)·max_norm."""
    if bool(norm < max_norm):
        return grads
    return {k: (g / norm) * max_norm for k, g in grads.items()}


class Adam:
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8 outside the square root,
    bias-corrected moments, on named parameters; ``lr`` is a float or a
    schedule of the update count (optax evaluates it at the count before
    the update). ``step`` updates the parameters in place."""

    def __init__(self, params: Dict[str, Tensor],
                 lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor]) -> None:
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - self.b1) * g + self.b1 * self.mu[k]
            self.nu[k] = (1 - self.b2) * g * g + self.b2 * self.nu[k]
            p -= lr * ((self.mu[k] / c1)
                       / (torch.sqrt(self.nu[k] / c2) + self.eps))

    def state_dict(self) -> Dict:
        """The checkpoint's ``opt_state``: the update count and both
        moments, numpy leaves keyed by parameter name."""
        as_np = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}
        return {"count": self.count, "mu": as_np(self.mu),
                "nu": as_np(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for name, moments in (("mu", self.mu), ("nu", self.nu)):
            for k, p in self.params.items():
                moments[k] = torch.tensor(state[name][k]).to(p)
