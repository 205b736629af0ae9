"""N-dimensional double integrator (port of
diff_qp_mpc_tpu.models.integrator): semi-implicit Euler on (pos, vel) with
acceleration control, nx = 2·nu."""
from __future__ import annotations

import torch

from diff_qp_mpc_tpu_torch.models.base import DynamicsModel

Tensor = torch.Tensor


class Integrator(DynamicsModel):
    def __init__(self, nx: int = 2, nu: int = 1, dt: float = 0.1,
                 max_acc: float = 1.0, max_vel: float = 1.0):
        if nx != 2 * nu:
            raise ValueError(f"the integrator's state is (pos, vel) pairs: "
                             f"nx {nx} != 2·nu {2 * nu}")
        self.nx, self.nu, self.nq = nx, nu, nu
        self.dt = dt
        self.max_acc = max_acc
        self.max_vel = max_vel

    def step_parts(self, xs, us):
        """Coordinate-wise step on tuples of tensors (K2's functor for nq
        1, ``csrc/al_fused_integrator.cu``)."""
        nq = self.nq
        pos, vel = xs[:nq], xs[nq:]
        vel_n = tuple(vel[i] + us[i] * self.dt for i in range(nq))
        pos_n = tuple(pos[i] + vel_n[i] * self.dt for i in range(nq))
        return pos_n + vel_n

    def step(self, x: Tensor, u: Tensor) -> Tensor:
        return torch.stack(self.step_parts(x.unbind(-1), u.unbind(-1)), -1)

    def jac(self, x: Tensor, u: Tensor):
        """Exact Jacobians, as forward-mode differentiation of ``step``
        evaluates them: A = [[I, dt·I], [0, I]], B = [[dt·dt·I], [dt·I]]
        (dt·dt in the state's dtype)."""
        nq, lead = self.nq, x.shape[:-1]
        kw = dict(dtype=x.dtype, device=x.device)
        eye = torch.eye(nq, **kw)
        dt = torch.tensor(self.dt, **kw)
        zero = torch.zeros(nq, nq, **kw)
        A = torch.cat([torch.cat([eye, dt * eye], -1),
                       torch.cat([zero, eye], -1)], -2)
        B = torch.cat([(dt * dt) * eye, dt * eye], -2)
        return self.step(x, u), (A.expand(*lead, *A.shape),
                                 B.expand(*lead, *B.shape))

    def action_clip(self, u: Tensor) -> Tensor:
        return torch.clamp(u, -self.max_acc, self.max_acc)
