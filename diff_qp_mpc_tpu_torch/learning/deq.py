"""DEQ (deep-equilibrium) network layers and the baseline networks (port of
diff_qp_mpc_tpu.learning.deq).

- ``DEQCell`` (mlp) and ``DEQConvCell`` (temporal convolutions over the
  horizon, the reference's "gcn" layer type), and ``DEQLayer``: encode the
  trajectory estimate, run the cell, decode a refined trajectory, for
  out_types 0-4.
- ``anderson``: Anderson acceleration with a fixed trip count, and
  ``deq_fixed_point``: the fixed point with the DEQ implicit backward,
  solved by the same acceleration.
- ``DEQPolicy`` (the pure-DEQ baseline), ``FFDNetwork`` and ``NNPolicy``
  (the behaviour-cloning MLP).

Parameter names follow ``torch.nn``; each network's ``flax_modules()`` gives
the (flax module path, port module path) pairs with which
``utils.checkpoint.params_from_flax`` maps a flax parameter tree onto its
``state_dict``. LayerNorm and GroupNorm use flax's eps of 1e-6, and
parameters start from flax's initial distributions (``flax_init``). The
convolutions run channels-first, as ``torch.nn.Conv1d`` does; the layer
keeps flax's channels-last [bsz, T, hdim] between them.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
Modules = Tuple[Tuple[str, str], ...]

LN_EPS = 1e-6  # flax.linen.LayerNorm's and GroupNorm's default (torch's 1e-5)
# std of the standard normal truncated to [-2, 2]: lecun_normal divides by
# it so that the truncated draw has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978
TIME_EMB_STD = 0.02  # flax's normal(0.02) init of the conv layer's time_emb


def flax_init(module: nn.Module) -> None:
    """flax.linen's initial distributions on every Linear, Conv1d, LayerNorm
    and GroupNorm of ``module``: Dense and Conv kernels lecun_normal (a
    normal truncated at two standard deviations, variance 1/fan_in, fan_in
    = input channels × kernel width), zero biases; norm scales 1 and biases
    0. (``torch.nn``'s own are Kaiming-uniform weights and uniform
    biases.)"""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


def prefixed(prefix: Tuple[str, str], modules: Modules) -> Modules:
    """``modules``' (flax path, port path) pairs under a submodule's
    (flax name, port attribute)."""
    return tuple((f"{prefix[0]}/{f}", f"{prefix[1]}.{p}")
                 for f, p in modules)


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

    @staticmethod
    def flax_modules() -> Modules:
        # flax names modules in construction order, and Python constructs
        # a callee before its arguments: in ``LayerNorm()(relu(z1 +
        # LayerNorm()(x + Dense(z1))))`` the outer LayerNorm is LayerNorm_1
        return (("Dense_0", "fc1"), ("LayerNorm_0", "ln_z1"),
                ("Dense_1", "fc2"), ("LayerNorm_1", "ln_out"),
                ("LayerNorm_2", "ln_inner"))


class DEQConvCell(nn.Module):
    """Temporal-convolution weight-tied cell over the horizon axis (x, z:
    [bsz, T, hdim]):
    z₁ = gn1(mish(conv1(z)));  inner = gn_inner(x + conv2(z₁));
    out = gn_out(mish(res(z₁) + inner)), with conv1 hdim → EXPAND·hdim and
    conv2 back at KERNEL_WIDTH ("SAME" padding), res a 1×1 conv, GROUPS
    groups in each GroupNorm."""

    KERNEL_WIDTH, EXPAND, GROUPS = 3, 4, 4

    def __init__(self, hdim: int):
        super().__init__()
        wide, kw, groups = hdim * self.EXPAND, self.KERNEL_WIDTH, self.GROUPS
        self.conv1 = nn.Conv1d(hdim, wide, kw, padding="same")
        self.conv2 = nn.Conv1d(wide, hdim, kw, padding="same")
        self.gn1 = nn.GroupNorm(groups, wide, eps=LN_EPS)
        self.gn_inner = nn.GroupNorm(groups, hdim, eps=LN_EPS)
        self.res = nn.Conv1d(wide, hdim, 1)
        self.gn_out = nn.GroupNorm(groups, hdim, eps=LN_EPS)

    def forward(self, x: Tensor, z: Tensor) -> Tensor:
        xc, zc = x.transpose(1, 2), z.transpose(1, 2)  # [bsz, hdim, T]
        z1 = self.gn1(F.mish(self.conv1(zc)))
        inner = self.gn_inner(xc + self.conv2(z1))
        out = self.gn_out(F.mish(self.res(z1) + inner))
        return out.transpose(1, 2)

    @staticmethod
    def flax_modules() -> Modules:
        return (("Conv_0", "conv1"), ("Conv_1", "conv2"),
                ("GroupNorm_0", "gn1"), ("GroupNorm_1", "gn_inner"),
                ("Conv_2", "res"), ("GroupNorm_2", "gn_out"))


#: the mlp DEQLayer's (flax path, port path) pairs
MLP_LAYER_MODULES: Modules = (
    ("Dense_0", "inp"), ("LayerNorm_0", "inp_ln"),
    *prefixed(("DEQCell_0", "cell"), DEQCell.flax_modules()),
    ("Dense_1", "out"))
#: the conv DEQLayer's
CONV_LAYER_MODULES: Modules = (
    ("Dense_0", "node_emb"), ("Dense_1", "x_emb"), ("time_emb", "time_emb"),
    ("LayerNorm_0", "inp_ln"),
    *prefixed(("DEQConvCell_0", "cell"), DEQConvCell.flax_modules()),
    ("Dense_2", "out"))


class DEQLayer(nn.Module):
    """One equilibrium iteration: encode the trajectory estimate, run the
    cell, decode a refined trajectory. forward returns (trajectory, z):

      0: [bsz, T, nu] control sequence
      1: [bsz, T-1, nx] state prediction x₁..x_{T−1}
      2: [bsz, T, nx] state estimate and prediction
      3: [bsz, T-1, nx+nu] / 4: [bsz, T, nx+nu] states and controls

    Configuration channels integrate Δq·dt from the current state. The mlp
    cell's z is [bsz, hdim]; the conv cell's [bsz, T, hdim], and its input
    is the estimate's first T·nx entries as T nodes, plus an embedding of
    the current state and a learned time embedding."""

    def __init__(self, nx: int, nu: int, nq: int, T: int, hdim: int,
                 dt: float, out_type: int = 2, layer_type: str = "mlp"):
        super().__init__()
        if layer_type not in ("mlp", "conv"):
            raise ValueError(f"layer_type must be 'mlp' or 'conv', got "
                             f"{layer_type!r}")
        if out_type not in range(5):
            raise ValueError(f"out_type must be 0-4, got {out_type}")
        self.nx, self.nu, self.nq, self.T = nx, nu, nq, T
        self.hdim, self.dt, self.out_type = hdim, dt, out_type
        self.layer_type = layer_type
        if layer_type == "conv":
            self.node_emb = nn.Linear(nx, hdim)
            self.x_emb = nn.Linear(nx, hdim)
            self.time_emb = nn.Parameter(torch.empty(T, hdim))
            self.inp_ln = nn.LayerNorm(hdim, eps=LN_EPS)
            self.cell = DEQConvCell(hdim)
            self.out = nn.Linear(T * hdim, self.out_dim())
        else:
            self.inp = nn.Linear(self.in_dim(), hdim)
            self.inp_ln = nn.LayerNorm(hdim, eps=LN_EPS)
            self.cell = DEQCell(hdim)
            self.out = nn.Linear(hdim, self.out_dim())
        flax_init(self)
        if layer_type == "conv":
            nn.init.normal_(self.time_emb, std=TIME_EMB_STD)

    def in_dim(self) -> int:
        nx, nu, T = self.nx, self.nu, self.T
        return {0: nu * T, 1: nx * T, 2: nx * T, 3: (nx + nu) * T,
                4: (nx + nu) * T}[self.out_type]

    def out_dim(self) -> int:
        nx, nu, T = self.nx, self.nu, self.T
        return {0: nu * T, 1: nx * (T - 1), 2: nx * T,
                3: (nx + nu) * (T - 1), 4: (nx + nu) * T}[self.out_type]

    def flax_modules(self) -> Modules:
        return (CONV_LAYER_MODULES if self.layer_type == "conv"
                else MLP_LAYER_MODULES)

    def init_z(self, bsz: int, dtype=torch.float32, device=None) -> Tensor:
        shape = ((bsz, self.T, self.hdim) if self.layer_type == "conv"
                 else (bsz, self.hdim))
        return torch.zeros(shape, dtype=dtype, device=device)

    def _integrate_cfg(self, d: Tensor, x: Tensor) -> Tensor:
        vel = d[..., self.nq:self.nx]
        q = d[..., :self.nq] * self.dt + x[:, None, :self.nq]
        return torch.cat([q, vel], dim=-1)

    def forward(self, x: Tensor, traj_flat: Tensor, z: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """x: [bsz, nx] current state; traj_flat: [bsz, in_dim] flattened
        trajectory estimate (the conv cell reads its first T·nx entries);
        z: the equilibrium latent (``init_z``'s shape)."""
        bsz = x.shape[0]
        if self.layer_type == "conv":
            nodes = traj_flat.reshape(bsz, -1)[:, :self.T * self.nx].reshape(
                bsz, self.T, self.nx)
            inp = self.inp_ln(self.node_emb(nodes) + self.x_emb(x)[:, None]
                              + self.time_emb[None])
            z_out = self.cell(inp, z)
            out = self.out(z_out.reshape(bsz, -1))
        else:
            z_out = self.cell(self.inp_ln(self.inp(traj_flat)), z)
            out = self.out(z_out)
        T, nx = self.T, self.nx
        if self.out_type == 0:
            return out.reshape(-1, T, self.nu), z_out
        if self.out_type in (1, 2):
            Td = T - 1 if self.out_type == 1 else T
            return self._integrate_cfg(out.reshape(-1, Td, nx), x), z_out
        Td = T - 1 if self.out_type == 3 else T
        d = out.reshape(-1, Td, nx + self.nu)
        return torch.cat([self._integrate_cfg(d[..., :nx], x), d[..., nx:]],
                         dim=-1), z_out


# ------------------------------------------------------ fixed points ----
ANDERSON_M, ANDERSON_LAM = 5, 1e-4  # history slots, Gram regularization


def anderson(f: Callable[[Tensor], Tensor], z0: Tensor, max_iter: int = 15
             ) -> Tuple[Tensor, Tensor]:
    """Anderson acceleration with a fixed trip count: slots 0 and 1 hold z0
    and f(z0), then max_iter − 2 iterations each solve the masked
    (m+1)×(m+1) system (m = ANDERSON_M, the Gram matrix regularized by
    ANDERSON_LAM) over the filled slots, take the mix Σ αᵢ f(xᵢ) (the JAX
    package's β 1) and write slot k mod m. No early exit. Returns (the
    iterate in slot (max_iter−1) mod m, the mean relative residual
    ‖f(x)−x‖/(1e-5+‖f(x)‖) of each iteration [max_iter], entries 0 and 1
    zero)."""
    m, lam = ANDERSON_M, ANDERSON_LAM
    bsz = z0.shape[0]
    d = z0.reshape(bsz, -1).shape[1]
    kw = dict(dtype=z0.dtype, device=z0.device)
    X = torch.zeros(bsz, m, d, **kw)
    Fv = torch.zeros(bsz, m, d, **kw)
    X[:, 0] = z0.reshape(bsz, -1)
    Fv[:, 0] = f(z0).reshape(bsz, -1)
    X[:, 1] = Fv[:, 0]
    Fv[:, 1] = f(Fv[:, 0].reshape(z0.shape)).reshape(bsz, -1)

    H0 = torch.zeros(bsz, m + 1, m + 1, **kw)
    H0[:, 0, 1:] = 1.0
    H0[:, 1:, 0] = 1.0
    y = torch.zeros(bsz, m + 1, 1, **kw)
    y[:, 0] = 1.0
    eye_m = torch.eye(m, **kw)
    eye_m1 = torch.eye(m + 1, **kw)
    idx = torch.arange(m + 1, device=z0.device)
    res_hist = torch.zeros(max_iter, **kw)
    for k in range(2, max_iter):
        n = min(k, m)
        col_mask = (torch.arange(m, device=z0.device) < n).to(z0.dtype)
        G = (Fv - X) * col_mask[None, :, None]
        H = H0.clone()
        H[:, 1:, 1:] = G @ G.transpose(1, 2) + lam * eye_m
        # rows and columns beyond n: identity, so alpha there solves to 0
        beyond = (idx[None, :] > n) | (idx[:, None] > n)
        H = torch.where(beyond[None], eye_m1[None], H)
        alpha = torch.linalg.solve(H, y)[:, 1:, 0] * col_mask[None]
        xk = torch.einsum("bm,bmd->bd", alpha, Fv)
        fk = f(xk.reshape(z0.shape)).reshape(bsz, -1)
        X[:, k % m] = xk
        Fv[:, k % m] = fk
        res = torch.linalg.vector_norm(fk - xk, dim=-1) / (
            1e-5 + torch.linalg.vector_norm(fk, dim=-1))
        res_hist[k] = res.mean()
    return X[:, (max_iter - 1) % m].reshape(z0.shape), res_hist


class _FixedPoint(torch.autograd.Function):
    """z* = f(anderson(f, z0)); the backward solves h = (∂f/∂z)ᵀh + ḡ by
    Anderson at z* and returns (∂f/∂θ)ᵀh* for every tensor in ``params``
    and zero for z0."""

    @staticmethod
    def forward(ctx, f, fwd_iter, bwd_iter, z0, *params):
        z, _ = anderson(f, z0, max_iter=fwd_iter)
        z_star = f(z)  # one step re-attached, as the reference's f(z, x)
        ctx.f, ctx.bwd_iter = f, bwd_iter
        ctx.save_for_backward(z_star, *params)
        return z_star

    @staticmethod
    def backward(ctx, g):
        z_star, *params = ctx.saved_tensors
        with torch.enable_grad():
            z = z_star.detach().requires_grad_(True)
            fz = ctx.f(z)
            wanted = [p for p in params if p.requires_grad]

            def vjp_z(h):
                return torch.autograd.grad(fz, z, h, retain_graph=True)[0]

            h_star, _ = anderson(lambda h: vjp_z(h) + g, g,
                                 max_iter=ctx.bwd_iter)
            cts = iter(torch.autograd.grad(fz, wanted, h_star,
                                           allow_unused=True))
        arg_cts = [next(cts) if p.requires_grad else None for p in params]
        return (None, None, None, torch.zeros_like(z_star), *arg_cts)


def deq_fixed_point(f: Callable[[Tensor], Tensor], z0: Tensor,
                    params: Sequence[Tensor], fwd_iter: int = 15,
                    bwd_iter: int = 15) -> Tensor:
    """The fixed point z* = f(z*) with the exact DEQ implicit VJP: forward
    by Anderson iteration (no graph kept) and one more application of f;
    backward h* = (∂f/∂z)ᵀh* + ḡ solved by Anderson at z*, then (∂f/∂θ)ᵀh*.
    ``params`` are the tensors ``f`` closes over that gradients flow to,
    an input encoding included (as the JAX package's closure_convert hoists
    them); z0 gets a zero gradient."""
    return _FixedPoint.apply(f, fwd_iter, bwd_iter, z0, *params)


class DEQPolicy(nn.Module):
    """Pure-DEQ baseline policy: encode the state, solve the cell's fixed
    point, decode a T-step state reference [bsz, T, nx], plus 10·x."""

    def __init__(self, nx: int, T: int, hdim: int, fwd_iter: int = 15):
        super().__init__()
        self.nx, self.T, self.hdim, self.fwd_iter = nx, T, hdim, fwd_iter
        self.inp = nn.Linear(nx, hdim)
        self.inp_ln = nn.LayerNorm(hdim, eps=LN_EPS)
        self.cell = DEQCell(hdim)
        self.out = nn.Linear(hdim, nx * T)
        flax_init(self)

    @staticmethod
    def flax_modules() -> Modules:
        return MLP_LAYER_MODULES  # the same names at the policy's root

    def init_z(self, x: Tensor) -> Tensor:
        return x.new_zeros(x.shape[0], self.hdim)

    def forward(self, x: Tensor) -> Tensor:
        xinp = self.inp_ln(self.inp(x))
        z_star = deq_fixed_point(lambda z: self.cell(xinp, z),
                                 self.init_z(x), [xinp,
                                                  *self.cell.parameters()],
                                 fwd_iter=self.fwd_iter)
        x_ref = self.out(z_star).reshape(-1, self.T, self.nx)
        return x_ref + x[:, None, :self.nx] * 10.0


# ------------------------------------------------- behaviour cloning ----
class _MLPTrunk(nn.Module):
    """relu(LayerNorm(Dense(·))) twice, flax's construction order."""

    def __init__(self, n_in: int, hdim: int, n_out: int):
        super().__init__()
        self.fc0 = nn.Linear(n_in, hdim)
        self.ln0 = nn.LayerNorm(hdim, eps=LN_EPS)
        self.fc1 = nn.Linear(hdim, hdim)
        self.ln1 = nn.LayerNorm(hdim, eps=LN_EPS)
        self.head = nn.Linear(hdim, n_out)
        flax_init(self)

    def trunk(self, x: Tensor) -> Tensor:
        h = torch.relu(self.ln0(self.fc0(x)))
        return torch.relu(self.ln1(self.fc1(h)))

    @staticmethod
    def flax_modules() -> Modules:
        return (("Dense_0", "fc0"), ("LayerNorm_0", "ln0"),
                ("Dense_1", "fc1"), ("LayerNorm_1", "ln1"),
                ("Dense_2", "head"))


class FFDNetwork(_MLPTrunk):
    """Feedforward reference-trajectory net: T positions [bsz, T, nq] as
    offsets from the current configuration."""

    def __init__(self, nx: int, nq: int, T: int, hdim: int = 256):
        super().__init__(nx, hdim, nq * T)
        self.nq, self.T = nq, T

    def forward(self, x: Tensor) -> Tensor:
        d = self.head(self.trunk(x)).reshape(-1, self.T, self.nq)
        return d + x[:, None, :self.nq]


class NNPolicy(_MLPTrunk):
    """Behaviour-cloning MLP over a horizon. forward returns (states,
    actions), None where the out_type has none: 0 controls [bsz, T, nu]; 1
    states [bsz, T, nx]; 2 both; 3 positions and their finite-difference
    velocities over dt (the last repeated) [bsz, T, 2·nq]."""

    def __init__(self, nx: int, nu: int, nq: int, T: int, hdim: int,
                 dt: float, out_type: int = 1):
        n_out = {0: nu * T, 1: nx * T, 2: (nx + nu) * T, 3: nq * T}
        if out_type not in n_out:
            raise ValueError(f"NNPolicy out_type must be 0-3, got "
                             f"{out_type}")
        super().__init__(nx, hdim, n_out[out_type])
        self.nx, self.nu, self.nq, self.T = nx, nu, nq, T
        self.dt, self.out_type = dt, out_type

    def forward(self, x: Tensor) -> Tuple[Optional[Tensor],
                                          Optional[Tensor]]:
        out = self.head(self.trunk(x))
        T, nx, nu = self.T, self.nx, self.nu
        if self.out_type == 0:
            return None, out.reshape(-1, T, nu)
        if self.out_type == 1:
            return out.reshape(-1, T, nx), None
        if self.out_type == 2:
            return (out[:, :nx * T].reshape(-1, T, nx),
                    out[:, nx * T:].reshape(-1, T, nu))
        pos = out.reshape(-1, T, self.nq)
        vel = (pos[:, 1:] - pos[:, :-1]) / self.dt
        vel = torch.cat([vel, vel[:, -1:]], dim=1)
        return torch.cat([pos, vel], dim=-1), None
