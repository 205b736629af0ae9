"""K2: the whole AL-MPC solve as one hand-written CUDA kernel
(``csrc/al_fused.cu``), the port of diff_qp_mpc_tpu.ops.al_fused_pallas.

``fused_al_solve`` takes the plain PyTorch version
(``fused_al_solve_reference``, same signature and semantics) for CPU tensors
and launches the kernel for CUDA tensors; it never falls back from one to
the other. Each kernel launch adds one to ``launches``.

The kernel runs each batch element on a group of G lanes (``GROUPS``) that
share its line search; the outputs are bit-identical at every G.
``choose_group`` is the rule that picks G from the batch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost, Lambdas
from diff_qp_mpc_tpu_torch.models.pendulum import Pendulum
from diff_qp_mpc_tpu_torch.ops import almerit, btsolve, newton_al
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: horizons with a kernel instantiation, per dtype
HORIZONS = {torch.float32: (5, 10), torch.float64: (5,)}
#: lanes per batch element the kernel takes (a power of two dividing a warp)
GROUPS = (1, 2, 4, 8, 16, 32)
#: kernel launches since the count was last set to 0
launches = 0

_SYMBOLS = {torch.float32: "al_fused_pendulum_f32",
            torch.float64: "al_fused_pendulum_f64"}
_RESIDENT_SYMBOLS = {
    torch.float32: "al_fused_pendulum_resident_threads_f32",
    torch.float64: "al_fused_pendulum_resident_threads_f64"}
# the line search's running minimum starts at float32's max in every dtype,
# as the reference kernel's does
_F32_MAX = float(torch.finfo(torch.float32).max)
# resident threads per (device index, dtype, T, G), read from the card once
_resident: dict = {}

Outputs = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]


def _fill_warm_start(B, T, nx, nu, like, lam_dyn, lam_hi, lam_lo, rho0):
    z = lambda *s: torch.zeros(s, dtype=like.dtype, device=like.device)
    lam_dyn = z(B, T - 1, nx) if lam_dyn is None else lam_dyn
    lam_hi = z(B, T, nu) if lam_hi is None else lam_hi
    lam_lo = z(B, T, nu) if lam_lo is None else lam_lo
    rho0 = (torch.ones(B, dtype=like.dtype, device=like.device)
            if rho0 is None else rho0.reshape(B).to(like.dtype))
    return lam_dyn, lam_hi, lam_lo, rho0


def fused_al_solve(model, Cd: Tensor, c: Tensor, x0: Tensor,
                   u_lo: Sequence[float], u_hi: Sequence[float],
                   x_init: Tensor, u_init: Tensor,
                   al_iter: int = 2, n_newton: int = 4, n_ls: int = 20,
                   rho_factor: float = 10.0, rho_max: float = 1e4,
                   reg: float = 1e-5,
                   lam_dyn: Optional[Tensor] = None,
                   lam_hi: Optional[Tensor] = None,
                   lam_lo: Optional[Tensor] = None,
                   rho0: Optional[Tensor] = None,
                   group: Optional[int] = None) -> Outputs:
    """Whole-solver AL-MPC with explicit x/u (and optional λ/ρ) warm starts.

    Cd, c: [B, T, n]; x0: [B, nx]; x_init: [B, T, nx]; u_init: [B, T, nu];
    u_lo/u_hi: nu floats. lam_dyn [B, T-1, nx], lam_hi/lam_lo [B, T, nu] and
    rho0 [B] default to zeros/ones, the fresh-state semantics. Returns
    (xu [B, T, n], lam_dyn, lam_hi, lam_lo, res [B]). The defaults of
    rho_max and reg are the kernel's own; solvers pass ALConfig's values.
    ``group`` sets the kernel's lanes per element (one of ``GROUPS``; the
    results do not depend on it); None takes ``choose_group``'s.
    """
    if group is not None and group not in GROUPS:
        raise ValueError(f"group {group} is not one of {GROUPS}")
    B, T, n = Cd.shape
    nx = x0.shape[-1]
    lam_dyn, lam_hi, lam_lo, rho0 = _fill_warm_start(
        B, T, nx, n - nx, Cd, lam_dyn, lam_hi, lam_lo, rho0)
    args = (model, Cd, c, x0, tuple(float(v) for v in u_lo),
            tuple(float(v) for v in u_hi), x_init, u_init, al_iter, n_newton,
            n_ls, float(rho_factor), float(rho_max), float(reg),
            lam_dyn, lam_hi, lam_lo, rho0)
    if Cd.device.type == "cpu":
        return fused_al_solve_reference(*args)
    return _launch(*args, group=group)


def choose_group(B: int, resident: Mapping[int, int]) -> int:
    """Lanes per element for a batch of B: the widest G of ``GROUPS`` whose
    B·G threads the card holds resident at once (``resident[G]``, read at
    the G instantiation's register count), else 1. Below that count every
    lane has a slot of its own, so the group shortens each element's line
    search at no cost in waves; above it, replicating the Newton chain on G
    lanes would take G times the thread slots, so a filled card runs G = 1."""
    fits = [G for G in GROUPS if B * G <= resident[G]]
    return max(fits, default=1)


def fused_al_solve_reference(model, Cd: Tensor, c: Tensor, x0: Tensor,
                             u_lo: Sequence[float], u_hi: Sequence[float],
                             x_init: Tensor, u_init: Tensor,
                             al_iter: int = 2, n_newton: int = 4,
                             n_ls: int = 20, rho_factor: float = 10.0,
                             rho_max: float = 1e4, reg: float = 1e-5,
                             lam_dyn: Optional[Tensor] = None,
                             lam_hi: Optional[Tensor] = None,
                             lam_lo: Optional[Tensor] = None,
                             rho0: Optional[Tensor] = None) -> Outputs:
    """Plain PyTorch version of the kernel, batched over B on any device.

    The kernel's semantics: x₀ pinned, the line search's cost term as the
    polynomial q0 + a·q1 + a²·q2 in the float32 step a = 2⁻ᵏ, a running
    minimum with strict ``<`` from float32's max (first minimum wins, NaN
    never wins), a step taken only if it beats the current merit.
    """
    B, T, n = Cd.shape
    nx = x0.shape[-1]
    nu = n - nx
    lam_dyn, lam_hi, lam_lo, rho0 = _fill_warm_start(
        B, T, nx, nu, Cd, lam_dyn, lam_hi, lam_lo, rho0)
    kw = dict(dtype=Cd.dtype, device=Cd.device)
    bounds = Bounds(u_lo=torch.tensor(tuple(u_lo), **kw),
                    u_hi=torch.tensor(tuple(u_hi), **kw))
    cost = DiagQuadCost(Cd=Cd, c=c)
    lam = Lambdas(lam_dyn=lam_dyn, lam_init=torch.zeros(B, nx, **kw),
                  lam_hi=lam_hi, lam_lo=lam_lo)
    rho = rho0.reshape(B, 1)
    steps = (2.0 ** -torch.arange(n_ls, dtype=torch.float32,
                                  device=Cd.device)).to(Cd.dtype)
    inf = torch.tensor(float("inf"), **kw)
    w = torch.cat([x_init, u_init], dim=-1).clone()
    w[:, 0, :nx] = x0

    def residuals(xu):
        return almerit.residuals(model, xu[..., :nx], xu[..., nx:],
                                 x0.repeat(xu.shape[0] // B, 1), bounds)

    for _ in range(al_iter):
        merit = almerit.merit_value(cost, residuals(w), lam, rho, w)
        for _ in range(n_newton):
            grad, D, O, _ = almerit.merit_grad_hess(
                cost, model.jac, w[..., :nx], w[..., nx:], x0, bounds, lam,
                rho)
            grad, D, O = newton_al.pin_first_state(grad, D, O, nx)
            d = -btsolve.batched_factor_solve(D, O, grad, reg)
            q0 = (0.5 * Cd * w * w + c * w).sum(dim=(1, 2))
            q1 = ((Cd * w + c) * d).sum(dim=(1, 2))
            q2 = (0.5 * Cd * d * d).sum(dim=(1, 2))
            cand = w[None] + steps[:, None, None, None] * d[None]
            cand[:, :, 0, :nx] = x0
            cons = almerit.constraint_merit(
                residuals(cand.reshape(n_ls * B, T, n)),
                lam.map(lambda a: a.repeat((n_ls,) + (1,) * (a.ndim - 1))),
                rho.repeat(n_ls, 1)).reshape(n_ls, B)
            a = steps[:, None]
            mk = q0 + a * q1 + (a * a) * q2 + cons
            mk = torch.where(mk < _F32_MAX, mk, inf)
            best_m, best = mk.min(dim=0)
            found = best_m < inf
            best_a = torch.where(found, steps[best], 0.0)
            best_m = torch.where(found, best_m, _F32_MAX)
            better = best_m < merit
            a_sel = torch.where(better, best_a, 0.0)
            w_new = w + a_sel[:, None, None] * d
            w_new[:, 0, :nx] = x0
            w = torch.where(better[:, None, None], w_new, w)
            merit = torch.where(better, best_m, merit)
        res = residuals(w)
        lam = almerit.lambda_update(lam, res, rho)
        rho = torch.clamp(rho * rho_factor, max=rho_max)
    res = residuals(w).clamped().flat_norm()
    return w, lam.lam_dyn, lam.lam_hi, lam.lam_lo, res


def _check(model, Cd, c, x0, u_lo, u_hi, x_init, u_init, lam_dyn, lam_hi,
           lam_lo, rho0):
    if not isinstance(model, Pendulum):
        raise NotImplementedError(
            f"no fused kernel for {type(model).__name__} (built: Pendulum)")
    B, T, n = Cd.shape
    nx, nu = model.nx, model.nu
    if n != nx + nu or T not in HORIZONS.get(Cd.dtype, ()):
        raise ValueError(f"no kernel for T={T}, n={n}, {Cd.dtype} "
                         f"(built: n=3, T by dtype {HORIZONS})")
    if len(u_lo) != nu or len(u_hi) != nu:
        raise ValueError(f"expected {nu} bounds, got {u_lo}, {u_hi}")
    shapes = {"c": (c, (B, T, n)), "x0": (x0, (B, nx)),
              "x_init": (x_init, (B, T, nx)), "u_init": (u_init, (B, T, nu)),
              "lam_dyn": (lam_dyn, (B, T - 1, nx)),
              "lam_hi": (lam_hi, (B, T, nu)), "lam_lo": (lam_lo, (B, T, nu)),
              "rho0": (rho0, (B,)), "Cd": (Cd, (B, T, n))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != Cd.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {Cd.dtype}")
        if t.device != Cd.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, expected {Cd.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, T, n, nx, nu


def resident_threads(dtype: torch.dtype, T: int,
                     device: torch.device) -> Dict[int, int]:
    """Threads of the kernel for (dtype, T) that ``device`` holds resident
    at once, per G of ``GROUPS`` (CUDA's occupancy calculator at each G
    instantiation's register count)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    key = (index, dtype, T)
    if key not in _resident:
        lib = cuda_build.load("al_fused")
        fn = getattr(lib, _RESIDENT_SYMBOLS[dtype])
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        threads = {}
        for G in GROUPS:
            out = ctypes.c_int(0)
            with torch.cuda.device(index):
                err = fn(T, G.bit_length() - 1, ctypes.byref(out))
            cuda_build.check(lib, err, "al_fused occupancy query")
            threads[G] = out.value
        _resident[key] = threads
    return _resident[key]


def _launch(model, Cd, c, x0, u_lo, u_hi, x_init, u_init, al_iter, n_newton,
            n_ls, rho_factor, rho_max, reg, lam_dyn, lam_hi, lam_lo,
            rho0, group=None) -> Outputs:
    global launches
    B, T, n, nx, nu = _check(model, Cd, c, x0, u_lo, u_hi, x_init, u_init,
                             lam_dyn, lam_hi, lam_lo, rho0)
    w = torch.empty_like(Cd)
    lamd_o = torch.empty_like(lam_dyn)
    lamh_o = torch.empty_like(lam_hi)
    laml_o = torch.empty_like(lam_lo)
    res = torch.empty_like(rho0)
    if B == 0:
        return w, lamd_o, lamh_o, laml_o, res
    if group is None:
        group = choose_group(B, resident_threads(Cd.dtype, T, Cd.device))
    if B * group >= 2 ** 31:
        raise ValueError(f"B·G = {B}·{group} threads exceed the kernel's "
                         "int indexing")
    lib = cuda_build.load("al_fused")
    fn = getattr(lib, _SYMBOLS[Cd.dtype])
    dbl3 = ctypes.c_double * 3
    dblu = ctypes.c_double * nu
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
        + [ctypes.c_double] * 3 + [ctypes.POINTER(ctypes.c_double)] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # folded in double precision as the reference's Python constants are
    params = dbl3(model.dt, model.m * model.g * model.l, model.m * model.l ** 2)
    stream = torch.cuda.current_stream(Cd.device).cuda_stream
    with torch.cuda.device(Cd.device):
        err = fn(Cd.data_ptr(), c.data_ptr(), x0.data_ptr(),
                 x_init.data_ptr(), u_init.data_ptr(), lam_dyn.data_ptr(),
                 lam_hi.data_ptr(), lam_lo.data_ptr(), rho0.data_ptr(),
                 w.data_ptr(), lamd_o.data_ptr(), lamh_o.data_ptr(),
                 laml_o.data_ptr(), res.data_ptr(), B,
                 group.bit_length() - 1, T, al_iter, n_newton, n_ls,
                 rho_factor, rho_max, reg, params, dblu(*u_lo), dblu(*u_hi),
                 stream)
    cuda_build.check(lib, err, "al_fused kernel launch")
    launches += 1
    return w, lamd_o, lamh_o, laml_o, res
