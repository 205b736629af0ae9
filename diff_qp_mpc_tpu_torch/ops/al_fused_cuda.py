"""K2: the whole AL-MPC solve as one hand-written CUDA kernel
(``csrc/al_fused_common.cuh``, ``csrc/al_fused_warp.cuh``), the port of
diff_qp_mpc_tpu.ops.al_fused_pallas.

``fused_al_solve`` takes the plain PyTorch version
(``fused_al_solve_reference``, same signature and semantics) for CPU tensors
and launches the kernel for CUDA tensors; it never falls back from one to
the other. Each kernel launch adds one to ``launches``.

Two layouts, one per model (``Built.layout``). "group"
(``al_fused_common.cuh``): each batch element on a group of G lanes
(``GROUPS``) that share its line search, each lane holding the element in
its registers; the outputs are bit-identical at every G, and
``choose_group`` is the rule that picks G from the batch. "warp"
(``al_fused_warp.cuh``): W warps per element (``Built.warps``), its
blocks in shared memory; it raises on a launch whose
blocks ask for more shared memory than the device allows. The quadrotor
(n 16, whose element does not fit one lane) and the cartpoles (n 5 and 7,
whose elements spill 0.9-12 KB a lane) run the warp layout. The cartpoles
ran the group layout before; one card call timed both layouts on every
cartpole (T, dtype) at B 64, 256 and 4096 (float32 ms a launch at B 64,
group / warp, on an NVIDIA H100 80GB HBM3 at 700 W: cp1 T 5 0.467 /
0.199, T 10 1.238 / 0.392, cp2 T 5 2.047 / 0.403, T 10 4.938 / 0.804;
PERF.md), and the warp layout was 2.3-7.2× faster in every case, so it
replaced the group layout there. Its header takes W 1, 2 or 4 as a
template parameter (the same bits at every W); one card call timed the
three in turns on every (model, T, dtype) at B 64, 128, 256 and 4096, and
W 4 was the fastest at B 64-256 in every case (float32 ms at B 64, W 1 /
2 / 4, on the same card: the quadrotor 0.520 / 0.425 / 0.392, cp2 T 10
0.658 / 0.488 / 0.459, cp1 T 10 0.316 / 0.262 / 0.252; the kernel before,
one warp per element, 0.590 / 0.807 / 0.396; PERF.md), so the sources
build W 4 alone. The paths feed these models B 64 (the closed loops and
DAgger, ``--episodes``) to 256 (training, ``--bsz``: 256 by default and at
the cp1 checkpoint, 128 at the quadrotor's); at B 4096 W 4 is 1.5-2.7×
slower than one warp per element was (PERF.md gives the crossover). The
warp layout takes ``group`` None or 32.

``BUILT`` names the models the kernel is built for, each with its
source(s), its functor's constants, its horizons per dtype and its layout:
the pendulum, the integrator with one position (nx 2), ``Cartpole1L``,
``Cartpole2L`` (the default model and ``.pkg()``), ``RexQuadrotor``, and
``PendulumCosSin`` and ``CartpoleCosSin`` (one source for both). Another
model, shape, horizon or dtype raises; the plain version takes any model
with ``step`` and ``jac``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost, Lambdas
from diff_qp_mpc_tpu_torch.models import (
    Cartpole1L,
    Cartpole2L,
    CartpoleCosSin,
    Integrator,
    Pendulum,
    PendulumCosSin,
    RexQuadrotor,
)
from diff_qp_mpc_tpu_torch.ops import almerit, btsolve, newton_al
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Built:
    """One model's kernel: ``csrc/<library>.cu`` exports ``al_fused_<name>_f32``/``_f64`` and,
    on the "group" layout, their ``_resident_threads_`` queries, on the
    "warp" layout their ``_smem_`` queries; ``params`` folds the model's
    constants in double precision, in the order of its functor's ``make``
    (or ``load``); ``horizons`` per dtype have an instantiation."""

    library: str
    name: str
    nx: int
    nu: int
    params: Callable[[object], Tuple[float, ...]]
    horizons: Mapping[torch.dtype, Tuple[int, ...]]
    layout: str = "group"
    #: the "warp" layout's warps per element (1, 2 or 4) at every horizon
    #: and dtype: its source's instantiation
    warps: int = 1

    def symbol(self, dtype: torch.dtype, resident: bool = False,
               smem: bool = False) -> str:
        """The launch's entry point, or the resident-threads or the
        shared-memory query's."""
        bits = {torch.float32: "f32", torch.float64: "f64"}[dtype]
        query = "resident_threads_" * resident + "smem_" * smem
        return f"al_fused_{self.name}_{query}{bits}"


_T5_10 = {torch.float32: (5, 10), torch.float64: (5,)}
#: the models with a kernel, by type
BUILT = {
    Pendulum: Built("al_fused", "pendulum", 2, 1,
                    # as the reference folds its Python constants
                    lambda m: (m.dt, m.m * m.g * m.l, m.m * m.l ** 2),
                    _T5_10),
    Integrator: Built("al_fused_integrator", "integrator", 2, 1,
                      lambda m: (m.dt,),
                      {torch.float32: (5,), torch.float64: (5,)}),
    Cartpole1L: Built("al_fused_cartpole1l", "cartpole1l", 4, 1,
                      lambda m: m.kernel_params(), _T5_10, layout="warp",
                      warps=4),
    Cartpole2L: Built("al_fused_cartpole2l", "cartpole2l", 6, 1,
                      lambda m: m.kernel_params(), _T5_10, layout="warp",
                      warps=4),
    RexQuadrotor: Built("al_fused_quadrotor", "quadrotor", 12, 4,
                        lambda m: m.kernel_params(),
                        {torch.float32: (5,), torch.float64: (5,)},
                        layout="warp", warps=4),
    PendulumCosSin: Built("al_fused_cossin", "pendulum_cossin", 3, 1,
                          lambda m: m.kernel_params(), _T5_10),
    CartpoleCosSin: Built("al_fused_cossin", "cartpole_cossin", 5, 1,
                          lambda m: m.kernel_params(), _T5_10),
}
#: the kernels' sources, for a build of them all
LIBRARIES = tuple(dict.fromkeys(b.library for b in BUILT.values()))
#: lanes per batch element the "group" layout takes (a power of two dividing
#: a warp); the "warp" layout takes 32
GROUPS = (1, 2, 4, 8, 16, 32)
#: kernel launches since the count was last set to 0
launches = 0

# the line search's running minimum starts at float32's max in every dtype,
# as the reference kernel's does
_F32_MAX = float(torch.finfo(torch.float32).max)
# resident threads per (model, device index, dtype, T, G), and shared memory
# per (model, device index, dtype, T), read once
_resident: dict = {}
_smem: dict = {}


def built_for(model) -> Built:
    """The kernel of ``model``; NotImplementedError, naming what is built,
    for a model without one."""
    built = BUILT.get(type(model))
    if built is None or (model.nx, model.nu) != (built.nx, built.nu):
        have = ", ".join(f"{t.__name__} (nx {b.nx}, nu {b.nu})"
                         for t, b in BUILT.items())
        raise NotImplementedError(
            f"no fused kernel for {type(model).__name__} with "
            f"nx {model.nx}, nu {model.nu} (built: {have})")
    return built


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
    ``group`` sets the "group" layout's lanes per element (one of
    ``GROUPS``; the results do not depend on it); None takes
    ``choose_group``'s. The "warp" layout takes None or 32.
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
    built = built_for(model)
    B, T, n = Cd.shape
    nx, nu = model.nx, model.nu
    if n != nx + nu or T not in built.horizons.get(Cd.dtype, ()):
        raise ValueError(f"no {built.name} kernel for T={T}, n={n}, "
                         f"{Cd.dtype} (built: n={nx + nu}, T by dtype "
                         f"{dict(built.horizons)})")
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
    return built, B, T, n, nx, nu


def _device_index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def resident_threads(dtype: torch.dtype, T: int, device: torch.device,
                     model=None) -> Dict[int, int]:
    """Threads of ``model``'s kernel (default the pendulum's; the "group"
    layout) for (dtype, T) that ``device`` holds resident at once, per G of
    ``GROUPS`` (CUDA's occupancy calculator at each G instantiation's
    register count)."""
    built = built_for(Pendulum() if model is None else model)
    if built.layout != "group":
        raise ValueError(f"the {built.name} kernel has no groups: it runs "
                         f"one warp per element")
    index = _device_index(device)
    key = (built.name, index, dtype, T)
    if key not in _resident:
        lib = cuda_build.load(built.library)
        fn = getattr(lib, built.symbol(dtype, resident=True))
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


def warp_smem(dtype: torch.dtype, T: int, device: torch.device,
              model) -> Dict[str, int]:
    """Shared memory of ``model``'s "warp" kernel for (dtype, T) on
    ``device``: bytes an element (``per_element``) and a block
    (``per_block``: two elements at one warp each, one element above), and
    the most a block may ask of the device (``device_max``)."""
    built = built_for(model)
    if built.layout != "warp":
        raise ValueError(f"the {built.name} kernel keeps its elements in "
                         f"registers, not in shared memory")
    W = built.warps
    index = _device_index(device)
    key = (built.name, index, dtype, T)
    if key not in _smem:
        lib = cuda_build.load(built.library)
        fn = getattr(lib, built.symbol(dtype, smem=True))
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
        fn.restype = ctypes.c_int
        out = [ctypes.c_int(0) for _ in range(3)]
        with torch.cuda.device(index):
            err = fn(T, 5 + W.bit_length() - 1,
                     *(ctypes.byref(o) for o in out))
        cuda_build.check(lib, err, "al_fused shared-memory query")
        _smem[key] = dict(zip(("per_element", "per_block", "device_max"),
                              (o.value for o in out)))
    return _smem[key]


def call_entry(fn, tensors, B, log2G, T, al_iter, n_newton, n_ls,
               rho_factor, rho_max, reg, params, u_lo, u_hi, stream) -> int:
    """Call ``fn``, an entry point of AL_FUSED_ENTRY (csrc/
    al_fused_common.cuh), on ``tensors`` (Cd, c, x0, x_init, u_init,
    lam_dyn, lam_hi, lam_lo, rho0, then the outputs w, lam_dyn, lam_hi,
    lam_lo, res); returns its error code."""
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
        + [ctypes.c_double] * 3 + [ctypes.POINTER(ctypes.c_double)] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dbl = lambda v: (ctypes.c_double * len(v))(*(float(a) for a in v))
    return fn(*(t.data_ptr() for t in tensors), B, log2G, T, al_iter,
              n_newton, n_ls, float(rho_factor), float(rho_max), float(reg),
              dbl(params), dbl(u_lo), dbl(u_hi), stream)


def _launch(model, Cd, c, x0, u_lo, u_hi, x_init, u_init, al_iter, n_newton,
            n_ls, rho_factor, rho_max, reg, lam_dyn, lam_hi, lam_lo,
            rho0, group=None) -> Outputs:
    """Launch the kernel."""
    global launches
    built, B, T, n, nx, nu = _check(model, Cd, c, x0, u_lo, u_hi, x_init,
                                    u_init, lam_dyn, lam_hi, lam_lo, rho0)
    w = torch.empty_like(Cd)
    lamd_o = torch.empty_like(lam_dyn)
    lamh_o = torch.empty_like(lam_hi)
    laml_o = torch.empty_like(lam_lo)
    res = torch.empty_like(rho0)
    if built.layout == "warp" and group not in (None, 32):
        raise ValueError(f"the {built.name} kernel runs whole warps per "
                         f"element ({built.warps}): group must be None or "
                         f"32, not {group}")
    if B == 0:
        return w, lamd_o, lamh_o, laml_o, res
    if built.layout == "warp":
        # the element's threads, 32·W; the entry refuses (invalid
        # configuration) a block whose shared memory exceeds the device's;
        # check raises on its code
        group = 32 * built.warps
    elif group is None:
        group = choose_group(B, resident_threads(Cd.dtype, T, Cd.device,
                                                 model))
    if B * group >= 2 ** 31:
        raise ValueError(f"B·G = {B}·{group} threads exceed the kernel's "
                         "int indexing")
    lib = cuda_build.load(built.library)
    stream = torch.cuda.current_stream(Cd.device).cuda_stream
    with torch.cuda.device(Cd.device):
        err = call_entry(getattr(lib, built.symbol(Cd.dtype)),
                         (Cd, c, x0, x_init, u_init, lam_dyn, lam_hi, lam_lo,
                          rho0, w, lamd_o, lamh_o, laml_o, res), B,
                         group.bit_length() - 1, T, al_iter, n_newton, n_ls,
                         rho_factor, rho_max, reg, built.params(model), u_lo,
                         u_hi, stream)
    cuda_build.check(lib, err, "al_fused kernel launch")
    launches += 1
    return w, lamd_o, lamh_o, laml_o, res
