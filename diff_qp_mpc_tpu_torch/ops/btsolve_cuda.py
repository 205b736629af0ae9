"""K1: batched block-tridiagonal Cholesky solve as a hand-written CUDA kernel
(``csrc/btsolve.cu``), the port of diff_qp_mpc_tpu.ops.btsolve_pallas.

``batched_factor_solve`` takes the plain PyTorch version
(``ops.btsolve.batched_factor_solve``) for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other. Each
kernel launch adds one to ``launches``.

The kernel has three layouts (``LAYOUTS``): "onchip" keeps each element's
blocks, factor and substitution in shared memory and registers, one thread
an element, for the (dtype, n, T) of ``ONCHIP_SHAPES``; "warp" runs one
warp an element with its blocks in shared memory, factored in place, at the
block sizes of ``WARP_SIZES`` (the quadrotor's n 16), computing in
``WARP_COMPUTE``'s type, at any T whose block (``warp_block_bytes``) fits
the device's shared memory; "stream" takes every block size of
``BLOCK_SIZES`` at any T, one thread an element, with the factor in a
scratch tensor. ``choose_layout`` is the rule: at n 16 "warp" where its
block fits (T ≤ 26 on an H100, whose blocks may ask 232,448 B), which ran
faster than "stream" at every batch measured (T 5, float32 inputs: 0.053
against 0.877, 1.232, 1.850 and 1.949 ms at B 8, 64, 128 and 256, one call
on an H100 80GB HBM3 at 700 W, ``benchmarks/kernel_layouts.py --only
k1_warp``, PERF.md), else "stream". At float32 n 16 both compute in
float64 and round x to float32 once, where the TPU kernel and the plain
version compute in float32: the warp layout's float32 computation (0.039
ms at B 64) failed K1's 2× rule on the quadrotor's AL systems on one draw
of 48 (3.89 at ρ 1e4, ``kernel_layouts.k1_compute_rule``; csrc/btsolve.cu
says why such draws fail). It stays built only for that check, which
reaches it through ``_launch(..., compute=torch.float32)``. The source
sizes the streaming kernel's scratch (``btsolve_scratch_bytes_*``) and the
warp layout's shared memory (``warp_smem``), and refuses a warp launch
whose block asks for more shared memory than the device allows. Each
launch of the warp layout also adds one to ``warp_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from diff_qp_mpc_tpu_torch.ops import btsolve
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: block sizes n = nx + nu with a kernel instantiation
BLOCK_SIZES = (3, 4, 5, 6, 7, 16)
#: (n, T) with an on-chip instantiation, per dtype
ONCHIP_SHAPES = {torch.float32: ((3, 5), (3, 10), (5, 5)),
                 torch.float64: ((3, 5),)}
#: block sizes with a warp-layout instantiation (any T)
WARP_SIZES = (16,)
#: the type the warp layout computes in, per input dtype: float32 inputs
#: in float64, since the float32 computation failed K1_AL_RATIO on one of
#: ``kernel_layouts.k1_compute_rule``'s 48 draws
WARP_COMPUTE = {torch.float32: torch.float64, torch.float64: torch.float64}
#: elements (warps) a block of the warp layout (csrc/btsolve.cu's
#: kWarpElements)
WARP_ELEMENTS = 2
#: the shared memory a block may ask of an H100 (its opt-in limit), which
#: ``choose_layout`` takes where no device is given
H100_SMEM_PER_BLOCK = 232448
LAYOUTS = ("onchip", "warp", "stream")
#: kernel launches since the count was last set to 0 (every layout)
launches = 0
#: of those, the warp layout's
warp_launches = 0

_SYMBOLS = {torch.float32: "btsolve_f32", torch.float64: "btsolve_f64"}
_SCRATCH_SYMBOLS = {torch.float32: "btsolve_scratch_bytes_f32",
                    torch.float64: "btsolve_scratch_bytes_f64"}
_ONCHIP_SYMBOLS = {torch.float32: "btsolve_onchip_f32",
                   torch.float64: "btsolve_onchip_f64"}
_WARP_SYMBOLS = {torch.float32: "btsolve_warp_f32",
                 torch.float64: "btsolve_warp_f64"}
_BITS = {torch.float32: 32, torch.float64: 64}
# shared memory per (device index, T, n, compute dtype), read once
_smem: dict = {}


def batched_factor_solve(D: Tensor, O: Tensor, b: Tensor, reg: float = 0.0,
                         layout: Optional[str] = None) -> Tensor:
    """Solve H x = b. D: [B, T, n, n], O: [B, T-1, n, n], b: [B, T, n].
    ``layout`` forces one of ``LAYOUTS`` on the card (the same function);
    None takes ``choose_layout``'s."""
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    if D.device.type == "cpu":
        return btsolve.batched_factor_solve(D, O, b, reg)
    return _launch(D, O, b, float(reg), layout)


def warp_block_bytes(T: int, n: int, compute: torch.dtype) -> int:
    """Shared memory of a warp-layout block at (T, n) computing in
    ``compute``: per element D [T][n][n+1], O [T-1][n][n+1] and b [T][n]
    (csrc/btsolve.cu's warp_words), ``WARP_ELEMENTS`` elements."""
    words = (2 * T - 1) * n * (n + 1) + T * n
    return words * torch.finfo(compute).bits // 8 * WARP_ELEMENTS


def choose_layout(dtype: torch.dtype, n: int, T: int,
                  smem_per_block: int = H100_SMEM_PER_BLOCK) -> str:
    """"onchip" where (n, T) has an on-chip instantiation for ``dtype``,
    whose element fits in registers and shared memory without spills;
    "warp" at the block sizes of ``WARP_SIZES``, where one thread's element
    spills (n 16: the warp layout ran faster than the streaming kernel at
    B 8, 64, 128 and 256), if its block (``warp_block_bytes`` at
    ``WARP_COMPUTE``'s type) fits ``smem_per_block``, the most a block may
    ask of the device; else "stream"."""
    if (n, T) in ONCHIP_SHAPES.get(dtype, ()):
        return "onchip"
    if n in WARP_SIZES and warp_block_bytes(
            T, n, WARP_COMPUTE[dtype]) <= smem_per_block:
        return "warp"
    return "stream"


def warp_smem(dtype: torch.dtype, T: int, n: int, device,
              compute: Optional[torch.dtype] = None) -> Dict[str, int]:
    """Shared memory of the warp layout at (T, n) for ``dtype`` inputs
    computing in ``compute`` (None: ``WARP_COMPUTE``'s) on ``device``: bytes
    an element (``per_element``) and a block (``per_block``), and the most a
    block may ask of the device (``device_max``)."""
    compute = WARP_COMPUTE[dtype] if compute is None else compute
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    key = (index, T, n, compute)
    if key not in _smem:
        lib = cuda_build.load("btsolve")
        fn = lib.btsolve_warp_smem
        fn.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_longlong)] * 2 + [
            ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        elem, block = ctypes.c_longlong(0), ctypes.c_longlong(0)
        dmax = ctypes.c_int(0)
        with torch.cuda.device(index):
            err = fn(T, n, _BITS[compute], ctypes.byref(elem),
                     ctypes.byref(block), ctypes.byref(dmax))
        cuda_build.check(lib, err, "btsolve shared-memory query")
        _smem[key] = dict(per_element=elem.value, per_block=block.value,
                          device_max=dmax.value)
    return _smem[key]


def _check(D: Tensor, O: Tensor, b: Tensor):
    if D.ndim != 4 or O.ndim != 4 or b.ndim != 3:
        raise ValueError("expected D [B,T,n,n], O [B,T-1,n,n], b [B,T,n]")
    B, T, n, n2 = D.shape
    if n2 != n or tuple(O.shape) != (B, T - 1, n, n) \
            or tuple(b.shape) != (B, T, n):
        raise ValueError(f"shape mismatch: D {tuple(D.shape)}, "
                         f"O {tuple(O.shape)}, b {tuple(b.shape)}")
    if n not in BLOCK_SIZES:
        raise ValueError(f"no kernel for block size n={n} "
                         f"(built: {BLOCK_SIZES})")
    if D.dtype not in _SYMBOLS or O.dtype != D.dtype or b.dtype != D.dtype:
        raise TypeError(f"dtypes {D.dtype}, {O.dtype}, {b.dtype}: "
                        "the kernel takes float32 or float64, all alike")
    for name, t in (("D", D), ("O", O), ("b", b)):
        if t.device.type != "cuda" or t.device != D.device:
            raise ValueError(f"{name} is on {t.device}, expected {D.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return B, T, n


def _launch(D: Tensor, O: Tensor, b: Tensor, reg: float,
            layout: Optional[str],
            compute: Optional[torch.dtype] = None) -> Tensor:
    """The launch; ``compute`` sets the warp layout's compute type (float32
    for float32 inputs only; None takes ``WARP_COMPUTE``'s), for
    ``kernel_layouts``' compute-type check and the card tests."""
    global launches, warp_launches
    B, T, n = _check(D, O, b)
    if compute not in (None, torch.float32, torch.float64):
        raise ValueError(f"compute {compute} is not float32 or float64")
    if layout is None:
        limit = warp_smem(D.dtype, T, n, D.device)["device_max"] \
            if n in WARP_SIZES else H100_SMEM_PER_BLOCK
        layout = choose_layout(D.dtype, n, T, limit)
    if layout == "onchip" and (n, T) not in ONCHIP_SHAPES[D.dtype]:
        raise ValueError(f"no on-chip kernel for n={n}, T={T}, {D.dtype} "
                         f"(built: {ONCHIP_SHAPES[D.dtype]})")
    if layout == "warp" and n not in WARP_SIZES:
        raise ValueError(f"no warp-layout kernel for n={n} (built: "
                         f"{WARP_SIZES})")
    if compute is not None and (layout != "warp" or (
            compute == torch.float32 and D.dtype == torch.float64)):
        raise ValueError(f"compute {compute} is for the warp layout, and "
                         f"float32 for float32 inputs only")
    x = torch.empty_like(b)
    if B == 0:
        return x
    lib = cuda_build.load("btsolve")
    stream = torch.cuda.current_stream(D.device).cuda_stream
    if layout == "stream":
        size = getattr(lib, _SCRATCH_SYMBOLS[D.dtype])
        size.argtypes = [ctypes.c_int] * 3
        size.restype = ctypes.c_longlong
        scratch = torch.empty(size(B, T, n), dtype=torch.uint8,
                              device=D.device)
        fn = getattr(lib, _SYMBOLS[D.dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(D.device):
            err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
                     scratch.data_ptr(), B, T, n, reg, stream)
    elif layout == "warp":
        compute = WARP_COMPUTE[D.dtype] if compute is None else compute
        fn = getattr(lib, _WARP_SYMBOLS[D.dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(D.device):
            err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
                     B, T, n, reg, _BITS[compute], stream)
        # the entry refuses (invalid configuration) a block whose shared
        # memory exceeds the device's; check raises on its code
    else:
        fn = getattr(lib, _ONCHIP_SYMBOLS[D.dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(D.device):
            err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
                     B, T, n, reg, stream)
    cuda_build.check(lib, err, f"btsolve kernel launch ({layout})")
    launches += 1
    if layout == "warp":
        warp_launches += 1
    return x
