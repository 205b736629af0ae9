"""K1: batched block-tridiagonal Cholesky solve as a hand-written CUDA kernel
(``csrc/btsolve.cu``), the port of diff_qp_mpc_tpu.ops.btsolve_pallas.

``batched_factor_solve`` takes the plain PyTorch version
(``ops.btsolve.batched_factor_solve``) for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other. Each
kernel launch adds one to ``launches``.

The kernel has two layouts (``LAYOUTS``): "onchip" keeps each element's
blocks, factor and substitution in shared memory and registers, for the
(dtype, n, T) of ``ONCHIP_SHAPES``; "stream" takes every block size of
``BLOCK_SIZES`` at any T, with the factor in a scratch tensor.
``choose_layout`` is the rule. At float32 n 16 (the quadrotor) the
streaming kernel computes in float64 and rounds x to float32 once, where
the TPU kernel and the plain version compute in float32 (csrc/btsolve.cu
says why); the source sizes its scratch (``btsolve_scratch_bytes_*``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from diff_qp_mpc_tpu_torch.ops import btsolve
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: block sizes n = nx + nu with a kernel instantiation
BLOCK_SIZES = (3, 4, 5, 6, 7, 16)
#: (n, T) with an on-chip instantiation, per dtype
ONCHIP_SHAPES = {torch.float32: ((3, 5), (3, 10), (5, 5)),
                 torch.float64: ((3, 5),)}
LAYOUTS = ("onchip", "stream")
#: kernel launches since the count was last set to 0
launches = 0

_SYMBOLS = {torch.float32: "btsolve_f32", torch.float64: "btsolve_f64"}
_SCRATCH_SYMBOLS = {torch.float32: "btsolve_scratch_bytes_f32",
                    torch.float64: "btsolve_scratch_bytes_f64"}
_ONCHIP_SYMBOLS = {torch.float32: "btsolve_onchip_f32",
                   torch.float64: "btsolve_onchip_f64"}


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


def choose_layout(dtype: torch.dtype, n: int, T: int) -> str:
    """"onchip" where (n, T) has an on-chip instantiation for ``dtype``,
    whose element fits in registers and shared memory without spills; else
    "stream"."""
    return "onchip" if (n, T) in ONCHIP_SHAPES.get(dtype, ()) else "stream"


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
            layout: Optional[str]) -> Tensor:
    global launches
    B, T, n = _check(D, O, b)
    if layout is None:
        layout = choose_layout(D.dtype, n, T)
    if layout == "onchip" and (n, T) not in ONCHIP_SHAPES[D.dtype]:
        raise ValueError(f"no on-chip kernel for n={n}, T={T}, {D.dtype} "
                         f"(built: {ONCHIP_SHAPES[D.dtype]})")
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
    else:
        fn = getattr(lib, _ONCHIP_SYMBOLS[D.dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        with torch.cuda.device(D.device):
            err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
                     B, T, n, reg, stream)
    cuda_build.check(lib, err, "btsolve kernel launch")
    launches += 1
    return x
