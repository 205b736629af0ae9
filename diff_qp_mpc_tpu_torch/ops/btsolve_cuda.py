"""K1: batched block-tridiagonal Cholesky solve as a hand-written CUDA kernel
(``csrc/btsolve.cu``), the port of diff_qp_mpc_tpu.ops.btsolve_pallas.

``batched_factor_solve`` takes the plain PyTorch version
(``ops.btsolve.batched_factor_solve``) for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other. Each
kernel launch adds one to ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from diff_qp_mpc_tpu_torch.ops import btsolve
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: block sizes n = nx + nu with a kernel instantiation
BLOCK_SIZES = (3, 5, 7, 16)
#: kernel launches since the count was last set to 0
launches = 0

_SYMBOLS = {torch.float32: "btsolve_f32", torch.float64: "btsolve_f64"}


def batched_factor_solve(D: Tensor, O: Tensor, b: Tensor,
                         reg: float = 0.0) -> Tensor:
    """Solve H x = b. D: [B, T, n, n], O: [B, T-1, n, n], b: [B, T, n]."""
    if D.device.type == "cpu":
        return btsolve.batched_factor_solve(D, O, b, reg)
    return _launch(D, O, b, float(reg))


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


def _launch(D: Tensor, O: Tensor, b: Tensor, reg: float) -> Tensor:
    global launches
    B, T, n = _check(D, O, b)
    x = torch.empty_like(b)
    if B == 0:
        return x
    scratch = torch.empty(2 * T * n * n * B, dtype=D.dtype, device=D.device)
    lib = cuda_build.load("btsolve")
    fn = getattr(lib, _SYMBOLS[D.dtype])
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
        + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(D.device).cuda_stream
    with torch.cuda.device(D.device):
        err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(),
                 scratch.data_ptr(), B, T, n, reg, stream)
    cuda_build.check(lib, err, "btsolve kernel launch")
    launches += 1
    return x
