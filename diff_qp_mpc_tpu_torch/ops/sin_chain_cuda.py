"""K5: the saturated sin-rate microbenchmark as a hand-written CUDA kernel
(``csrc/sin_chain.cu``), the port of the TPU kernel of
benchmarks/roofline_fused.py::transcendental_rate.

``sin_chain`` takes the plain PyTorch version (``sin_chain_reference``) for
CPU tensors and launches the kernel for CUDA tensors; it never falls back
from one to the other. Each kernel launch adds one to ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: stream counts with a kernel instantiation
STREAMS = tuple(range(1, 9))
#: kernel launches since the count was last set to 0
launches = 0


def sin_chain(x: Tensor, n_ops: int) -> Tensor:
    """x [n_tiles, n_streams, 8, 128] float32 → [n_tiles, 8, 128]: each
    stream put through sin ``n_ops`` times, then the streams summed in
    order."""
    _check(x, n_ops)
    if x.device.type == "cpu":
        return sin_chain_reference(x, n_ops)
    return _launch(x, int(n_ops))


def sin_chain_reference(x: Tensor, n_ops: int) -> Tensor:
    """Plain PyTorch version: ``torch.sin`` n_ops times over the whole
    tensor, then the streams added one by one (xs[0] + xs[1] + …), the
    order of the TPU kernel and of the CUDA one."""
    for _ in range(n_ops):
        x = torch.sin(x)
    o = x[:, 0]
    for s in range(1, x.shape[1]):
        o = o + x[:, s]
    return o


def _check(x: Tensor, n_ops: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"dtype {x.dtype}: the kernel takes float32")
    if x.ndim != 4 or tuple(x.shape[2:]) != (8, 128):
        raise ValueError(f"x: shape {tuple(x.shape)}, expected "
                         "[n_tiles, n_streams, 8, 128]")
    if x.shape[1] not in STREAMS:
        raise ValueError(f"no kernel for n_streams={x.shape[1]} "
                         f"(built: {STREAMS})")
    if not x.is_contiguous():
        raise ValueError("x is not contiguous")
    if int(n_ops) < 0:
        raise ValueError(f"n_ops={n_ops} < 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x is on {x.device}, expected a CUDA device")


def _launch(x: Tensor, n_ops: int) -> Tensor:
    global launches
    n_tiles, n_streams = x.shape[:2]
    out = torch.empty(n_tiles, 8, 128, dtype=x.dtype, device=x.device)
    if n_tiles == 0:
        return out
    lib = cuda_build.load("sin_chain")
    fn = lib.sin_chain_f32
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), n_tiles, n_streams, n_ops,
                 stream)
    cuda_build.check(lib, err, "sin_chain kernel launch")
    launches += 1
    return out
