"""K3: batched Riccati LQR-KKT solve as a hand-written CUDA kernel
(``csrc/riccati.cu``), the port of diff_qp_mpc_tpu.ops.riccati_pallas.

``batched_lqr_kkt_solve`` takes the plain PyTorch version
(``ops.riccati.batched_lqr_kkt_solve``) for CPU tensors and launches the
kernel for CUDA tensors; it never falls back from one to the other. Each
kernel launch adds one to ``launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from diff_qp_mpc_tpu_torch.ops import riccati
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: (T, nx, nu) with a kernel instantiation
BUILT = ((5, 2, 1), (5, 3, 2), (5, 4, 1))
#: kernel launches since the count was last set to 0
launches = 0

_SYMBOLS = {torch.float32: "riccati_f32", torch.float64: "riccati_f64"}


def batched_lqr_kkt_solve(Cxx: Tensor, Cxu: Tensor, Cuu: Tensor, gx: Tensor,
                          gu: Tensor, A: Tensor, B: Tensor, r: Tensor,
                          dx0: Tensor, reg: float = 0.0
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """(dx [B,T,nx], du [B,T,nu], lam [B,T,nx]) of the LQR-KKT system; the
    inputs as ``ops.riccati.batched_lqr_kkt_solve`` takes them."""
    args = (Cxx, Cxu, Cuu, gx, gu, A, B, r, dx0)
    if Cxx.device.type == "cpu":
        sol = riccati.batched_lqr_kkt_solve(*args, reg)
        return sol.dx, sol.du, sol.lam
    return _launch(args, float(reg))


def _check(args):
    Cxx, Cxu = args[0], args[1]
    if Cxu.ndim != 4:
        raise ValueError("expected Cxu [B,T,nx,nu]")
    Bsz, T, nx, nu = Cxu.shape
    if (T, nx, nu) not in BUILT:
        raise ValueError(f"no kernel for T={T}, nx={nx}, nu={nu} "
                         f"(built: (T, nx, nu) in {BUILT})")
    shapes = (("Cxx", (Bsz, T, nx, nx)), ("Cxu", (Bsz, T, nx, nu)),
              ("Cuu", (Bsz, T, nu, nu)), ("gx", (Bsz, T, nx)),
              ("gu", (Bsz, T, nu)), ("A", (Bsz, T - 1, nx, nx)),
              ("B", (Bsz, T - 1, nx, nu)), ("r", (Bsz, T - 1, nx)),
              ("dx0", (Bsz, nx)))
    if Cxx.dtype not in _SYMBOLS:
        raise TypeError(f"dtype {Cxx.dtype}: the kernel takes float32 or "
                        "float64")
    for (name, shape), a in zip(shapes, args):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                             f"{shape}")
        if a.dtype != Cxx.dtype:
            raise TypeError(f"{name}: dtype {a.dtype}, expected {Cxx.dtype}")
        if a.device.type != "cuda" or a.device != Cxx.device:
            raise ValueError(f"{name} is on {a.device}, expected "
                             f"{Cxx.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return Bsz, T, nx, nu


def _launch(args, reg: float) -> Tuple[Tensor, Tensor, Tensor]:
    global launches
    Bsz, T, nx, nu = _check(args)
    gx, gu = args[3], args[4]
    dx, du, lam = torch.empty_like(gx), torch.empty_like(gu), \
        torch.empty_like(gx)
    if Bsz == 0:
        return dx, du, lam
    lib = cuda_build.load("riccati")
    fn = getattr(lib, _SYMBOLS[gx.dtype])
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    with torch.cuda.device(gx.device):
        err = fn(*(a.data_ptr() for a in args), dx.data_ptr(),
                 du.data_ptr(), lam.data_ptr(), Bsz, T, nx, nu, reg, stream)
    cuda_build.check(lib, err, "riccati kernel launch")
    launches += 1
    return dx, du, lam
