"""K3: batched Riccati LQR-KKT solve as hand-written CUDA kernels, the port
of diff_qp_mpc_tpu.ops.riccati_pallas.

Two kernels compute it:
- ``csrc/riccati.cu`` at the (T, nx, nu) of ``BUILT``: one thread per
  element, every stage loop unrolled, the element in registers (the
  DEQ-MPC tracker's horizon, T 5); a block of ``ELEMENTS_PER_BLOCK``
  elements stages its inputs through shared memory with bulk asynchronous
  copies, and each thread stores its element from registers
  (``staged_smem`` reads its sizes);
- ``csrc/riccati_horizon_warp.cu``, the horizon kernel, at the (nx, nu) of
  ``HORIZON_WARP_BUILT`` and any T: one warp per element, the stage's blocks
  and the recursion's temporaries in shared memory (``warp_smem``), each
  stage's K, k, P and p in a workspace this wrapper allocates (the
  quadrotor: its MPC expert's planner, T 20; its ip path and every ip
  backward, T 5; its slew-augmented (16, 4); the cartpoles', the
  pendulum's and the integrator's expert planners, T 10 to 120; and at T 5
  the shapes the unrolled kernel lacks: CartpoleCosSin's (5, 1) and the
  slew-augmented cartpoles' (5, 1) and (7, 1)).

A kernel of one thread per element served the horizons with one control
before; one card call timed it and the warp kernel in turns at every path
shape with one control, B 8-4096, both dtypes (NVIDIA H100 80GB HBM3 at
700 W; PERF.md): the warp kernel was faster at (4, 1) to (7, 1), e.g.
float32 at B 64 (60, 4, 1) 0.216 → 0.090 ms and (10, 6, 1) 0.048 → 0.026,
and at (2, 1) at the expert planners' batches (float64, B 64-200: (30, 2,
1) B 200 0.070 → 0.053 ms), so it replaced the one-thread kernel.

``batched_lqr_kkt_solve`` takes the plain PyTorch version
(``ops.riccati.batched_lqr_kkt_solve``) for CPU tensors. On CUDA tensors
it launches the kernel ``kernel_for`` names and raises where none is built;
it never falls back to the plain version. Each launch adds one to
``launches`` (the unrolled kernel) or ``horizon_launches`` (the horizon
kernel).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from diff_qp_mpc_tpu_torch.ops import riccati
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: (T, nx, nu) with an instantiation of the unrolled kernel
BUILT = ((5, 2, 1), (5, 3, 1), (5, 3, 2), (5, 4, 1), (5, 6, 1))
#: the elements a block of the unrolled kernel serves at every shape and
#: dtype, fixed at compile time (``kElementsPerBlock`` in
#: ``csrc/riccati.cu``, which this mirrors and ``staged_smem`` reports): of
#: 16, 32 and 64 the fastest at every shape and dtype at the paths' B 64
#: and 256, timed in turns on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
ELEMENTS_PER_BLOCK = 16
#: (nx, nu) with an instantiation of the horizon kernel (any T)
HORIZON_WARP_BUILT = ((12, 4), (16, 4), (2, 1), (4, 1), (5, 1), (6, 1),
                      (7, 1))
#: launches of the unrolled kernel since the count was last set to 0
launches = 0
#: launches of the horizon kernel since the count was last set to 0
horizon_launches = 0

_SYMBOLS = {torch.float32: "riccati_f32", torch.float64: "riccati_f64"}
_BITS = {torch.float32: "f32", torch.float64: "f64"}


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


def kernel_for(T: int, nx: int, nu: int) -> str:
    """"riccati" or "riccati_horizon_warp", the kernel a CUDA solve of this
    shape launches; raises where none is built for it."""
    if (T, nx, nu) in BUILT:
        return "riccati"
    if (nx, nu) in HORIZON_WARP_BUILT and T >= 1:
        return "riccati_horizon_warp"
    raise ValueError(f"no kernel for T={T}, nx={nx}, nu={nu} (built: "
                     f"(T, nx, nu) in {BUILT}, and (nx, nu) in "
                     f"{HORIZON_WARP_BUILT} at any T)")


def staged_smem(dtype: torch.dtype, T: int, nx: int, nu: int,
                device: torch.device) -> Dict[str, int]:
    """Shared memory of the unrolled kernel's (T, nx, nu, dtype)
    instantiation on ``device``: the elements a block it serves
    (``elements_per_block``), bytes an element's inputs (``per_element``)
    and a block (``per_block``), and the most a block may ask of the device
    (``device_max``)."""
    if (T, nx, nu) not in BUILT:
        raise ValueError(f"the unrolled kernel is not built for T={T}, "
                         f"nx={nx}, nu={nu}")
    lib = cuda_build.load("riccati")
    fn = getattr(lib, f"riccati_smem_{_BITS[dtype]}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = fn(T, nx, nu, *(ctypes.byref(o) for o in out))
    cuda_build.check(lib, err, "riccati shared-memory query")
    return dict(zip(("elements_per_block", "per_element", "per_block",
                     "device_max"), (o.value for o in out)))


def warp_smem(dtype: torch.dtype, nx: int, nu: int,
              device: torch.device) -> Dict[str, int]:
    """Shared memory of the horizon kernel's (nx, nu, dtype)
    instantiation on ``device``: bytes an element (``per_element``) and a
    block (``per_block``), and the most a block may ask of the device
    (``device_max``)."""
    if (nx, nu) not in HORIZON_WARP_BUILT:
        raise ValueError(f"the horizon kernel is not built for nx={nx}, "
                         f"nu={nu}")
    lib = cuda_build.load("riccati_horizon_warp")
    fn = getattr(lib, f"riccati_horizon_warp_smem_{_BITS[dtype]}")
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(nx, nu, *(ctypes.byref(o) for o in out))
    cuda_build.check(lib, err, "riccati_horizon_warp shared-memory query")
    return dict(zip(("per_element", "per_block", "device_max"),
                    (o.value for o in out)))


def _check(args):
    Cxx, Cxu = args[0], args[1]
    if Cxu.ndim != 4:
        raise ValueError("expected Cxu [B,T,nx,nu]")
    Bsz, T, nx, nu = Cxu.shape
    kernel_for(T, nx, nu)
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


def _launch(args, reg: float, name: Optional[str] = None
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """Launch the kernel ``kernel_for`` names, or ``name``; measurements
    pass "riccati_horizon_warp" to time the horizon kernel where the
    unrolled one serves."""
    global launches, horizon_launches
    Bsz, T, nx, nu = _check(args)
    name = name or kernel_for(T, nx, nu)
    if name != "riccati" and (nx, nu) not in HORIZON_WARP_BUILT:
        raise ValueError(f"the {name} kernel is not built for nx={nx}, "
                         f"nu={nu}")
    gx, gu = args[3], args[4]
    dx, du, lam = torch.empty_like(gx), torch.empty_like(gu), \
        torch.empty_like(gx)
    if Bsz == 0:
        return dx, du, lam
    lib = cuda_build.load(name)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    outs = [dx.data_ptr(), du.data_ptr(), lam.data_ptr()]
    if name == "riccati":
        fn = getattr(lib, _SYMBOLS[gx.dtype])
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_double, ctypes.c_void_p]
    else:
        lib.riccati_horizon_warp_workspace.restype = ctypes.c_int
        ws = gx.new_empty(T * lib.riccati_horizon_warp_workspace(nx, nu)
                          * Bsz)
        outs.append(ws.data_ptr())
        fn = getattr(lib, f"riccati_horizon_warp_{_BITS[gx.dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
            + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(gx.device):
        err = fn(*(a.data_ptr() for a in args), *outs, Bsz, T, nx, nu, reg,
                 stream)
    cuda_build.check(lib, err, f"{name} kernel launch")
    if name == "riccati":
        launches += 1
    else:
        horizon_launches += 1
    return dx, du, lam
