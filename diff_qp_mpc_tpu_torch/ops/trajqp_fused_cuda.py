"""K4: the whole interior-point trajectory-QP solve as one hand-written CUDA
kernel, the port of diff_qp_mpc_tpu.ops.trajqp_fused_pallas.

Two layouts (``LAYOUTS``). "thread" (``csrc/trajqp_fused.cu``): one thread
per batch element, its state in registers, at the smaller (T, nx, nu) of
``BUILT``. "warp"
(``csrc/trajqp_fused_warp.cu``): one warp per element, its blocks in
shared memory, at ``WARP_BUILT``: the cartpoles' shapes and the
quadrotor's, whose element does not fit one lane (at the cartpoles' the
warp layout measured faster than the thread layout at every batch and
dtype timed, and the thread layout's instantiations there were deleted).
``layout_for`` picks the layout by shape; any other shape raises.

``fused_trajqp_solve`` takes the plain PyTorch version
(``fused_trajqp_solve_reference``, same signature and semantics, any
shape) for CPU tensors and launches a kernel for CUDA tensors; it never
falls back from one to the other. Each launch adds one to ``launches``
(the thread layout) or ``warp_launches`` (the warp layout).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from diff_qp_mpc_tpu_torch.ops import riccati
from diff_qp_mpc_tpu_torch.utils import cuda_build

Tensor = torch.Tensor

#: (T, nx, nu) the thread layout serves
BUILT = ((5, 2, 1), (5, 3, 1), (5, 3, 2), (5, 4, 1))
#: (T, nx, nu) the warp layout serves: the cartpoles' (cp1's slew shape and
#: CartpoleCosSin's ip path, cp2's ip path, cp2's slew shape), the
#: quadrotor's ip path and its slew-augmented shape
WARP_BUILT = ((5, 5, 1), (5, 6, 1), (5, 7, 1), (5, 12, 4), (5, 16, 4))
LAYOUTS = ("thread", "warp")
#: launches of the thread layout since the count was last set to 0
launches = 0
#: launches of the warp layout since the count was last set to 0
warp_launches = 0

_SYMBOLS = {"thread": {torch.float32: "trajqp_fused_f32",
                       torch.float64: "trajqp_fused_f64"},
            "warp": {torch.float32: "trajqp_fused_warp_f32",
                     torch.float64: "trajqp_fused_warp_f64"}}
_LIBRARIES = {"thread": "trajqp_fused", "warp": "trajqp_fused_warp"}
# the step-length placeholder and the initial best total are float32's max
# in every dtype, as the reference kernel's are
_F32_MAX = float(torch.finfo(torch.float32).max)

#: (x, u, lam, z_hi, z_lo, s_hi, s_lo, resids)
Outputs = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor,
                Tensor]


def fused_trajqp_solve(C: Tensor, c: Tensor, A: Tensor, B: Tensor, f: Tensor,
                       x0: Tensor, x_init: Tensor, u_init: Tensor,
                       u_lo: Sequence[float], u_hi: Sequence[float],
                       max_iter: int = 12, reg: float = 1e-9,
                       min_slack: float = 1e-8) -> Outputs:
    """Whole-solver trajectory-QP IPM.

    C [B,T,n,n], c [B,T,n], A [B,T-1,nx,nx], B [B,T-1,nx,nu], f [B,T-1,nx],
    x0 [B,nx], x_init [B,T,nx], u_init [B,T,nu]; u_lo/u_hi: nu floats.
    Returns (x, u, lam, z_hi, z_lo, s_hi, s_lo, resids [B]).
    """
    args = (C, c, A, B, f, x0, x_init, u_init,
            tuple(float(v) for v in u_lo), tuple(float(v) for v in u_hi),
            int(max_iter), float(reg), float(min_slack))
    if C.device.type == "cpu":
        return fused_trajqp_solve_reference(*args)
    return _launch(*args)


def layout_for(T: int, nx: int, nu: int) -> str:
    """"thread" or "warp", the layout a CUDA solve of this shape takes;
    raises where neither serves it."""
    if (T, nx, nu) in WARP_BUILT:
        return "warp"
    if (T, nx, nu) in BUILT:
        return "thread"
    raise ValueError(f"no kernel for T={T}, nx={nx}, nu={nu} (built: "
                     f"(T, nx, nu) in {BUILT + WARP_BUILT})")


def fused_trajqp_solve_reference(C: Tensor, c: Tensor, A: Tensor, B: Tensor,
                                 f: Tensor, x0: Tensor, x_init: Tensor,
                                 u_init: Tensor, u_lo: Sequence[float],
                                 u_hi: Sequence[float], max_iter: int = 12,
                                 reg: float = 1e-9,
                                 min_slack: float = 1e-8) -> Outputs:
    """Plain PyTorch version of the kernel, batched over B on any device.

    The kernel's semantics, which differ from the scan IPM of
    ``solvers.trajqp.solve`` in corner cases: u_init clipped to
    [u_lo + 1e-3, u_hi − 1e-3] here too, with the clip constants folded in
    double precision; float32's max as the step-length placeholder and as
    the initial best total; σ's denominator floored at 1e-30; the best total
    updated by a select (a NaN total never becomes the best).
    """
    bsz, Tm1, nx, nu = B.shape
    T = Tm1 + 1
    kw = dict(dtype=C.dtype, device=C.device)
    Cxx, Cxu, Cuu = C[..., :nx, :nx], C[..., :nx, nx:], C[..., nx:, nx:]
    cx, cu = c[..., :nx], c[..., nx:]
    AT, BT, CxuT = (M.transpose(-1, -2) for M in (A, B, Cxu))
    lo, hi = torch.tensor(u_lo, **kw), torch.tensor(u_hi, **kw)
    n_comp = 2 * T * nu
    mv = riccati.mv
    nrm = lambda a: torch.linalg.vector_norm(a.reshape(bsz, -1), dim=1)

    x = x_init
    u = torch.clamp(u_init, torch.tensor([v + 1e-3 for v in u_lo], **kw),
                    torch.tensor([v - 1e-3 for v in u_hi], **kw))
    lam = torch.zeros(bsz, T, nx, **kw)
    s_hi = torch.clamp(hi - u, min=0.1)
    s_lo = torch.clamp(u - lo, min=0.1)
    z_hi = torch.ones(bsz, T, nu, **kw)
    z_lo = torch.ones(bsz, T, nu, **kw)

    def residuals(x, u, lam, z_hi, z_lo, s_hi, s_lo):
        nu_d = lam[:, 1:]
        r_x = cx + mv(Cxx, x) + mv(Cxu, u)
        r_x[:, :-1] -= mv(AT, nu_d)
        r_x[:, 1:] += nu_d
        r_x[:, 0] += lam[:, 0]
        r_u = cu + z_hi - z_lo + mv(CxuT, x) + mv(Cuu, u)
        r_u[:, :-1] -= mv(BT, nu_d)
        r_dyn = x[:, 1:] - f - mv(A, x[:, :-1]) - mv(B, u[:, :-1])
        return (r_x, r_u, r_dyn, x[:, 0] - x0, u - hi + s_hi,
                lo - u + s_lo, s_hi * z_hi, s_lo * z_lo)

    def resid_norm(rs):
        r_x, r_u, r_dyn, r_init, r_p_hi, r_p_lo, r_s_hi, r_s_lo = rs
        mu = (r_s_hi + r_s_lo).sum(dim=(1, 2)) / n_comp
        total = (nrm(r_dyn) + nrm(r_init) + nrm(r_p_hi) + nrm(r_p_lo)
                 + nrm(r_x) + nrm(r_u) + n_comp * mu.abs())
        return total, mu

    def kkt_step(z_hi, z_lo, s_hi, s_lo, rs):
        r_x, r_u, r_dyn, r_init, r_p_hi, r_p_lo, r_s_hi, r_s_lo = rs
        gu = r_u + ((z_hi * r_p_hi - r_s_hi) / s_hi
                    - (z_lo * r_p_lo - r_s_lo) / s_lo)
        Cuu_eff = Cuu + torch.diag_embed(z_hi / s_hi + z_lo / s_lo)
        sol = riccati.batched_lqr_kkt_solve(Cxx, Cxu, Cuu_eff, r_x, gu, A, B,
                                            -r_dyn, -r_init, reg)
        ds_hi = -r_p_hi - sol.du
        ds_lo = -r_p_lo + sol.du
        return (sol.dx, sol.du, sol.lam, ds_hi, ds_lo,
                -(r_s_hi + z_hi * ds_hi) / s_hi,
                -(r_s_lo + z_lo * ds_lo) / s_lo)

    def max_step(vs, dvs):
        v = torch.cat([a.reshape(bsz, -1) for a in vs], dim=1)
        dv = torch.cat([a.reshape(bsz, -1) for a in dvs], dim=1)
        neg = dv < 0
        steps = torch.where(neg, -v / torch.where(neg, dv, -1.0), _F32_MAX)
        return torch.clamp(steps.amin(dim=1), max=1.0)

    state = (x, u, lam, z_hi, z_lo, s_hi, s_lo)
    best = state
    b_tot = torch.full((bsz,), _F32_MAX, **kw)
    col = lambda m: m.reshape(bsz, 1, 1)
    for _ in range(max_iter):
        x, u, lam, z_hi, z_lo, s_hi, s_lo = state
        rs = residuals(*state)
        total, mu = resid_norm(rs)
        better = total < b_tot
        best = tuple(torch.where(col(better), a, b)
                     for a, b in zip(state, best))
        b_tot = torch.where(better, total, b_tot)

        # affine (predictor)
        dxa, dua, dla, dsha, dsla, dzha, dzla = kkt_step(
            z_hi, z_lo, s_hi, s_lo, rs)
        a = col(max_step((s_hi, s_lo, z_hi, z_lo), (dsha, dsla, dzha, dzla)))
        mu_aff = ((s_hi + a * dsha) * (z_hi + a * dzha)
                  + (s_lo + a * dsla) * (z_lo + a * dzla)).sum(dim=(1, 2)) \
            / n_comp
        ratio = mu_aff / torch.clamp(mu, min=1e-30)
        smu = col(ratio * ratio * ratio * mu)

        # centering-corrector: zero residuals but complementarity
        zr = torch.zeros_like
        rs_c = (zr(rs[0]), zr(rs[1]), zr(rs[2]), zr(rs[3]), zr(rs[4]),
                zr(rs[5]), dsha * dzha - smu, dsla * dzla - smu)
        dc = kkt_step(z_hi, z_lo, s_hi, s_lo, rs_c)
        dx, du, dl, dsh, dsl, dzh, dzl = (
            p + q for p, q in zip((dxa, dua, dla, dsha, dsla, dzha, dzla),
                                  dc))
        alpha = col(0.99 * max_step((s_hi, s_lo, z_hi, z_lo),
                                    (dsh, dsl, dzh, dzl)))
        state = (x + alpha * dx, u + alpha * du, lam + alpha * dl,
                 torch.clamp(z_hi + alpha * dzh, min=min_slack),
                 torch.clamp(z_lo + alpha * dzl, min=min_slack),
                 torch.clamp(s_hi + alpha * dsh, min=min_slack),
                 torch.clamp(s_lo + alpha * dsl, min=min_slack))

    total, _ = resid_norm(residuals(*state))
    better = col(total < b_tot)
    out = tuple(torch.where(better, a, b) for a, b in zip(state, best))
    return out + (torch.minimum(total, b_tot),)


def _check(C, c, A, B, f, x0, x_init, u_init, u_lo, u_hi):
    if B.ndim != 4:
        raise ValueError("expected B [B,T-1,nx,nu]")
    Bsz, Tm1, nx, nu = B.shape
    T, n = Tm1 + 1, nx + nu
    layout_for(T, nx, nu)
    if len(u_lo) != nu or len(u_hi) != nu:
        raise ValueError(f"expected {nu} bounds, got {u_lo}, {u_hi}")
    if C.dtype not in _SYMBOLS["thread"]:
        raise TypeError(f"dtype {C.dtype}: the kernel takes float32 or "
                        "float64")
    shapes = {"C": (C, (Bsz, T, n, n)), "c": (c, (Bsz, T, n)),
              "A": (A, (Bsz, Tm1, nx, nx)), "B": (B, (Bsz, Tm1, nx, nu)),
              "f": (f, (Bsz, Tm1, nx)), "x0": (x0, (Bsz, nx)),
              "x_init": (x_init, (Bsz, T, nx)),
              "u_init": (u_init, (Bsz, T, nu))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)}, expected "
                             f"{shape}")
        if a.dtype != C.dtype:
            raise TypeError(f"{name}: dtype {a.dtype}, expected {C.dtype}")
        if a.device.type != "cuda" or a.device != C.device:
            raise ValueError(f"{name} is on {a.device}, expected {C.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return Bsz, T, nx, nu


def warp_smem(dtype: torch.dtype, T: int, nx: int, nu: int,
              device: torch.device) -> Dict[str, int]:
    """Shared memory of the warp layout's (T, nx, nu, dtype) instantiation
    on ``device``: bytes an element (``per_element``) and a block
    (``per_block``), and the most a block may ask of the device
    (``device_max``)."""
    if (T, nx, nu) not in WARP_BUILT:
        raise ValueError(f"the warp layout is not built for T={T}, "
                         f"nx={nx}, nu={nu}")
    lib = cuda_build.load(_LIBRARIES["warp"])
    bits = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(lib, f"trajqp_fused_warp_smem_{bits}")
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(T, nx, nu, *(ctypes.byref(o) for o in out))
    cuda_build.check(lib, err, "trajqp_fused_warp shared-memory query")
    return dict(zip(("per_element", "per_block", "device_max"),
                    (o.value for o in out)))


def _launch(C, c, A, B, f, x0, x_init, u_init, u_lo, u_hi, max_iter, reg,
            min_slack, layout: Optional[str] = None) -> Outputs:
    """Launch the layout ``layout_for`` picks, or ``layout`` where it is
    instantiated (``kernel_layouts.k4_layouts`` times each layout a shape
    has)."""
    global launches, warp_launches
    Bsz, T, nx, nu = _check(C, c, A, B, f, x0, x_init, u_init, u_lo, u_hi)
    layout = layout or layout_for(T, nx, nu)
    built = {"thread": BUILT, "warp": WARP_BUILT}.get(layout, ())
    if (T, nx, nu) not in built:
        raise ValueError(f"the {layout} layout is not built for T={T}, "
                         f"nx={nx}, nu={nu} (layouts: {LAYOUTS})")
    x, lam = torch.empty_like(x_init), torch.empty_like(x_init)
    u, zh, zl, sh, sl = (torch.empty_like(u_init) for _ in range(5))
    res = x0.new_empty(Bsz)
    outs = (x, u, lam, zh, zl, sh, sl, res)
    if Bsz == 0:
        return outs
    lib = cuda_build.load(_LIBRARIES[layout])
    fn = getattr(lib, _SYMBOLS[layout][C.dtype])
    dblu = ctypes.c_double * nu
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_double] * 2 + [ctypes.POINTER(ctypes.c_double)] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(C.device).cuda_stream
    with torch.cuda.device(C.device):
        err = fn(*(a.data_ptr() for a in (C, c, A, B, f, x0, x_init, u_init)),
                 *(o.data_ptr() for o in outs), Bsz, T, nx, nu, max_iter,
                 reg, min_slack, dblu(*u_lo), dblu(*u_hi), stream)
    cuda_build.check(lib, err, f"{_LIBRARIES[layout]} kernel launch")
    if layout == "thread":
        launches += 1
    else:
        warp_launches += 1
    return outs
