"""K2's lanes per element and K1's, K3's and K4's layouts on the card.

    python -m diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts \\
        [--out build/kernel_layouts.json]

At the batches of ``BATCHES`` (the main path's 64 and 256, 4096, and a
filled card's 262144), float32, on the main path's problem shapes (T 5,
pendulum, n 3):
  - K2 at every G of ``al_fused_cuda.GROUPS``: device time per launch, the
    G the wrapper's rule picks, and the outputs at every G bit-identical to
    G = 1 (also in float64 at B 64 and 256, and on a problem whose Newton
    direction is 0, where every candidate ties);
  - K2's line search at B 64: n_ls 1 against 20 at each G, so that
    (t₂₀ − t₁)/19 is one candidate's latency;
  - K1 in each layout of ``btsolve_cuda.LAYOUTS``: device time, error
    against its plain version (``K1_TOL``), bound and share of it; also at
    B 64 and 4096 at the other shapes with an on-chip instantiation, and at
    the quadrotor's n 16 (B 8, 64, 128, 256: the streaming layout and the
    warp layout in each compute type, ``k1_layouts``);
  - K1 on the AL path's own Newton systems (``k1_al_systems``): float32
    against the float64 solution at ρ 1 … 1e6, within ``K1_AL_RATIO`` of
    the plain float32 version's own error; and the warp layout's float32
    computation on the quadrotor's systems over ``K1_RULE_SEEDS`` draws
    (``k1_compute_rule``), the check that sets its compute type;
  - K3's horizon kernel (one warp per element) at the quadrotor's (nx, nu)
    (``k3_layouts``: ``K3_WARP_SHAPES`` × ``K3_WARP_BATCHES``) and at every
    path shape with one control (``k3_thread_shapes``: ``K3_THREAD_SHAPES``
    × ``K3_THREAD_BATCHES``), both dtypes: queued-event ms, the profiler's
    ms, errors against the plain version (float64 within
    ``K3_LAYOUT_TOL``; float32 against the float64 solution within
    ``F32_VS_F64_RATIO`` of the plain float32 version's error); with
    ``--against DIR``, the one-thread horizon kernel of another checkout
    (``DIR/diff_qp_mpc_tpu_torch/csrc/riccati_horizon.cu``, built with
    this tree's flags) beside it where that source builds the shape, held
    to the same errors and timed in turns (thread, warp, warp, thread);
  - K4 at the cartpoles' shapes (``k4_layouts``): the warp layout and,
    where it is still built, the thread layout, at ``K4_WARP_BATCHES``,
    both dtypes, timed in the same turns, each within ``K4W_TOL`` of the
    plain version on all eight outputs;
  - K3's unrolled kernel (``k3_unrolled``) at every shape of
    ``riccati_cuda.BUILT``, both dtypes, ``K3_UNROLLED_BATCHES``: with
    ``--against DIR`` beside the unrolled kernel of another checkout
    (``DIR/diff_qp_mpc_tpu_torch/csrc/riccati.cu``), both timed in turns by
    the profiler's device time (forward, then backward), the bound's share,
    the errors against the plain version (as ``k3_layouts``) and whether
    every output is bit-identical to the other checkout's;
  - K4's thread layout (``k4_thread``) at every shape of
    ``trajqp_fused_cuda.BUILT``, both dtypes, ``K4_THREAD_BATCHES``, on the
    profiler benchmark's random box QPs: within ``K4_TOL`` of the plain
    version on all eight outputs, float32 also against the float64
    solution within ``F32_VS_F64_RATIO`` of the plain float32 version's
    error (its one-ulp envelope decides; the share of the limit taken from
    its bare error is printed beside it);
    with ``--against DIR`` the other checkout's ``trajqp_fused.cu``
    beside it, held to the same, both timed in turns by the profiler.
A mismatch, or an error above tolerance, raises. Without a card it raises.
``chip_smoke.py`` runs the same K1 and K2 checks.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks.flops import (
    SINF_FP32_INSTR,
    bound,
    k1_bytes,
    k1_ops,
    k2_bytes,
    k2_ops_with_sin,
    k3_bytes,
    k3_ops,
    k4_bytes,
    k4_ops,
)
from diff_qp_mpc_tpu_torch.benchmarks.timing import (
    device_kernel_ms,
    events_ms,
    queued_events_ms,
)
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import (
    al_fused_cuda,
    btsolve,
    btsolve_cuda,
    riccati,
    riccati_cuda,
    trajqp_fused_cuda,
)
from diff_qp_mpc_tpu_torch.utils import cuda_build

BATCHES = (64, 256, 4096, 262144)
T, NX, NU = 5, 2, 1
N = NX + NU
# K2's budget on the main path (ALConfig defaults, qp_iter 2)
AL_BUDGET = dict(al_iter=2, n_newton=4, n_ls=20, rho_factor=10.0,
                 rho_max=1e6, reg=1e-7)
BOX = ((-3.0,), (3.0,))
# K1 relative to max|x| (a direct solve: rounding only)
K1_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# B at which K2's float64 outputs are held bit-identical across G
K2_F64_BATCHES = (64, 256)
# K1 on the AL path's Newton systems: cond(H) ≈ ρ/reg, so at ρ ≥ 1e4 no
# float32 solve meets K1_TOL against another (the plain float32 version
# reads ~6e-4 at ρ 1e4 and ~5e-2 at 1e6 from float64 on these systems, B
# 4096, H100). Each float32 solve is held against the float64 solution
# instead: K1's error at most K1_AL_RATIO times the plain float32
# version's on the same systems
K1_AL_RHOS = (1.0, 1e2, 1e4, 1e6)
#: the quadrotor's, up to its checkpoint's rho_max
K1_QUAD_AL_RHOS = (1.0, 1e2, 1e4)
K1_AL_RATIO = 2.0
#: the draws (seeds of ``al_systems``) over which the warp layout's float32
#: computation must meet K1_AL_RATIO on the quadrotor's systems (B 128, ρ
#: up to K1_QUAD_AL_RHOS) to be the compute type of float32 inputs
K1_RULE_SEEDS = tuple(range(8))
#: the batches K1 is timed at on the quadrotor's block size
K1_WARP_BATCHES = (8, 64, 128, 256)
# K3 in float32 over the expert planners' horizons (T ≥ 10) and on the
# IPM's own Riccati systems, and K4 in float32 on the cp2 ip checkpoint's
# QPs (terminal P entries to 2.5e5): the recursion's rounding grows with T
# and with P, so two float32 solves do not meet K3_TOL / K4_TOL against
# each other. Each is held against the float64 solution of the same
# inputs instead, as K1 on the AL systems: the kernel's error at most
# F32_VS_F64_RATIO times the plain float32 version's (or within the float32
# tolerance, where the plain version's error is below it)
F32_VS_F64_RATIO = 2.0
#: K3 relative to the largest entry (a direct solve: rounding only)
K3_LAYOUT_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
#: K4 on the warp layout, each output's error over max(1, its largest
#: entry): its sums over the warp (the norms, μ, σ) run in another order
#: than the plain version's, so it agrees to rounding, not bit for bit
K4W_TOL = {torch.float32: 5e-3, torch.float64: 1e-9}
#: K3's horizon-kernel layouts are timed at the quadrotor's ip and expert
#: shapes and its slew shape, at the expert's B 16, the paths' 64 and 128,
#: the dataset's 300 and a filled card's 4096
K3_WARP_SHAPES = ((5, 12, 4), (20, 12, 4), (5, 16, 4))
K3_WARP_BATCHES = (16, 64, 128, 300, 4096)
#: K3's horizon kernel at every path shape with one control (the MPC
#: experts' planners, the slew shapes), at the paths' batches 8 (DAgger's
#: relabeling in chip_smoke.py), 16, 64 (the experts in chip_smoke.py),
#: 200 (the datasets, and DAgger's default relabeling) and 4096
K3_THREAD_SHAPES = ((60, 4, 1), (80, 4, 1), (10, 6, 1), (120, 6, 1),
                    (20, 2, 1), (30, 2, 1), (40, 2, 1), (5, 5, 1), (5, 7, 1))
K3_THREAD_BATCHES = (8, 16, 64, 200, 4096)
#: K4's layouts at the cartpoles' shapes, at the paths' 64 and 256 and 4096
K4_WARP_SHAPES = ((5, 5, 1), (5, 6, 1), (5, 7, 1))
K4_WARP_BATCHES = (64, 256, 4096)
#: K4's budget on the ip path (TrajQPConfig defaults)
K4_BUDGET = dict(max_iter=12, reg=1e-9, min_slack=1e-8)
#: K4 (the thread layout) against its plain version, each output's error
#: over max(1, its largest entry); chip_smoke.py holds K4 to it (the reason
#: for its values is there)
K4_TOL = {torch.float32: 1e-3, torch.float64: 1e-8}
#: K3's unrolled kernel is timed at the paths' 64 and 256, 4096, and a
#: filled card's 262144
K3_UNROLLED_BATCHES = (64, 256, 4096, 262144)
#: K4's thread layout at the paths' 64 and 256 and 4096
K4_THREAD_BATCHES = (64, 256, 4096)


def _reps(B: int) -> int:
    """Launches per timing: fewer where one launch is long."""
    return 50 if B <= 4096 else 10


def _device_ms(fns, B, name):
    """Device ms per launch of the kernel named ``name`` for each of
    ``fns`` in turn (one profiler session each)."""
    return [device_kernel_ms(fn, _reps(B), name) for fn in fns]


# ------------------------------------------------------------ inputs ----
def random_bt_spd(B, T_, n, dtype, seed, device="cuda"):
    """SPD block-tridiagonal H = L Lᵀ, L block lower bidiagonal with
    well-conditioned diagonal blocks; returns D, O, b."""
    rng = np.random.RandomState(seed)
    Ld = np.tril(0.3 * rng.randn(B, T_, n, n), -1) + np.eye(n) * (
        1.0 + rng.rand(B, T_, n, 1))
    Ls = 0.3 * rng.randn(B, T_, n, n)  # Ls[:, t] couples t to t-1
    D = Ld @ Ld.transpose(0, 1, 3, 2)
    D[:, 1:] += Ls[:, 1:] @ Ls[:, 1:].transpose(0, 1, 3, 2)
    O = Ls[:, 1:] @ Ld[:, :-1].transpose(0, 1, 3, 2)
    b = rng.randn(B, T_, n)
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return to(D), to(O), to(b)


def lqr_problem(B, T_, nx, nu, dtype, seed, device="cuda"):
    """Random LQR-KKT system with SPD stage costs (K3's inputs)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T_, nx, nx)
    Mu = rng.randn(B, T_, nu, nu)
    arrays = (M @ M.transpose(0, 1, 3, 2) + np.eye(nx),
              0.2 * rng.randn(B, T_, nx, nu),
              Mu @ Mu.transpose(0, 1, 3, 2) + np.eye(nu),
              rng.randn(B, T_, nx), rng.randn(B, T_, nu),
              np.eye(nx) + 0.1 * rng.randn(B, T_ - 1, nx, nx),
              0.2 * rng.randn(B, T_ - 1, nx, nu),
              0.1 * rng.randn(B, T_ - 1, nx), rng.randn(B, nx))
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


def k2_inputs(B, dtype, seed, device="cuda"):
    """Tracking problems like the policy's: x0 in the pendulum env's range,
    a reference that drifts from x0, Cd = (Q, R), c = −Cd·τ_ref; returns
    Cd, c, x0, x_init (the reference), u_init (0)."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    x_ref[:, 0] = x0
    u_ref = np.zeros((B, T, NU))
    Cd = np.broadcast_to(np.array([10.0, 1.0, 0.01]), (B, T, N))
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    to = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)
    return to(Cd), to(c), to(x0), to(x_ref), to(u_ref)


def k2_tie_inputs(B, dtype, device="cuda"):
    """x0 = 0, x_init = u_init = 0, c = 0: the merit's gradient is 0 at the
    start, so the Newton direction is 0, every candidate of every line
    search has the incumbent's merit, and no step is taken."""
    Cd = torch.tensor([10.0, 1.0, 0.01], dtype=dtype,
                      device=device).expand(B, T, N).contiguous()
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return Cd, z(B, T, N), z(B, NX), z(B, T, NX), z(B, T, NU)


def _k2_args(arrays):
    Cd, c, x0, xi, ui = arrays
    return (Pendulum(), Cd, c, x0, *BOX, xi, ui)


def _same(a, b) -> bool:
    """Bit-identical tuples of tensors (NaNs in the same places count)."""
    return all(x.shape == y.shape and torch.equal(
        x.view(torch.int64 if x.dtype == torch.float64 else torch.int32),
        y.view(torch.int64 if y.dtype == torch.float64 else torch.int32))
        for x, y in zip(a, b))


# ---------------------------------------------------------------- K2 ----
def k2_groups(batches=BATCHES, budget=AL_BUDGET) -> list:
    """K2 at every G, per batch: device ms per launch, the G the rule picks,
    bit-identity with G = 1 (raises on a mismatch)."""
    rows = []
    for B in batches:
        arrays = k2_inputs(B, torch.float32, seed=B)
        args = _k2_args(arrays)
        outs = {G: al_fused_cuda.fused_al_solve(*args, **budget, group=G)
                for G in al_fused_cuda.GROUPS}
        torch.cuda.synchronize()
        identical = {G: _same(outs[G], outs[1]) for G in outs}
        fns = [lambda G=G: al_fused_cuda.fused_al_solve(*args, **budget,
                                                        group=G)
               for G in al_fused_cuda.GROUPS]
        ms = _device_ms(fns, B, "al_fused_kernel")
        resident = al_fused_cuda.resident_threads(torch.float32, T,
                                                  arrays[0].device)
        nbytes = B * k2_bytes(T, NX, NU)
        nops = B * k2_ops_with_sin(
            T, NX, NU, budget["al_iter"], budget["n_newton"],
            budget["n_ls"], SINF_FP32_INSTR)
        bound_ms, bound_by = bound(nbytes, nops)
        row = dict(B=B, dtype="float32", resident_threads=resident,
                   chosen_group=al_fused_cuda.choose_group(B, resident),
                   identical_to_g1=identical,
                   ms={G: m for G, m in zip(al_fused_cuda.GROUPS, ms)},
                   ms_events_chosen=events_ms(
                       lambda: al_fused_cuda.fused_al_solve(*args, **budget),
                       _reps(B)),
                   bound_ms=bound_ms, bound_by=bound_by)
        for dtype in (torch.float64,) if B in K2_F64_BATCHES else ():
            a64 = _k2_args(k2_inputs(B, dtype, seed=B))
            o64 = {G: al_fused_cuda.fused_al_solve(*a64, **budget, group=G)
                   for G in al_fused_cuda.GROUPS}
            row["identical_to_g1_float64"] = {
                G: _same(o64[G], o64[1]) for G in o64}
        rows.append(row)
        if not all(identical.values()) or not all(
                row.get("identical_to_g1_float64", {1: True}).values()):
            raise RuntimeError(f"K2 differs between group widths: {row}")
    return rows


def k2_tie(B=64, budget=AL_BUDGET) -> dict:
    """The all-tie problem at every G, float32 and float64: every output
    bit-identical to G = 1 and the trajectory left at 0."""
    row = dict(B=B)
    for dtype in (torch.float32, torch.float64):
        args = _k2_args(k2_tie_inputs(B, dtype))
        outs = {G: al_fused_cuda.fused_al_solve(*args, **budget, group=G)
                for G in al_fused_cuda.GROUPS}
        torch.cuda.synchronize()
        ok = all(_same(outs[G], outs[1]) for G in outs) and \
            float(outs[1][0].abs().max()) == 0.0
        row[str(dtype)] = ok
        if not ok:
            raise RuntimeError(f"K2 on the all-tie problem, {dtype}: the "
                               "group widths differ or a step was taken")
    return row


def k2_ls_split(B=64, budget=AL_BUDGET) -> dict:
    """Device ms per launch at n_ls 1 and n_ls 20 for every G, and one
    candidate's latency (t₂₀ − t₁)/19 at each."""
    args = _k2_args(k2_inputs(B, torch.float32, seed=B))
    fns = [lambda G=G, n_ls=n_ls: al_fused_cuda.fused_al_solve(
        *args, **dict(budget, n_ls=n_ls), group=G)
        for G in al_fused_cuda.GROUPS for n_ls in (1, budget["n_ls"])]
    ms = _device_ms(fns, B, "al_fused_kernel")
    out = {}
    for i, G in enumerate(al_fused_cuda.GROUPS):
        t1, t20 = ms[2 * i], ms[2 * i + 1]
        per = (t20 - t1) / (budget["n_ls"] - 1)
        out[G] = dict(ms_n_ls_1=t1, ms_n_ls_20=t20, ms_per_candidate=per,
                      line_search_share=per * budget["n_ls"] / t20)
    return dict(B=B, by_group=out)


# ---------------------------------------------------------------- K1 ----
def _k1_variants(dtype, n, T_):
    """(name, layout, compute) of every K1 variant built at (dtype, n, T_):
    each layout, and the warp layout once in each compute type (named
    "warp" for ``WARP_COMPUTE``'s and "warp_<type>" for the other)."""
    out = []
    for lay in btsolve_cuda.LAYOUTS:
        if lay == "onchip" and (n, T_) not in btsolve_cuda.ONCHIP_SHAPES[
                dtype]:
            continue
        if lay == "warp":
            if n not in btsolve_cuda.WARP_SIZES:
                continue
            rule = btsolve_cuda.WARP_COMPUTE[dtype]
            out += [("warp" if c == rule else f"warp_{str(c)[6:]}", lay, c)
                    for c in (torch.float32, torch.float64)
                    if not (c == torch.float32 and dtype == torch.float64)]
            continue
        out.append((lay, lay, None))
    return out


def _k1_solve(D, O, b, reg, layout=None, compute=None):
    """K1 on the card in ``layout`` (None: the rule's) computing in
    ``compute`` on the warp layout (None: ``WARP_COMPUTE``'s), through the
    wrapper's launch: the public entry point leaves the compute type to
    the rule, which this module's checks set."""
    return btsolve_cuda._launch(D, O, b, float(reg), layout, compute)


def k1_layouts(batches=BATCHES, reg=AL_BUDGET["reg"], n=N, T_=T) -> list:
    """K1 in each layout built at (n, T_) (the main path's (3, 5) by
    default; at a warp block size the warp layout in each compute type):
    device ms per launch (float32), error against the plain version in
    float32 and float64 (raises above K1_TOL), the bytes bound and its
    share."""
    rows = []
    for B in batches:
        row = dict(B=B, n=n, T=T_,
                   chosen_layout=btsolve_cuda.choose_layout(torch.float32,
                                                            n, T_))
        for dtype in (torch.float32, torch.float64):
            variants = _k1_variants(dtype, n, T_)
            D, O, b = random_bt_spd(B, T_, n, dtype, seed=B)
            ref = btsolve.batched_factor_solve(D, O, b, reg)
            scale = float(ref.abs().max())
            for name, lay, comp in variants:
                x = _k1_solve(D, O, b, reg, lay, comp)
                abs_err = float((x - ref).abs().max())
                err = abs_err / scale
                row[f"max_rel_err_{name}_{dtype}"] = err
                row[f"max_abs_err_{name}_{dtype}"] = abs_err
                if not (bool(torch.isfinite(x).all())
                        and err <= K1_TOL[dtype]):
                    raise RuntimeError(f"K1 ({name}) disagrees with its "
                                       f"plain version: {row}")
            if dtype == torch.float32:
                fns = [lambda lay=lay, comp=comp:
                       _k1_solve(D, O, b, reg, lay, comp)
                       for _, lay, comp in variants]
                row["ms"] = dict(zip([v[0] for v in variants],
                                     _device_ms(fns, B, "btsolve")))
                row["bound_ms"], row["bound_by"] = bound(
                    B * k1_bytes(T_, n), B * k1_ops(T_, n))
                row["bound_share"] = {
                    lay: row["bound_ms"] / m for lay, m in row["ms"].items()}
                if n in btsolve_cuda.WARP_SIZES:
                    row["warp_shared_memory"] = btsolve_cuda.warp_smem(
                        dtype, T_, n, D.device)
        rows.append(row)
    return rows


def al_systems(B, rho, dtype=torch.float64, seed=0, device="cuda",
               model_name=None, T_=T):
    """The pinned Gauss-Newton systems (D, O) and merit gradient g the AL
    path solves at penalty ``rho`` (reg 1e-7 comes with the solve), built by
    ``almerit.merit_grad_hess`` and ``newton_al.pin_first_state`` at the
    solution and multipliers of tracking problems at AL_BUDGET; and a
    random cotangent with its x₀ rows 0, the backward's right-hand side.
    The problems are the main path's (``k2_inputs``, the pendulum at T 5,
    solved by K2) or, given ``model_name``, ``k2_models.problem``'s for
    that model at horizon ``T_`` (solved by K2's plain version at the
    model's budget, ``k2_models.budget``)."""
    from diff_qp_mpc_tpu_torch.core.types import (
        Bounds,
        DiagQuadCost,
        Lambdas,
    )
    from diff_qp_mpc_tpu_torch.ops import almerit, newton_al

    if model_name is None:
        Cd, c, x0, xi, ui = k2_inputs(B, dtype, seed, device)
        model, box = Pendulum(), BOX
        solve, budget = al_fused_cuda.fused_al_solve, AL_BUDGET
    else:
        from diff_qp_mpc_tpu_torch.benchmarks import k2_models

        model, Cd, c, x0, *box, xi, ui = k2_models.problem(
            model_name, B, T_, dtype, seed, device)
        solve = al_fused_cuda.fused_al_solve_reference
        budget = k2_models.budget(model_name)
    nx = model.nx
    xu, lamd, lamh, laml, _ = solve(model, Cd, c, x0, *box, xi, ui,
                                    **budget)
    lam = Lambdas(lam_dyn=lamd, lam_init=torch.zeros_like(x0), lam_hi=lamh,
                  lam_lo=laml)
    g, D, O, _ = almerit.merit_grad_hess(
        DiagQuadCost(Cd=Cd, c=c), model.jac, xu[..., :nx], xu[..., nx:], x0,
        Bounds(u_lo=box[0], u_hi=box[1]), lam,
        torch.full((B, 1), rho, dtype=dtype, device=device))
    g, D, O = newton_al.pin_first_state(g, D, O, nx)
    rng = np.random.RandomState(seed + 1)
    ct = torch.tensor(rng.randn(*xu.shape), dtype=dtype, device=device)
    ct[:, 0, :nx] = 0.0
    return D.contiguous(), O.contiguous(), g.contiguous(), ct


def _k1_al_row(D, O, rhs, reg, compute=None) -> dict:
    """K1's float32 solve of D, O, rhs (float64 systems, rounded to
    float32) and the plain float32 version's, each error the max over the
    batch relative to the float64 solution's largest entry, and the
    ratio."""
    x64 = btsolve.batched_factor_solve(D, O, rhs, reg)
    f32 = [a.float() for a in (D, O, rhs)]
    scale = float(x64.abs().max())
    err = lambda x: float((x.double() - x64).abs().max()) / scale
    row = dict(max_rel_err_kernel=err(_k1_solve(*f32, reg, None, compute)),
               max_rel_err_plain=err(btsolve.batched_factor_solve(*f32, reg)))
    row["ratio"] = row["max_rel_err_kernel"] / max(
        row["max_rel_err_plain"], 1e-300)
    return row


def k1_al_systems(B=4096, rhos=K1_AL_RHOS, reg=AL_BUDGET["reg"],
                  model_name=None, T_=T, seed=0) -> list:
    """K1 in float32 on the AL path's systems (``al_systems`` at ``seed``,
    the pendulum's or ``model_name``'s at ``T_``), for the Newton step's
    right-hand side (the gradient) and the backward's (a cotangent): its
    error and the plain float32 version's, each the max over the batch
    relative to the float64 solution's largest entry. Raises where K1's
    error exceeds K1_AL_RATIO times the plain version's, or is not
    finite."""
    rows = []
    for rho in rhos:
        D, O, g, ct = al_systems(B, rho, seed=seed, model_name=model_name,
                                 T_=T_)
        for rhs_name, rhs in (("gradient", g), ("cotangent", ct)):
            row = dict(model=model_name or "pendulum", n=D.shape[-1],
                       T=D.shape[1], B=B, rho=rho, reg=reg, rhs=rhs_name,
                       seed=seed, **_k1_al_row(D, O, rhs, reg),
                       ratio_limit=K1_AL_RATIO)
            rows.append(row)
            if not row["max_rel_err_kernel"] <= (
                    K1_AL_RATIO * row["max_rel_err_plain"]):
                raise RuntimeError(f"K1 on the AL systems: {row}")
    return rows


def k1_compute_rule(seeds=K1_RULE_SEEDS, B=128, reg=AL_BUDGET["reg"]) -> dict:
    """The check that sets the warp layout's compute type for float32
    inputs: K1's warp layout at n 16 computing in float32 and in float64 on
    the quadrotor's AL systems (``al_systems`` at B, ρ up to
    K1_QUAD_AL_RHOS, the gradient and a cotangent) drawn at each of
    ``seeds``: per compute type each draw's ratio to the plain float32
    version's error, the worst, and whether every draw meets K1_AL_RATIO.
    Raises on a non-finite solve."""
    rows = []
    for seed in seeds:
        for rho in K1_QUAD_AL_RHOS:
            D, O, g, ct = al_systems(B, rho, seed=seed,
                                     model_name="quadrotor", T_=T)
            for rhs_name, rhs in (("gradient", g), ("cotangent", ct)):
                for comp in (torch.float32, torch.float64):
                    row = dict(seed=seed, rho=rho, rhs=rhs_name,
                               compute=str(comp),
                               **_k1_al_row(D, O, rhs, reg, compute=comp))
                    if not math.isfinite(row["max_rel_err_kernel"]):
                        raise RuntimeError(f"K1 warp: not finite: {row}")
                    rows.append(row)
    out = dict(B=B, seeds=list(seeds), ratio_limit=K1_AL_RATIO, rows=rows)
    for comp in (torch.float32, torch.float64):
        mine = [r for r in rows if r["compute"] == str(comp)]
        out[str(comp)] = dict(
            worst_ratio=max(r["ratio"] for r in mine),
            every_draw_within=all(r["ratio"] <= K1_AL_RATIO for r in mine))
    return out


# ---------------------------------------------------------- K3, K4 ----
def _turns(fns, reps):
    """Queued-event ms per call of each of ``fns`` (two), timed in turns
    a, b, b, a; the mean of each one's two readings."""
    a, b = fns
    ms = [queued_events_ms(f, reps) for f in (a, b, b, a)]
    return (ms[0] + ms[3]) / 2, (ms[1] + ms[2]) / 2


def _rel(got, want):
    """The largest over matching tensors of max |got − want| / max |want|,
    in float64."""
    return max(float((g.double() - w.double()).abs().max()
                     / w.double().abs().max()) for g, w in zip(got, want))


def _one_thread_k3(lib, args, reg):
    """The one-thread horizon kernel of another checkout (``lib``, its
    ``csrc/riccati_horizon.cu``) on ``args``: (dx, du, lam); raises where
    it is not built for the shape."""
    import ctypes

    gx, gu = args[3], args[4]
    Bsz, T_, nx, nu = args[1].shape
    lib.riccati_horizon_workspace.restype = ctypes.c_int
    width = lib.riccati_horizon_workspace(nx, nu)
    if width == 0:
        raise ValueError(f"the one-thread kernel is not built for nx={nx}, "
                         f"nu={nu}")
    ws = gx.new_empty(T_ * width * Bsz)
    outs = [torch.empty_like(gx), torch.empty_like(gu), torch.empty_like(gx)]
    bits = "f32" if gx.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"riccati_horizon_{bits}")
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
             ws.data_ptr(), Bsz, T_, nx, nu, float(reg),
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "the other checkout's riccati_horizon")
    return tuple(outs)


def k3_layouts(shapes=K3_WARP_SHAPES, batches=K3_WARP_BATCHES,
               against=None, reg=K4_BUDGET["reg"]) -> list:
    """K3's horizon kernel per (shape, dtype, B): its error (raises above
    tolerance), queued-event ms, the profiler's ms, shared memory and the
    bound; with ``against`` (another checkout's root) its one-thread
    horizon kernel beside it where built (error, both timed in turns) and
    the faster."""
    thread_lib = (cuda_build.load_from(against, "riccati_horizon")
                  if against is not None else None)
    rows = []
    for T_, nx, nu in shapes:
        for dtype in (torch.float32, torch.float64):
            for B in batches:
                args = lqr_problem(B, T_, nx, nu, dtype, seed=B + T_)
                sol = riccati.batched_lqr_kkt_solve(*args, reg)
                plain = (sol.dx, sol.du, sol.lam)
                ref = plain
                if dtype == torch.float32:
                    sol = riccati.batched_lqr_kkt_solve(
                        *(a.double() for a in args), reg)
                    ref = (sol.dx, sol.du, sol.lam)
                limit = max(K3_LAYOUT_TOL[dtype],
                            F32_VS_F64_RATIO * _rel(plain, ref)
                            if dtype == torch.float32 else 0.0)
                row = dict(T=T_, nx=nx, nu=nu, B=B, dtype=str(dtype),
                           limit=limit, ms={})
                fns = {"riccati_horizon_warp": lambda: riccati_cuda._launch(
                    args, reg, "riccati_horizon_warp")}
                if thread_lib is not None and \
                        thread_lib.riccati_horizon_workspace(nx, nu):
                    fns["riccati_horizon"] = lambda: _one_thread_k3(
                        thread_lib, args, reg)
                for name, fn in fns.items():
                    out = fn()
                    row[f"err_{name}"] = _rel(out, ref)
                    if not (all(bool(torch.isfinite(o).all()) for o in out)
                            and row[f"err_{name}"] <= limit):
                        raise RuntimeError(f"K3 ({name}) disagrees with its "
                                           f"plain version: {row}")
                if len(fns) == 2:
                    row["ms"]["riccati_horizon"], \
                        row["ms"]["riccati_horizon_warp"] = _turns(
                            (fns["riccati_horizon"],
                             fns["riccati_horizon_warp"]), 20)
                else:
                    row["ms"]["riccati_horizon_warp"] = queued_events_ms(
                        fns["riccati_horizon_warp"], 20)
                try:  # the profiler has missed K3h on one machine
                    row["ms_profiler_warp"] = device_kernel_ms(
                        fns["riccati_horizon_warp"], 20,
                        "riccati_horizon_warp_kernel")
                except RuntimeError as err:
                    row["ms_profiler_warp"] = str(err)
                row["warp_shared_memory"] = riccati_cuda.warp_smem(
                    dtype, nx, nu, args[0].device)
                row["faster"] = min(row["ms"], key=row["ms"].get)
                row["kernel_for"] = riccati_cuda.kernel_for(T_, nx, nu)
                row["bound_ms"], row["bound_by"] = bound(
                    B * k3_bytes(T_, nx, nu), B * k3_ops(T_, nx, nu))
                print("k3_layouts", json.dumps(row), flush=True)
                rows.append(row)
    return rows


def k4_layouts(shapes=K4_WARP_SHAPES, batches=K4_WARP_BATCHES) -> list:
    """K4 per (shape, dtype, B) on the profiler benchmark's random box QPs,
    cold-started: each built layout within K4W_TOL of the plain version
    on all eight outputs (raises above it), queued-event ms of both in
    turns where both are built, the bound, and the faster layout."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof

    rows = []
    for shape in shapes:
        for dtype in (torch.float32, torch.float64):
            for B in batches:
                arrays, box = prof.problem(B, *shape, dtype)
                args = (*arrays, *prof.cold_start(*arrays), box.u_lo,
                        box.u_hi, K4_BUDGET["max_iter"], K4_BUDGET["reg"],
                        K4_BUDGET["min_slack"])
                ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args)
                row = dict(shape=shape, B=B, dtype=str(dtype),
                           tol=K4W_TOL[dtype], ms={})
                layouts = [lay for lay, built in (
                    ("thread", trajqp_fused_cuda.BUILT),
                    ("warp", trajqp_fused_cuda.WARP_BUILT)) if shape in built]
                fns = {}
                for lay in layouts:
                    fns[lay] = lambda lay=lay: trajqp_fused_cuda._launch(
                        *args, layout=lay)
                    out = fns[lay]()
                    row[f"err_{lay}"] = max(
                        float((g - w).abs().max()) / max(
                            1.0, float(w.abs().max()))
                        for g, w in zip(out, ref))
                    if not (all(bool(torch.isfinite(o).all()) for o in out)
                            and row[f"err_{lay}"] <= K4W_TOL[dtype]):
                        raise RuntimeError(f"K4 ({lay}) disagrees with its "
                                           f"plain version: {row}")
                if len(layouts) == 2:
                    row["ms"]["thread"], row["ms"]["warp"] = _turns(
                        (fns["thread"], fns["warp"]), 10)
                else:
                    row["ms"][layouts[0]] = queued_events_ms(
                        fns[layouts[0]], 10)
                row["faster"] = min(row["ms"], key=row["ms"].get)
                row["layout_for"] = trajqp_fused_cuda.layout_for(*shape)
                row["warp_shared_memory"] = trajqp_fused_cuda.warp_smem(
                    dtype, *shape, args[0].device)
                row["bound_ms"], row["bound_by"] = bound(
                    B * k4_bytes(*shape),
                    B * k4_ops(*shape, K4_BUDGET["max_iter"]))
                print("k4_layouts", json.dumps(row), flush=True)
                rows.append(row)
    return rows


def _other_k3(lib, args, reg):
    """Another checkout's unrolled K3 (``lib``, its ``csrc/riccati.cu``)
    on ``args``: (dx, du, lam)."""
    import ctypes

    gx, gu = args[3], args[4]
    Bsz, T_, nx, nu = args[1].shape
    outs = [torch.empty_like(gx), torch.empty_like(gu), torch.empty_like(gx)]
    bits = "f32" if gx.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"riccati_{bits}")
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
             Bsz, T_, nx, nu, float(reg),
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "the other checkout's riccati")
    return tuple(outs)


def _profiled_turns(fns, B, name):
    """The profiler's device ms per launch of each of ``fns`` (a dict),
    timed in turns: every one in order, then every one in reverse; the mean
    of each one's two readings."""
    order = list(fns) + list(fns)[::-1]
    ms = {k: [] for k in fns}
    for k in order:
        ms[k].append(device_kernel_ms(fns[k], _reps(B), name))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def k3_unrolled(shapes=riccati_cuda.BUILT, batches=K3_UNROLLED_BATCHES,
                against=None, reg=K4_BUDGET["reg"]) -> list:
    """K3's unrolled kernel per (shape, dtype, B), with ``against``
    another checkout's unrolled kernel beside it: errors against the plain
    version (raises above tolerance), bits against the other checkout's,
    the profiler's ms in turns, the bound and its share."""
    other = (cuda_build.load_from(against, "riccati")
             if against is not None else None)
    rows = []
    for T_, nx, nu in shapes:
        for dtype in (torch.float32, torch.float64):
            for B in batches:
                args = lqr_problem(B, T_, nx, nu, dtype, seed=B + nx)
                sol = riccati.batched_lqr_kkt_solve(*args, reg)
                plain = (sol.dx, sol.du, sol.lam)
                ref = plain
                if dtype == torch.float32:
                    sol = riccati.batched_lqr_kkt_solve(
                        *(a.double() for a in args), reg)
                    ref = (sol.dx, sol.du, sol.lam)
                limit = max(K3_LAYOUT_TOL[dtype],
                            F32_VS_F64_RATIO * _rel(plain, ref)
                            if dtype == torch.float32 else 0.0)
                row = dict(T=T_, nx=nx, nu=nu, B=B, dtype=str(dtype),
                           limit=limit)
                fns = {"kernel": lambda: riccati_cuda._launch(args, reg)}
                if other is not None:
                    fns["against"] = lambda: _other_k3(other, args, reg)
                outs = {k: f() for k, f in fns.items()}
                for k, out in outs.items():
                    row[f"err_{k}"] = _rel(out, ref)
                    if not (all(bool(torch.isfinite(o).all()) for o in out)
                            and row[f"err_{k}"] <= limit):
                        raise RuntimeError(f"K3 ({k}) disagrees with its "
                                           f"plain version: {row}")
                if other is not None:
                    row["bit_identical_to_against"] = _same(
                        outs["kernel"], outs["against"])
                row["ms"] = _profiled_turns(fns, B, "riccati_kernel")
                row["faster"] = min(row["ms"], key=row["ms"].get)
                row["bound_ms"], row["bound_by"] = bound(
                    B * k3_bytes(T_, nx, nu), B * k3_ops(T_, nx, nu))
                row["bound_share"] = {k: row["bound_ms"] / m
                                      for k, m in row["ms"].items()}
                row["shared_memory"] = riccati_cuda.staged_smem(
                    dtype, T_, nx, nu, args[0].device)
                print("k3_unrolled", json.dumps(row), flush=True)
                rows.append(row)
                del args, sol, plain, ref, outs
    return rows


def _other_k4(lib, args):
    """Another checkout's K4 thread layout (``lib``, its
    ``csrc/trajqp_fused.cu``) on ``args`` as ``trajqp_fused_cuda._launch``
    takes them: the eight outputs."""
    import ctypes

    C, c, A, Bm, f, x0, xi, ui, lo, hi, max_iter, reg, min_slack = args
    Bsz, Tm1, nx, nu = Bm.shape
    outs = [torch.empty_like(xi), torch.empty_like(ui), torch.empty_like(xi)] \
        + [torch.empty_like(ui) for _ in range(4)] + [x0.new_empty(Bsz)]
    bits = "f32" if C.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"trajqp_fused_{bits}")
    dblu = ctypes.c_double * nu
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_double] * 2 + [ctypes.POINTER(ctypes.c_double)] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a.data_ptr() for a in (C, c, A, Bm, f, x0, xi, ui)),
             *(o.data_ptr() for o in outs), Bsz, Tm1 + 1, nx, nu, max_iter,
             reg, min_slack, dblu(*lo), dblu(*hi),
             torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "the other checkout's trajqp_fused")
    return tuple(outs)


def _k4_errs(got, want):
    """Per output, max |got − want| over max(1, max |want|), in float64."""
    return [float((g.double() - w.double()).abs().max())
            / max(1.0, float(w.double().abs().max()))
            for g, w in zip(got, want)]


def _k4_plain_envelope(args, ref64):
    """Per output, the plain float32 version's error against the float64
    solution ``ref64``: the largest over the QP ``args`` and its four
    one-ulp nudges of c and x0 (its rounding envelope, as chip_smoke.py's
    ``k4_check`` takes it)."""
    errs = _k4_errs(trajqp_fused_cuda.fused_trajqp_solve_reference(*args),
                    ref64)
    for i in (1, 5):  # c, x0
        for to in (float("inf"), -float("inf")):
            nudged = list(args)
            nudged[i] = torch.nextafter(args[i], torch.full_like(args[i],
                                                                 to))
            errs = [max(a, b) for a, b in zip(errs, _k4_errs(
                trajqp_fused_cuda.fused_trajqp_solve_reference(*nudged),
                ref64))]
    return errs


def k4_thread(shapes=trajqp_fused_cuda.BUILT, batches=K4_THREAD_BATCHES,
              against=None) -> list:
    """K4's thread layout per (shape, dtype, B) on the profiler benchmark's
    random box QPs, cold-started, at the ip path's budget: within K4_TOL of
    the plain version on all eight outputs, float32 also against the
    float64 solution within F32_VS_F64_RATIO of the plain float32
    version's error (its one-ulp envelope, ``_k4_plain_envelope``) or
    K4_TOL; with ``against`` another checkout's thread layout beside it
    (the same errors, and the bits compared), both timed in turns by the
    profiler; the bound. Raises where the thread layout misses a limit,
    after every kernel of the row is checked."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof

    other = (cuda_build.load_from(against, "trajqp_fused")
             if against is not None else None)
    budget = (K4_BUDGET["max_iter"], K4_BUDGET["reg"],
              K4_BUDGET["min_slack"])
    rows = []
    for shape in shapes:
        for dtype in (torch.float32, torch.float64):
            for B in batches:
                arrays, box = prof.problem(B, *shape, dtype)
                args = (*arrays, *prof.cold_start(*arrays), box.u_lo,
                        box.u_hi, *budget)
                plain = trajqp_fused_cuda.fused_trajqp_solve_reference(*args)
                ref64 = trajqp_fused_cuda.fused_trajqp_solve_reference(
                    *(a.double() for a in args[:8]), *args[8:])
                row = dict(shape=shape, B=B, dtype=str(dtype),
                           tol=K4_TOL[dtype])
                fns = {"thread": lambda: trajqp_fused_cuda._launch(
                    *args, layout="thread")}
                if other is not None:
                    fns["against"] = lambda: _other_k4(other, args)
                outs = {k: f() for k, f in fns.items()}
                base = bare = None
                if dtype == torch.float32:
                    base = _k4_plain_envelope(args, ref64)
                    bare = _k4_errs(plain, ref64)
                    row["plain_vs_f64"] = max(base)
                    row["plain_vs_f64_bare"] = max(bare)
                for k, out in outs.items():
                    errs = _k4_errs(out, plain)
                    row[f"err_{k}"] = max(errs)
                    ok = all(bool(torch.isfinite(o).all()) for o in out) \
                        and max(errs) <= K4_TOL[dtype]
                    if base is not None:
                        mine = _k4_errs(out, ref64)
                        row[f"vs_f64_{k}"] = max(mine)
                        # the most of the rule's limit any output uses,
                        # the limit taken from the plain version's envelope
                        # (which decides here) and from its bare error
                        for name, b in (("envelope", base), ("bare", bare)):
                            row[f"rule_{name}_{k}"] = max(
                                m / max(K4_TOL[dtype], F32_VS_F64_RATIO * p)
                                for m, p in zip(mine, b))
                        ok = ok and all(
                            m <= max(K4_TOL[dtype], F32_VS_F64_RATIO * b)
                            for m, b in zip(mine, base))
                    row[f"ok_{k}"] = ok
                if not row["ok_thread"]:
                    raise RuntimeError(f"K4 (thread) disagrees with its "
                                       f"plain version: {row}")
                if other is not None:
                    row["bit_identical_to_against"] = _same(
                        outs["thread"], outs["against"])
                row["ms"] = _profiled_turns(fns, B, "trajqp_fused_kernel")
                row["bound_ms"], row["bound_by"] = bound(
                    B * k4_bytes(*shape),
                    B * k4_ops(*shape, K4_BUDGET["max_iter"]))
                row["bound_share"] = {k: row["bound_ms"] / m
                                      for k, m in row["ms"].items()}
                print("k4_thread", json.dumps(row), flush=True)
                rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=Path("build/kernel_layouts.json"))
    ap.add_argument("--only", default="",
                    help="comma-separated measurements to run (default: "
                         "all): " + ", ".join(MEASUREMENTS))
    ap.add_argument("--against", type=Path, default=None,
                    help="k3_layouts, k3_thread_shapes, k3_unrolled, "
                         "k4_thread: another checkout whose kernel (the "
                         "one-thread horizon kernel, the unrolled K3, K4's "
                         "thread layout) joins the turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: these measurements are of the "
                           "card only")
    logs = cuda_build.build(["btsolve", "al_fused", "riccati",
                             "riccati_horizon_warp", "trajqp_fused",
                             "trajqp_fused_warp"])
    result = dict(ptxas={k: [ln.strip() for ln in v.splitlines()
                             if "registers" in ln or "spill" in ln
                             or "entry function" in ln]
                         for k, v in logs.items()},
                  device=torch.cuda.get_device_name(0))
    only = [m for m in args.only.split(",") if m] or list(MEASUREMENTS)
    for name in only:
        result[name] = (MEASUREMENTS[name](against=args.against)
                        if name in _K3_MEASUREMENTS else MEASUREMENTS[name]())
        print(name, json.dumps(result[name]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


MEASUREMENTS = {
    "k2_groups": k2_groups, "k2_tie": k2_tie, "k2_ls_split": k2_ls_split,
    "k1_layouts": k1_layouts, "k1_al_systems": k1_al_systems,
    "k1_onchip_shapes": lambda: [
        row for n, T_ in btsolve_cuda.ONCHIP_SHAPES[torch.float32]
        if (n, T_) != (N, T) for row in k1_layouts((64, 4096), n=n, T_=T_)],
    "k1_warp": lambda: k1_layouts(K1_WARP_BATCHES, n=16, T_=T),
    "k1_compute_rule": k1_compute_rule, "k3_layouts": k3_layouts,
    "k3_thread_shapes": lambda against=None: k3_layouts(
        K3_THREAD_SHAPES, K3_THREAD_BATCHES, against),
    "k4_layouts": k4_layouts, "k3_unrolled": k3_unrolled,
    "k4_thread": k4_thread}
#: the measurements that take ``--against``
_K3_MEASUREMENTS = ("k3_layouts", "k3_thread_shapes", "k3_unrolled",
                    "k4_thread")


if __name__ == "__main__":
    raise SystemExit(main())
