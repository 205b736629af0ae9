"""K2 on the models beyond the pendulum (the integrator, the cartpoles, the
quadrotor and the two CosSin models), on the card.

    python -m diff_qp_mpc_tpu_torch.benchmarks.k2_models \\
        [--out build/k2_models.json]

For every (model, T, dtype) of ``CASES``, at ``BATCHES`` (B 64 and 256; the
quadrotor's 64 and 128, its checkpoint's closed loop and training, and 65,
the edge of its two-element blocks), on seeded tracking problems of the
model's own env (``problem``):
  - the kernel against its plain version (``al_fused_cuda.
    fused_al_solve_reference``) at the main path's budget (``budget``):
    each element's largest error on xu against ``TOL`` and the share of
    elements outside it against ``SHARE_LIMIT`` (none in float64; see
    there); in float64 the elements beyond 1e-6 listed with the plain
    version's own change on them under one ulp of the inputs; on the
    quadrotor in float32, the share of elements more than TOL from the
    plain version's float64 result against ``F32_SHARE_VS_F64``;
  - on the "group" layout, the outputs at every group width G
    bit-identical to G 1 (the "warp" layout of the quadrotor and the
    cartpoles has one width);
  - in float32 at B 64: device ms per launch, the plain version's ms, and
    the bound from ``flops.k2_ops_with_sin`` for the model.
A failed check raises. Without a card it raises. ``chip_smoke.py`` runs
the same checks. ``--plain`` prints, on the CPU, the plain version's own
float32-vs-float64 and one-ulp spreads over seeds, from which ``TOL`` and
``SHARE_LIMIT`` are set.

``--layouts`` instead times every (model, T, dtype) of the warp layout,
the kernel at its table's warps per element, at ``LAYOUT_BATCHES``
(``layouts``): queued-event ms per launch, within ``TOL`` of the plain
version (float32 by the share limit). ``--against DIR`` adds the kernel
of another checkout's sources (``DIR/diff_qp_mpc_tpu_torch/csrc``, built
with the same flags; its entry called with one warp per element) in turns
(table, against, against, table; the mean of each one's two readings),
with its bits beside the table kernel's.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks.flops import (
    SINF_FP32_INSTR,
    bound,
    k2_bytes,
    k2_ops_with_sin,
)
from diff_qp_mpc_tpu_torch.benchmarks.timing import (
    device_kernel_ms,
    events_ms,
    queued_events_ms,
)
from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.models import CartpoleCosSin, PendulumCosSin
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda
from diff_qp_mpc_tpu_torch.utils import cuda_build

#: K2's budget on the main paths (ALConfig defaults at qp_iter 2)
BUDGET = dict(al_iter=2, n_newton=4, n_ls=20, rho_factor=10.0, rho_max=1e6,
              reg=1e-7)
#: per model: the env (name, kwargs) whose model, initial states and box the
#: problems take, and the tracking cost's control weight R (None: the env's
#: Rlqr), as the committed checkpoints of these envs use them; the CosSin
#: models have no env (None): see ``problem``
ENVS = {"integrator": ("integrator", {}, None),
        "cartpole1l": ("cartpole1link", {"stabilization": True}, None),
        "cartpole2l": ("cartpole2link", {"stabilization": True}, 0.01),
        "quadrotor": ("rexquadrotor", {}, None),
        "pendulum_cossin": (None, {}, None),
        "cartpole_cossin": (None, {}, None)}
#: the budget per model where it is not BUDGET's: the quadrotor checkpoint's
#: rho_max (deqmpc_quadrotor_fused_v8's meta.json: 1e4, al_reg null)
BUDGETS = {"quadrotor": dict(BUDGET, rho_max=1e4)}
#: every (model, T, dtype) K2 is built for beyond the pendulum
CASES = tuple((b.name, T, dtype)
              for b in al_fused_cuda.BUILT.values() if b.name in ENVS
              for dtype, horizons in b.horizons.items() for T in horizons)
BATCHES = (64, 256)
#: the batches per model where they are not BATCHES
MODEL_BATCHES = {"quadrotor": (64, 128, 65)}
#: the batches timed per model (float32), where not B 64 alone: the
#: quadrotor checkpoint's closed loop (64) and training (128)
TIMED_BATCHES = {"quadrotor": (64, 128)}
#: each element's largest error on xu. The solve is discontinuous in its
#: inputs (the line search's first minimum among near-tied candidates, the
#: box switching), so two correct implementations that round differently
#: part by more than rounding. Float32: against its own float64 result the
#: plain version moves no element of any case by 1e-2 (the largest 8.9e-3,
#: cp1 T 10), so each element is held to 1e-2 but for at most SHARE_LIMIT
#: of them. Float64: one ulp of an input (PERTURBATIONS) moves an element of
#: the plain version by up to 1.48e-6 (the integrator; cp1 8.7e-7, cp2
#: 2.3e-7), and 1e-6 on up to 1.6% of a batch's elements, over 9 seeds at B
#: 64 and 256 (``plain_spread``, PERF.md PR 7); so every element is held to
#: twice that largest reading, 3e-6
TOL = {torch.float32: 1e-2, torch.float64: 3e-6}
#: the share of elements outside TOL, and the median element error: a
#: tenth of TOL in float32, 1e-8 in float64
SHARE_LIMIT = {torch.float32: 0.01, torch.float64: 0.0}
#: the share limit per model where it is not SHARE_LIMIT's. The CosSin
#: models' float32 solves jump more often: against its own float64 result
#: the plain float32 version moves up to 1/64 of the pendulum's elements
#: and 2/64 of the cartpole's beyond 1e-2 (the largest share over 9 seeds
#: at B 64 and 256, T 5 and 10, ``--plain``; PERF.md, Findings). Two float32
#: implementations may each jump on as many elements, and on different
#: ones, so each is held to twice that share against the other.
SHARE_LIMITS = {"pendulum_cossin": {torch.float32: 2 / 64,
                                    torch.float64: 0.0},
                "cartpole_cossin": {torch.float32: 4 / 64,
                                    torch.float64: 0.0}}
MEDIAN_LIMIT = {torch.float32: 1e-3, torch.float64: 1e-8}
#: the float64 tolerance the checks report against; elements beyond it
#: are listed with the plain version's own one-ulp change on them
REPORT_TOL_F64 = 1e-6
#: the quadrotor's float32 rule: the share of elements more than
#: TOL[float32] from the plain version's float64 result, at most the plain
#: float32 version's own largest share over seeds (``--plain``, 9 seeds at
#: each of B 64, 128 and 65: no element beyond 1e-2, the largest 2.8e-3;
#: PERF.md, the quadrotor's findings)
F32_SHARE_VS_F64 = {"quadrotor": 0.0}
#: one-ulp perturbations of a problem's inputs, (argument, direction)
PERTURBATIONS = (("x0", 1), ("x0", -1), ("c", 1), ("c", -1), ("Cd", 1),
                 ("Cd", -1), ("x_init", 1), ("x_init", -1))
_ARG = {"Cd": 1, "c": 2, "x0": 3, "x_init": 6}


def budget(name):
    """The solver budget of ``name``'s main path."""
    return BUDGETS.get(name, BUDGET)


def batches(name):
    return MODEL_BATCHES.get(name, BATCHES)


def share_limit(name, dtype):
    """The share of ``name``'s elements that may lie outside TOL."""
    return SHARE_LIMITS.get(name, SHARE_LIMIT)[dtype]


def problem(name, B, T, dtype, seed, device="cuda"):
    """Tracking problems like the policy's for model ``name``: x0 drawn as
    its env draws initial states (the cartpoles around upright, the
    integrator over its whole range, the quadrotor's random pose) from a
    generator seeded by ``seed``; Cd = (Q, R), c = −Cd·τ_ref, the env's
    box. τ_ref drifts from x0 with u 0, and x_init is τ_ref's states and
    u_init 0; a model with a hover thrust (the quadrotor) takes the hover
    reference instead, the origin at hover thrust, with u_init the hover
    thrust and x_init its rollout from x0 (as the JAX package's
    tests/test_al_fused.py builds them). A model without an env (the CosSin
    ones, ``cossin_problem``) takes its own draw. Returns the
    fused_al_solve arguments (model, Cd, c, x0, u_lo, u_hi, x_init,
    u_init)."""
    env_name, kwargs, r = ENVS[name]
    if env_name is None:
        return cossin_problem(name, B, T, dtype, seed, device)
    env = make_env(env_name, **kwargs)
    model, nx, nu = env.model, env.nx, env.nu
    x0 = env._sample_init(torch.Generator().manual_seed(seed), B).numpy()
    R = np.asarray(env.Rlqr, float) if r is None else np.full(nu, r)
    Cd = np.broadcast_to(np.concatenate([env.Qlqr, R]), (B, T, nx + nu))
    if hasattr(model, "hover_thrust"):
        u_ref = np.tile(model.hover_thrust().numpy(), (B, T, 1))
        x_ref = np.zeros((B, T, nx))
        u_init = u_ref
        x_init = model.rollout(torch.as_tensor(x0),
                               torch.as_tensor(u_init)).numpy()
    else:
        rng = np.random.RandomState(seed)
        x_ref = x0[:, None] + np.cumsum(0.05 * rng.randn(B, T, nx), axis=1)
        x_ref[:, 0] = x0
        u_ref = u_init = np.zeros((B, T, nu))
        x_init = x_ref
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    to = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)
    box = (tuple(float(v) for v in env.action_space.low),
           tuple(float(v) for v in env.action_space.high))
    return (model, to(Cd), to(c), to(x0), *box, to(x_init), to(u_init))


def model(name):
    """The model ``name`` names (its env's, or the CosSin model's
    defaults)."""
    env_name, kwargs, _ = ENVS[name]
    if env_name is None:
        return _COSSIN[name]()
    return make_env(env_name, **kwargs).model


_COSSIN = {"pendulum_cossin": PendulumCosSin,
           "cartpole_cossin": CartpoleCosSin}
#: the CosSin problems' box, state and control weights
COSSIN_BOX, COSSIN_Q, COSSIN_R = 3.0, 10.0, 0.01


def cossin_problem(name, B, T, dtype, seed, device="cuda"):
    """``problem`` for a CosSin model (no env): θ and every other state
    coordinate drawn uniformly in ±0.5 around upright at rest (cos θ 1,
    sin θ 0), Cd = (COSSIN_Q on the states, COSSIN_R on u), the box
    ±COSSIN_BOX; τ_ref drifts from x0 as ``problem``'s, u_init 0."""
    m = _COSSIN[name]()
    nx, nu = m.nx, m.nu
    rng = np.random.RandomState(seed)
    x0 = rng.uniform(-0.5, 0.5, (B, nx))
    i = nx - 3  # (cos θ, sin θ) sit before θ̇, the last coordinate
    th = x0[:, i]
    x0[:, i], x0[:, i + 1] = np.cos(th), np.sin(th)
    Cd = np.broadcast_to([COSSIN_Q] * nx + [COSSIN_R] * nu,
                         (B, T, nx + nu))
    x_ref = x0[:, None] + np.cumsum(0.05 * rng.randn(B, T, nx), axis=1)
    x_ref[:, 0] = x0
    c = -Cd * np.concatenate([x_ref, np.zeros((B, T, nu))], -1)
    to = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)
    return (m, to(Cd), to(c), to(x0), (-COSSIN_BOX,) * nu,
            (COSSIN_BOX,) * nu, to(x_ref), to(np.zeros((B, T, nu))))


def element_errors(out, ref):
    """Each element's largest |Δxu|."""
    B = out[0].shape[0]
    return (out[0] - ref[0]).abs().reshape(B, -1).max(dim=1).values


def sensitivity(args, budget):
    """The plain version on ``args`` (``problem``'s tuple) and each
    element's largest |Δxu| of it under the one-ulp PERTURBATIONS."""
    ref = al_fused_cuda.fused_al_solve_reference(*args, **budget)
    sens = torch.zeros_like(ref[4])
    for name, sign in PERTURBATIONS:
        nudged = list(args)
        a = nudged[_ARG[name]]
        nudged[_ARG[name]] = torch.nextafter(
            a, torch.full_like(a, sign * float("inf")))
        sens = torch.maximum(sens, element_errors(
            al_fused_cuda.fused_al_solve_reference(*nudged, **budget), ref))
    return ref, sens


def _same(a, b) -> bool:
    """Bit-identical tuples of tensors (NaNs in the same places count)."""
    return all(x.shape == y.shape and torch.equal(
        x.view(torch.int64 if x.dtype == torch.float64 else torch.int32),
        y.view(torch.int64 if y.dtype == torch.float64 else torch.int32))
        for x, y in zip(a, b))


def check(name, T, dtype, B) -> dict:
    """The kernel against its plain version and, on the "group" layout,
    every G against G 1 on ``problem(name, B, T, dtype, seed=B)``; raises
    on a failed check."""
    bud = budget(name)
    args = problem(name, B, T, dtype, seed=B)
    warp = al_fused_cuda.built_for(args[0]).layout == "warp"
    groups = (32,) if warp else al_fused_cuda.GROUPS
    outs = {G: al_fused_cuda.fused_al_solve(*args, **bud, group=G)
            for G in groups}
    out = outs[groups[0]]
    ref = al_fused_cuda.fused_al_solve_reference(*args, **bud)
    torch.cuda.synchronize()
    el = element_errors(out, ref)
    tol = TOL[dtype]
    row = dict(model=name, T=T, dtype=str(dtype), B=B,
               layout="warp" if warp else "group",
               max_abs_err_xu=float(el.max()),
               median_abs_err_xu=float(el.median()),
               share_over_tol=float((el > tol).double().mean()),
               max_abs_err_res=float((out[4] - ref[4]).abs().max()),
               res_mean=float(out[4].mean()), tol=tol,
               share_limit=share_limit(name, dtype),
               identical_to_g1={G: _same(o, outs[1])
                                for G, o in outs.items() if not warp})
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    ok = (finite and row["median_abs_err_xu"] <= MEDIAN_LIMIT[dtype]
          and all(row["identical_to_g1"].values()))
    if dtype == torch.float32 and name in F32_SHARE_VS_F64:
        # against the plain version's float64 result on the same problem
        ref64 = al_fused_cuda.fused_al_solve_reference(
            *(a.double() if torch.is_tensor(a) else a for a in args), **bud)
        vs64 = element_errors([o.double() for o in out], ref64)
        row.update(share_over_tol_vs_f64=float(
            (vs64 > tol).double().mean()),
            max_abs_err_xu_vs_f64=float(vs64.max()),
            share_limit_vs_f64=F32_SHARE_VS_F64[name])
        ok = ok and row["share_over_tol_vs_f64"] <= F32_SHARE_VS_F64[name]
    else:
        ok = ok and row["share_over_tol"] <= share_limit(name, dtype)
    if not ok:
        raise RuntimeError(f"K2 on {name}: {row}")
    if dtype == torch.float64:
        # the elements beyond 1e-6, each beside the plain version's own
        # largest change on it under one ulp of the inputs
        beyond = (el > REPORT_TOL_F64).nonzero().flatten()
        if len(beyond):
            sens = sensitivity(args, bud)[1]
            row["beyond_1e-6"] = [dict(element=int(i), err=float(el[i]),
                                       plain_one_ulp=float(sens[i]))
                                  for i in beyond]
    return row


def timing(name, T, B=64) -> dict:
    """Float32 device ms per launch (on the "group" layout at the G the
    rule picks), the plain version's ms and the bound, on
    ``problem(name, B, T, float32)``."""
    bud = budget(name)
    args = problem(name, B, T, torch.float32, seed=B)
    model = args[0]
    kern = lambda: al_fused_cuda.fused_al_solve(*args, **bud)
    n_budget = {k: bud[k] for k in ("al_iter", "n_newton", "n_ls")}
    bound_ms, bound_by = bound(
        B * k2_bytes(T, model.nx, model.nu),
        B * k2_ops_with_sin(T, model.nx, model.nu, **n_budget,
                            sin_fp32_instr=SINF_FP32_INSTR, model=name))
    built = al_fused_cuda.built_for(model)
    if built.layout == "warp":
        layout = dict(group=32, kernel="al_warp_kernel",
                      warps=built.warps,
                      shared_memory=al_fused_cuda.warp_smem(
                          torch.float32, T, args[1].device, model))
    else:
        resident = al_fused_cuda.resident_threads(torch.float32, T,
                                                  args[1].device, model)
        layout = dict(group=al_fused_cuda.choose_group(B, resident),
                      kernel="al_fused_kernel", resident_threads=resident)
    return dict(model=name, T=T, B=B, **layout,
                ms=device_kernel_ms(kern, 10, layout["kernel"]),
                ms_events=events_ms(kern, 10),
                plain_ms=events_ms(lambda: al_fused_cuda.
                                   fused_al_solve_reference(*args, **bud),
                                   2, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by)


#: the batches ``layouts`` times: the paths' 64, 128 (the quadrotor's
#: training) and 256, and 512 to 4096, beyond any path's default
LAYOUT_BATCHES = (64, 128, 256, 512, 1024, 2048, 4096)
#: every (model, T, dtype) on the warp layout
WARP_CASES = tuple(c for c in CASES if al_fused_cuda.built_for(
    model(c[0])).layout == "warp")


def layouts(batches=LAYOUT_BATCHES, against=None, reps=10,
            log=print) -> list:
    """The warp layout's kernel per (model, T, dtype, B), and another
    checkout's beside it in turns (see the module docstring); raises where
    the table kernel disagrees with the plain version."""
    libs = {}
    rows = []
    for name, T, dtype in WARP_CASES:
        for B in batches:
            bud = budget(name)
            args = problem(name, B, T, dtype, seed=B)
            mdl, Cd = args[0], args[1]
            built = al_fused_cuda.built_for(mdl)
            lam = al_fused_cuda._fill_warm_start(B, T, mdl.nx, mdl.nu, Cd,
                                                 None, None, None, None)
            full = (*args, *(bud[k] for k in (
                "al_iter", "n_newton", "n_ls", "rho_factor", "rho_max",
                "reg")), *lam)
            table = f"W{built.warps}"
            fns = {table: lambda: al_fused_cuda._launch(*full)}
            if against is not None:
                if built.library not in libs:
                    libs[built.library] = cuda_build.load_from(
                        against, built.library)
                outs = [torch.empty_like(a) for a in (Cd, *lam)]
                stream = torch.cuda.current_stream().cuda_stream

                def old(lib=libs[built.library], outs=outs):
                    err = al_fused_cuda.call_entry(
                        getattr(lib, built.symbol(dtype)),
                        (Cd, args[2], args[3], args[6], args[7], *lam,
                         *outs), B, 5, T, bud["al_iter"], bud["n_newton"],
                        bud["n_ls"], bud["rho_factor"], bud["rho_max"],
                        bud["reg"], built.params(mdl), args[4], args[5],
                        stream)
                    cuda_build.check(lib, err, "K2 of the other checkout")
                    return tuple(outs)

                fns["against"] = old
            got = {k: tuple(o.clone() for o in f()) for k, f in fns.items()}
            ref = al_fused_cuda.fused_al_solve_reference(*args, **bud)
            torch.cuda.synchronize()
            el = element_errors(got[table], ref)
            row = dict(model=name, T=T, dtype=str(dtype), B=B,
                       warps=built.warps,
                       max_abs_err_xu=float(el.max()),
                       share_over_tol=float((el > TOL[dtype]).double()
                                            .mean()),
                       shared_memory=al_fused_cuda.warp_smem(
                           dtype, T, Cd.device, mdl))
            if against is not None:
                row["against_identical"] = _same(got["against"], got[table])
            order = list(fns) + list(reversed(fns))
            ms = {k: 0.0 for k in fns}
            for k in order:
                ms[k] += queued_events_ms(fns[k], reps) / 2
            row["ms"] = ms
            row["faster"] = min(ms, key=ms.get)
            ok = (all(bool(torch.isfinite(o).all()) for o in got[table])
                  and row["share_over_tol"] <= share_limit(name, dtype))
            log("K2 layouts", json.dumps(row))
            if not ok:
                raise RuntimeError(f"K2 layouts on {name}: {row}")
            rows.append(row)
    return rows


def plain_spread(name, T, B, seed, device="cpu") -> dict:
    """The plain version's own spread on ``problem(name, B, T, ·, seed)``:
    float32 against float64 (each element's largest |Δxu|: the share
    outside TOL[float32], max, median), and in float64 the largest change
    under one ulp of an input (``sensitivity``; max, and the share of
    elements it moves by more than REPORT_TOL_F64)."""
    bud = budget(name)
    a64 = problem(name, B, T, torch.float64, seed, device)
    a32 = problem(name, B, T, torch.float32, seed, device)
    p64, ulp = sensitivity(a64, bud)
    el32 = element_errors([o.double() for o in al_fused_cuda.
                           fused_al_solve_reference(*a32, **bud)], p64)
    return dict(model=name, T=T, B=B, seed=seed,
                f32_share_over_tol=float(
                    (el32 > TOL[torch.float32]).double().mean()),
                f32_max=float(el32.max()), f32_median=float(el32.median()),
                f64_one_ulp_max=float(ulp.max()),
                f64_one_ulp_share_over_1e6=float(
                    (ulp > REPORT_TOL_F64).double().mean()))


def run(log=print) -> dict:
    """Every check and timing of the module docstring; rows by (model, T,
    dtype)."""
    rows = {}
    for name, T, dtype in CASES:
        key = f"{name} T{T} {str(dtype)[6:]}"
        rows[key] = [check(name, T, dtype, B) for B in batches(name)]
        if dtype == torch.float32:
            rows[key] += [timing(name, T, B)
                          for B in TIMED_BATCHES.get(name, (64,))]
        for r in rows[key]:
            log("K2 model", json.dumps(r))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build/k2_models.json"))
    ap.add_argument("--plain", action="store_true",
                    help="only the plain version's spread (plain_spread), "
                         "on the CPU")
    ap.add_argument("--seeds", type=int, default=8,
                    help="--plain: seeds 0 .. SEEDS-1 beside the card "
                         "checks' seed B")
    ap.add_argument("--layouts", action="store_true",
                    help="only the warp layout's kernel at LAYOUT_BATCHES "
                         "(layouts)")
    ap.add_argument("--against", type=Path, default=None,
                    help="--layouts: another checkout whose kernel joins "
                         "the turns")
    args = ap.parse_args(argv)
    if args.plain:
        for name, T in sorted({(n, t) for n, t, _ in CASES}):
            for B in batches(name):
                for seed in (B, *range(args.seeds)):
                    print(json.dumps(plain_spread(name, T, B, seed)),
                          flush=True)
        return 0
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: these checks are of the card")
    cuda_build.build(sorted({al_fused_cuda.built_for(model(n)).library
                             for n, _, _ in WARP_CASES}) if args.layouts
                     else al_fused_cuda.LIBRARIES)
    if args.layouts:
        result = dict(card=torch.cuda.get_device_name(0),
                      layouts=layouts(against=args.against))
    else:
        result = run()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
