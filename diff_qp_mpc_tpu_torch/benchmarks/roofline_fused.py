"""Roofline of the fused AL-MPC kernel K2 on the card (port of
benchmarks/roofline_fused.py).

1. Shared protocol: every time is the median of pipelined windows
   (``benchmarks.timing.steady_state``), spread and load recorded.
2. Validity-checked decomposition: the time across the (n_newton, n_ls)
   budget grid must grow with each knob, else ``decomposition_valid`` is
   false and the fractions are left out (``decompose``, a pure function of
   the measured times).
3. Ceilings: K2's operations per solve over the float32 peak, its HBM
   bytes over the HBM rate, and a transcendental bound from kernel K5
   (``ops.sin_chain_cuda``), a saturated sin microbenchmark whose rate is
   the slope between two chain lengths, so constant costs cancel.
4. Unphysical shares (outside [0, 1.1]) raise instead of being written.

    python -m diff_qp_mpc_tpu_torch.benchmarks.roofline_fused [--bsz 262144]
        [--quick] [--out build/roofline_fused.json]

It measures the card and has no CPU mode: without a CUDA device it raises.

Deviations from the JAX script:
- the output goes to ``--out`` (default build/roofline_fused.json, which
  git ignores), never to benchmarks/roofline_fused.json, the JAX artifact;
- no ls_unroll head-to-head: that is a code-generation switch of the
  Pallas kernel with no counterpart in the CUDA K2;
- no analytic fallback: a non-positive K5 slope raises. With a
  synchronize per window, a chain 4× longer that takes no longer means the
  measurement is broken;
- the sin count follows what the CUDA K2 executes, an analytic Jacobian
  (one sin per step, one cos per Jacobian; ``flops.k2_sin_evals``), not
  nx+nu jvp passes; the JAX formula's count is reported beside it;
- the float32 share is ``sol_frac_fp32`` (the JAX ``sol_frac_vpu``), from
  the count of the CUDA source (``flops.k2_ops``), the JAX algorithmic
  count (``flops.fused_al_flops``) reported beside it; K5's rate is also
  given per element and as a share of its FP32-instruction bound, and K2's
  bound at this batch with each sin counted as its FP32 instructions;
- the JSON records the card's name and power limit (nvidia-smi); shares
  are not rounded.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.benchmarks import flops
from diff_qp_mpc_tpu_torch.benchmarks.timing import steady_state
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, sin_chain_cuda
from diff_qp_mpc_tpu_torch.utils.device import (
    card_name_and_power_limit,
    resolve_device,
)

T, NX, NU = 5, 2, 1
N = NX + NU
#: the reference budget
BASE = dict(al_iter=2, n_newton=4, n_ls=20)
#: the kernel's own rho_max and reg, as the JAX script passes them
KERNEL_KW = dict(rho_max=1e4, reg=1e-5)
#: the budget grid of the decomposition: (n_newton, n_ls) besides BASE's
GRID = {"t_ls5": (4, 5), "t_ls10": (4, 10), "t_nw2": (2, 20)}
#: K5's grid: tiles of 8×128 elements, independent streams per element, and
#: the two chain lengths whose slope gives the rate
SIN_TILES, SIN_STREAMS, SIN_CHAINS = 4096, 8, (4096, 16384)
TILE = 8 * 128
OUT = Path(__file__).resolve().parents[2] / "build" / "roofline_fused.json"


def _problem(bsz, device="cuda"):
    """(model, Cd, c, x0, x_init, u_init), float32: x0 drawn with numpy
    seed 0 as the JAX script draws it, Cd (10, 0.1, 0.001), c and u_init
    zero, x_init the pendulum's rollout of u_init."""
    rng = np.random.RandomState(0)
    model = Pendulum()
    x0 = torch.tensor(np.concatenate(
        [rng.uniform(-0.25, 0.25, (bsz, 1)), rng.uniform(-0.5, 0.5, (bsz, 1))],
        axis=1), dtype=torch.float32, device=device)
    Cd = torch.tensor([10.0, 0.1, 0.001], dtype=torch.float32,
                      device=device).expand(bsz, T, N).contiguous()
    c = torch.zeros(bsz, T, N, dtype=torch.float32, device=device)
    u_init = torch.zeros(bsz, T, NU, dtype=torch.float32, device=device)
    x_init = model.rollout(x0, u_init)
    return model, Cd, c, x0, x_init, u_init


def time_solve(model, Cd, c, x0, x_init, u_init, n_rep=10, n_outer=5, **kw):
    """Steady-state per-solve seconds of K2 at the budget ``kw``, with
    KERNEL_KW's rho_max and reg."""

    def run():
        return al_fused_cuda.fused_al_solve(
            model, Cd, c, x0, (-3.0,), (3.0,), x_init, u_init, **KERNEL_KW,
            **kw)[0]

    run()
    return steady_state(run, n_rep=n_rep, n_outer=n_outer)


def sin_input(n_tiles=SIN_TILES, n_streams=SIN_STREAMS, device="cuda"):
    """K5's input [n_tiles, n_streams, 8, 128], float32, in [0.1, 0.9]: the
    same n_streams tiles, evenly spaced, in every grid step."""
    x = torch.linspace(0.1, 0.9, n_streams * TILE, dtype=torch.float32,
                       device=device).reshape(n_streams, 8, 128)
    return x.expand(n_tiles, n_streams, 8, 128).contiguous()


def transcendental_rate(n_tiles=SIN_TILES, n_streams=SIN_STREAMS, n_rep=10,
                        n_outer=5):
    """Saturated sin throughput of K5 on the card.

    A grid of n_tiles (8,128) tiles, each element with n_streams
    independent chains; the rate is the slope between two chain lengths,
    each timed with the shared protocol. Returns the rate in (8,128)-tile
    sins/s (the JAX unit) and in element sins/s, with both windows' times
    and spreads. A non-positive slope raises."""
    x = sin_input(n_tiles, n_streams)
    st = {}
    for n_ops in SIN_CHAINS:
        run = lambda n_ops=n_ops: sin_chain_cuda.sin_chain(x, n_ops)
        run()
        st[n_ops] = steady_state(run, n_rep=n_rep, n_outer=n_outer)
    lo, hi = SIN_CHAINS
    dt = st[hi]["per_call_s_median"] - st[lo]["per_call_s_median"]
    if not dt > 0:
        raise RuntimeError(
            f"K5: the chain of {hi} sins took no longer than the chain of "
            f"{lo} ({st[hi]['per_call_s_median']} s vs "
            f"{st[lo]['per_call_s_median']} s): the measurement is broken")
    tile_rate = n_tiles * n_streams * (hi - lo) / dt
    return {"sin_tile_rate": tile_rate, "sin_element_rate": tile_rate * TILE,
            "n_tiles": n_tiles, "n_streams": n_streams,
            "chains": list(SIN_CHAINS),
            "t_lo_s": st[lo]["per_call_s_median"],
            "t_hi_s": st[hi]["per_call_s_median"],
            "spread_max_over_min": max(s["spread_max_over_min"]
                                       for s in st.values())}


def sin_evals_per_solve(al_iter, n_newton, n_ls):
    """sin and cos evaluations per element per solve that the CUDA K2
    executes (csrc/al_fused.cu)."""
    return flops.k2_sin_evals(T, al_iter, n_newton, n_ls)


def sin_evals_per_solve_jax_formula(al_iter, n_newton, n_ls):
    """The JAX script's count: per Newton step (T−1)·(1 + (nx+nu)·2) step
    evaluations for the residual and the jvp Jacobian (sin and cos each),
    n_ls·(T−1) in the line search; one merit per AL iteration and one
    residual per λ update."""
    per_newton = (T - 1) * (1 + (NX + NU) * 2) + n_ls * (T - 1)
    return al_iter * (n_newton * per_newton + 2 * (T - 1))


def check_frac(name, v, tol=1.10):
    """A share of a bound must be physical: in [0, tol] (10% measurement
    headroom). Anything else means the bound model or the measurement is
    broken: raise."""
    if not 0.0 <= v <= tol:
        raise RuntimeError(
            f"UNPHYSICAL: {name} = {v} outside [0, {tol}]: the bound model "
            "or the measurement is broken; refusing to write the artifact")
    return v


def decompose(t_ref, t_ls5, t_ls10, t_nw2, n_newton=4, n_ls=20):
    """Line-search and Newton shares of the reference time ``t_ref`` from
    the budget grid (n_ls 5 and 10, n_newton 2), by affine fits. Valid
    only if the time grows with each knob and both slopes are positive;
    otherwise the fractions are left out."""
    out = {"decomposition_valid": False}
    if not (t_ls5 <= t_ls10 <= t_ref and t_nw2 <= t_ref):
        return out
    # the least-squares slope over the three n_ls points (equal times give
    # exactly 0)
    ls = np.array([5.0, 10.0, n_ls]) - (15.0 + n_ls) / 3
    ts = np.array([t_ls5, t_ls10, t_ref])
    ls_slope = float((ls * (ts - ts.mean())).sum() / (ls * ls).sum())
    nw_slope = (t_ref - t_nw2) / (n_newton - 2)
    if ls_slope <= 0 or nw_slope < 0:
        return out
    ls_frac = ls_slope * n_ls / t_ref
    out["decomposition_valid"] = True
    out["ls_fraction_of_total"] = check_frac("ls_fraction_of_total", ls_frac)
    out["newton_nonls_fraction"] = check_frac(
        "newton_nonls_fraction", max(nw_slope * n_newton / t_ref - ls_frac,
                                     0.0))
    return out


def roofline(bsz=262144, quick=False, n_rep=10, n_outer=5):
    """The roofline record of K2 at batch ``bsz`` (see the module
    docstring); ``quick`` leaves out the budget grid."""
    prob = _problem(bsz)
    out = {"bsz": bsz, "budget": BASE, **KERNEL_KW,
           "device": {"name": torch.cuda.get_device_name(0),
                      "count": torch.cuda.device_count(),
                      "nvidia_smi": card_name_and_power_limit()},
           "protocol": f"median of {n_outer} pipelined {n_rep}-call windows "
                       "(diff_qp_mpc_tpu_torch/benchmarks/timing.py)"}
    st = time_solve(*prob, n_rep=n_rep, n_outer=n_outer, **BASE)
    t = st["per_call_s_median"]
    out.update(ms_per_batch=t * 1e3, solves_per_s=bsz / t,
               timing_spread_max_over_min=st["spread_max_over_min"],
               loadavg1=st["loadavg1"])
    if not quick:
        ts = {k: time_solve(*prob, n_rep=n_rep, n_outer=n_outer,
                            al_iter=BASE["al_iter"], n_newton=nw, n_ls=ls)[
                                "per_call_s_median"]
              for k, (nw, ls) in GRID.items()}
        out.update({f"{k}_ms": v * 1e3 for k, v in ts.items()})
        out.update(decompose(t, **ts))

    # ceilings: float32 operations and HBM bytes
    ops = flops.k2_ops(T, NX, NU, **BASE)
    nbytes = flops.k2_bytes(T, NX, NU)
    out.update(kernel_flops_per_solve=ops,
               kernel_flops_per_solve_jax_formula=flops.fused_al_flops(
                   T=T, nx=NX, nu=NU, **BASE),
               hbm_bytes_per_solve=nbytes)
    out["sol_frac_fp32"] = check_frac(
        "sol_frac_fp32", bsz / t * ops / flops.FP32_OPS_PER_S)
    out["sol_frac_hbm"] = check_frac(
        "sol_frac_hbm", bsz / t * nbytes / flops.HBM_BYTES_PER_S)

    # the transcendental bound: K5's saturated rate
    rate = transcendental_rate(n_rep=n_rep, n_outer=n_outer)
    out["sinf_fp32_instructions"] = flops.SINF_FP32_INSTR
    out["sin_microbenchmark"] = rate
    out["sin_rate_share_of_fp32_bound"] = check_frac(
        "sin_rate_share_of_fp32_bound",
        rate["sin_element_rate"] * flops.SINF_FP32_INSTR
        / flops.FP32_INSTR_PER_S)
    sins = sin_evals_per_solve(**BASE)
    out["transcendental_evals_per_solve"] = sins
    out["transcendental_evals_per_solve_jax_formula"] = \
        sin_evals_per_solve_jax_formula(**BASE)
    needed = bsz / t * sins / TILE
    out["sin_tile_rate_saturated"] = rate["sin_tile_rate"]
    out["sin_tile_rate_needed"] = needed
    out["sol_frac_transcendental"] = check_frac(
        "sol_frac_transcendental", needed / rate["sin_tile_rate"])
    shares = {"fp32": out["sol_frac_fp32"], "hbm": out["sol_frac_hbm"],
              "transcendental": out["sol_frac_transcendental"]}
    out["binding_bound"] = max(shares, key=shares.get)
    out["binding_sol_frac"] = shares[out["binding_bound"]]

    # K2's bound at this batch with each sin as its FP32 instructions
    ms, by = flops.bound(bsz * nbytes, bsz * flops.k2_ops_with_sin(
        T, NX, NU, **BASE, sin_fp32_instr=flops.SINF_FP32_INSTR))
    out.update(bound_ms_per_batch=ms, bound_by=by,
               sol_frac_bound=check_frac("sol_frac_bound", ms / (t * 1e3)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bsz", type=int, default=262144)
    ap.add_argument("--quick", action="store_true",
                    help="leave out the budget grid")
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args(argv)
    resolve_device()
    out = roofline(args.bsz, quick=args.quick)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
