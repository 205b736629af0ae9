"""The port's measurement entry points (diff_qp_mpc_tpu_torch.benchmarks)
on the CPU: the counts of flops.py against the repo-root benchmarks/flops.py
and against PERF.md's bounds, the roofline's problem, sin counts, share
checks and decomposition gate against benchmarks/roofline_fused.py, the
sin's FP32 instruction count against its SASS, and the card-only parts
refusing to run without a card."""
import pathlib
import re

import numpy as np
import pytest
import torch

# Importing the JAX script points JAX's persistent compilation cache at
# .jax_cache/ in the repo root, which .gitignore lists.
from benchmarks import flops as jax_flops
from benchmarks import roofline_fused as jax_roofline
from diff_qp_mpc_tpu_torch.benchmarks import flops
from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
from diff_qp_mpc_tpu_torch.benchmarks import roofline_fused, timing
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

# (T, nx, nu, al_iter, n_newton, n_ls)
GRID = [(5, 2, 1, 2, 4, 20), (10, 4, 2, 3, 2, 8), (3, 12, 4, 1, 1, 1),
        (8, 3, 3, 2, 6, 10)]


@pytest.mark.parametrize("T,nx,nu,al_iter,n_newton,n_ls", GRID)
def test_algorithmic_counts_match_jax(T, nx, nu, al_iter, n_newton, n_ls):
    assert flops.fused_al_flops(T, nx, nu, al_iter, n_newton, n_ls) == \
        jax_flops.fused_al_flops(T, nx, nu, al_iter, n_newton, n_ls)
    assert flops.btsolve_flops(T, nx + nu) == \
        jax_flops.btsolve_flops(T, nx + nu)
    assert flops.riccati_flops(T, nx, nu) == jax_flops.riccati_flops(T, nx, nu)
    assert flops.bytes_per_solve(T, nx, nu) == \
        jax_flops.bytes_per_solve(T, nx, nu)


@pytest.mark.parametrize("kernel,want", [
    ("K1", ("8.5e-06", "bytes")), ("K2", ("4.0e-05", "operations")),
    ("K3", ("8.3e-06", "bytes")), ("K4", ("2.1e-05", "operations"))])
def test_cuda_source_counts_give_perf_bounds(kernel, want):
    """The bounds of PERF.md's kernel table at the main paths' shape (B 64,
    T 5, nx 2, nu 1, float32; K2 with each sin as one operation)."""
    B, T, nx, nu = 64, 5, 2, 1
    nbytes, nops = {
        "K1": (flops.k1_bytes(T, nx + nu), flops.k1_ops(T, nx + nu)),
        "K2": (flops.k2_bytes(T, nx, nu), flops.k2_ops(T, nx, nu, 2, 4, 20)),
        "K3": (flops.k3_bytes(T, nx, nu), flops.k3_ops(T, nx, nu)),
        "K4": (flops.k4_bytes(T, nx, nu), flops.k4_ops(T, nx, nu, 12)),
    }[kernel]
    ms, by = flops.bound(B * nbytes, B * nops)
    assert (f"{ms:.1e}", by) == want


def test_k2_bound_grows_with_the_sin_term():
    args = (5, 2, 1, 2, 4, 20)
    assert flops.k2_ops_with_sin(*args, sin_fp32_instr=1) == \
        flops.k2_ops(*args) + flops.k2_sin_evals(5, 2, 4, 20)
    assert flops.k2_ops_with_sin(
        *args, sin_fp32_instr=flops.SINF_FP32_INSTR) > flops.k2_ops(*args)


@pytest.mark.parametrize("model", flops.K2_MODELS)
def test_k2_counts_per_model(model):
    """K2's counts per model: the pendulum's PR 3 hand count (sins: one per
    step, one per Jacobian), the integrator's, and the cartpoles', the
    quadrotor's and the CosSin models' counted from their functors' plain
    versions (pinned: a
    change to a functor's arithmetic must show here and in the bound). The
    sin term keeps its meaning: k2_ops_with_sin at one FP32 instruction a
    sin adds the sins."""
    pinned = {"pendulum": (8, 9, 1, 1), "integrator": (4, 1, 0, 0),
              "cartpole1l": (124, 855, 8, 80),
              "cartpole2l": (342, 3262, 24, 336),
              "quadrotor": (1076, 34448, 0, 0),
              # atan2, cos and sin a step, each dual column 5 (atan2 1,
              # cos and sin 2 each)
              "pendulum_cossin": (11, 108, 3, 20),
              "cartpole_cossin": (29, 306, 3, 30)}
    assert flops._k2_model_counts(model) == pinned[model]
    args = (10, 4, 1, 4, 4, 20)
    assert flops.k2_ops_with_sin(*args, sin_fp32_instr=1, model=model) == \
        flops.k2_ops(*args, model=model) + flops.k2_sin_evals(
            10, 4, 4, 20, model=model)
    if model == "pendulum":
        T_, al_iter, n_newton, n_ls = 5, 2, 4, 20
        assert flops.k2_sin_evals(T_, al_iter, n_newton, n_ls) == \
            al_iter * (T_ - 1) * (2 + n_newton * (2 + n_ls)) + (T_ - 1)


def test_functor_counts_do_not_depend_on_the_constants():
    from diff_qp_mpc_tpu_torch.models import Cartpole2L

    assert flops.functor_counts(Cartpole2L()) == \
        flops.functor_counts(Cartpole2L.pkg())


def test_problem_matches_jax():
    got = roofline_fused._problem(16, device="cpu")
    want = jax_roofline._problem(16)
    assert isinstance(got[0], Pendulum)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("al_iter,n_newton,n_ls", [(2, 4, 20), (1, 1, 1),
                                                   (3, 2, 8)])
def test_sin_counts(al_iter, n_newton, n_ls):
    """The JAX formula is carried over; the CUDA count is what the plain
    version of K2 (which mirrors csrc/al_fused.cu) evaluates per element,
    counted on the pendulum's sin and cos calls."""
    assert roofline_fused.sin_evals_per_solve_jax_formula(
        al_iter, n_newton, n_ls) == jax_roofline.sin_evals_per_solve(
            al_iter, n_newton, n_ls)
    prob = roofline_fused._problem(1, device="cpu")
    seen = []
    mp = pytest.MonkeyPatch()
    for name in ("sin", "cos"):
        fn = getattr(torch, name)
        mp.setattr(torch, name, lambda a, fn=fn: seen.append(a.numel())
                   or fn(a))
    try:
        al_fused_cuda.fused_al_solve(*prob[:4], (-3.0,), (3.0,), *prob[4:],
                                     al_iter=al_iter, n_newton=n_newton,
                                     n_ls=n_ls)
    finally:
        mp.undo()
    assert sum(seen) == roofline_fused.sin_evals_per_solve(
        al_iter, n_newton, n_ls)
    assert roofline_fused.sin_evals_per_solve(2, 4, 20) == 724


@pytest.mark.parametrize("v", [-1e-9, 1.1000001, float("nan"),
                               float("inf")])
def test_check_frac_raises_outside(v):
    with pytest.raises(RuntimeError):
        roofline_fused.check_frac("x", v)


@pytest.mark.parametrize("v", [0.0, 0.5, 1.1])
def test_check_frac_passes_inside(v):
    assert roofline_fused.check_frac("x", v) == v


def test_decomposition_valid():
    # t = 1 + 0.1·n_ls at n_newton 4; 1.5 at n_newton 2: 0.75 per step
    out = roofline_fused.decompose(3.0, t_ls5=1.5, t_ls10=2.0, t_nw2=1.5)
    assert out["decomposition_valid"]
    np.testing.assert_allclose(out["ls_fraction_of_total"], 0.1 * 20 / 3.0)
    np.testing.assert_allclose(out["newton_nonls_fraction"],
                               (0.75 * 4 - 0.1 * 20) / 3.0)


@pytest.mark.parametrize("times", [
    dict(t_ls5=2.5, t_ls10=2.0, t_nw2=2.0),  # n_ls 5 slower than 10
    dict(t_ls5=1.5, t_ls10=2.0, t_nw2=3.5),  # n_newton 2 slower than 4
], ids=["ls", "newton"])
def test_decomposition_non_monotone(times):
    out = roofline_fused.decompose(3.0, **times)
    assert out == {"decomposition_valid": False}


def test_decomposition_non_positive_slope():
    out = roofline_fused.decompose(3.0, t_ls5=3.0, t_ls10=3.0, t_nw2=2.0)
    assert out == {"decomposition_valid": False}


# the opcodes the "Floating Point Instructions" table of NVIDIA's CUDA binary
# utilities reference lists for float32 (MUFU, the SFU, is not among them)
FP32_OPCODES = {"FADD", "FADD32I", "FCHK", "FCMP", "FFMA", "FFMA32I", "FMNMX",
                "FMUL", "FMUL32I", "FSEL", "FSET", "FSETP", "FSWZADD"}


def test_sinf_fp32_instructions_from_the_sass():
    """flops.SINF_FP32_INSTR against the SASS that cuobjdump (CUDA 12.8)
    printed for sm_90a of a probe kernel running ``v = sin(v)`` once per
    trip of a loop that is not unrolled, encodings dropped. The loop runs
    0x0a0-0x950; the fast path branches at 0x150 over the slow Payne-Hanek
    reduction (0x160-0x830, table loads and a loop of its own) to 0x840.
    A predicated instruction issues whether or not it executes, so it
    counts. Of the fast path's 30 instructions, 4 are the loop's (LDC of
    its bound, UIADD3, ISETP, the backward BRA): 26 are the sin's."""
    lines = (pathlib.Path(__file__).parent / "data" /
             "sinf_probe_sm90a.sass").read_text().splitlines()
    ops = {}
    for line in lines:
        m = re.search(r"/\*([0-9a-f]{4})\*/\s+(?:@!?P\d\s+)?([A-Z0-9]+)",
                      line)
        if m:
            ops[int(m.group(1), 16)] = m.group(2)
    fast = [op for a, op in ops.items()
            if 0x0a0 <= a <= 0x150 or 0x840 <= a <= 0x950]
    fp32 = [op for op in fast if op in FP32_OPCODES]
    assert len(fast) == 30
    assert len(fp32) == flops.SINF_FP32_INSTR
    assert {op: fp32.count(op) for op in set(fp32)} == \
        {"FFMA": 9, "FMUL": 2, "FSEL": 3, "FSETP": 1}
    assert "MUFU" not in ops.values()


def test_k5_bound_counts():
    assert flops.k5_bytes(64, 8) == 4 * 64 * 1024 * 9
    assert flops.k5_ops(1, 1, 1, 20) == 1024 * 40


def test_profiler_problem_draws_as_jax():
    """The K4 profiler's numpy draw, in the JAX script's order."""
    C, c, A, Bm, f, x0 = prof.problem_arrays(4, 5, 4, 1)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(c, 0.3 * rng.randn(4, 5, 5))
    np.testing.assert_array_equal(Bm, 0.2 * rng.randn(4, 4, 4, 1))
    np.testing.assert_array_equal(f, 0.05 * rng.randn(4, 4, 4))
    np.testing.assert_array_equal(x0, 0.4 * rng.randn(4, 4))
    np.testing.assert_array_equal(C[0, 0], np.diag([10.0] * 4 + [0.1]))
    np.testing.assert_array_equal(A[1, 2], np.eye(4) + 0.05)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_queued_events_raise_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.queued_events_ms(lambda: torch.zeros(1), 1)


def test_timing_raises_without_card():
    _no_card()
    run = lambda: torch.zeros(1)
    with pytest.raises(RuntimeError):
        timing.steady_state(run, n_rep=1, n_outer=1)
    with pytest.raises(RuntimeError):
        timing.per_call_latency(run, n_rep=1)


class _Event:
    def __init__(self, key, device_time_total, count):
        self.key, self.device_time_total, self.count = (
            key, device_time_total, count)


def _fake_profiler(monkeypatch, windows):
    """torch.profiler.profile whose successive windows see the kernel
    events of ``windows`` in turn; the card's checks pass."""
    import torch.profiler

    seen = iter(windows)

    class Profile:
        def __init__(self, **kw):
            self.events = next(seen)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return self.events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_device_kernel_ms_retries_then_raises(monkeypatch):
    """A profiled window with no time of the kernel is taken again; after
    ``PROFILE_ATTEMPTS`` such windows the sweep raises instead of
    recording a missing time."""
    calls = []
    _fake_profiler(monkeypatch, [[_Event("other", 5.0, 1)], [], []])
    with pytest.raises(RuntimeError, match="no device time"):
        timing.device_kernel_ms(lambda: calls.append(1), 3, "btsolve")
    # one warm-up, then every window
    assert len(calls) == 1 + timing.PROFILE_ATTEMPTS * 3

    _fake_profiler(monkeypatch, [[], [_Event("btsolve_onchip<3,5>", 12.0,
                                             3)]])
    assert timing.device_kernel_ms(lambda: None, 3, "btsolve") == 0.004


@pytest.mark.parametrize("entry", [roofline_fused, prof],
                         ids=["roofline_fused", "prof_trajqp_fused"])
def test_entry_points_raise_without_card(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main([])


def test_jax_bounds_stay_out_of_the_port():
    assert not any(name.startswith("V5E") for name in vars(flops))
    assert flops.FP32_OPS_PER_S == 67e12 and flops.HBM_BYTES_PER_S == 3.35e12
