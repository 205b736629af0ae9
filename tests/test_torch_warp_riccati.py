"""K3's horizon kernel on the warp layout (csrc/riccati_horizon_warp.cu, the
quadrotor's (nx, nu) = (12, 4) and (16, 4) and the one-control shapes (2, 1)
and (4, 1) to (7, 1)) and K4's warp layout at the cartpoles' shapes
(csrc/trajqp_fused_warp.cu) on the CPU: the dispatch rules as plain
Python, each source's instantiations against its wrapper's
table, and both kernels in the pthread emulation of a warp
(``utils.warp_emu``: one thread per lane, g++) against their plain
versions, and K3's against the JAX package's plain Riccati solve.

Tolerances: K3 is a direct solve, so float64 agrees with the plain
version to rounding (1e-12 relative to the largest entry; the emulation
runs the kernel's sums in their order without contraction) and with the
JAX package's scan to 1e-10, as tests/test_torch_riccati.py holds the plain
versions. K4 on the warp layout sums its norms, μ and σ over the warp in
another order than the plain version, so it is held to
``kernel_layouts.K4W_TOL`` (float64 1e-9 of each output's largest entry or
1), as on the card. The emulation tests skip where g++ is missing."""
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_qp_mpc_tpu.ops import riccati as jax_riccati
from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import (
    K4W_TOL,
    lqr_problem,
)
from diff_qp_mpc_tpu_torch.ops import riccati, riccati_cuda, trajqp_fused_cuda
from diff_qp_mpc_tpu_torch.utils.cuda_build import CSRC

REG = 1e-9
QUAD_SHAPES = ((12, 4), (16, 4))
CARTPOLE_SHAPES = ((5, 5, 1), (5, 6, 1), (5, 7, 1))


def _rel(got, want):
    """The largest over matching outputs of max |got − want| over
    max |want|; ``want`` torch or JAX arrays."""
    return max(float((g - torch.tensor(np.array(w))).abs().max()
                     / np.abs(np.array(w)).max())
               for g, w in zip(got, want))


@pytest.mark.parametrize("T", [1, 5, 20])
@pytest.mark.parametrize("nx,nu", QUAD_SHAPES)
def test_k3_rule_takes_the_warp_layout_at_the_quadrotor_shapes(T, nx, nu):
    assert riccati_cuda.kernel_for(T, nx, nu) == "riccati_horizon_warp"


# the one-control shapes of the cartpoles' expert planners (T 60, 80, 10,
# 120), their slew shapes and CartpoleCosSin's ip path (T 5), and the
# pendulum's and the integrator's planners (T 20, 30, 40): the warp layout
# measured faster than one thread per element there at the paths' batches
ONE_CONTROL_WARP_SHAPES = ((60, 4, 1), (80, 4, 1), (10, 6, 1), (120, 6, 1),
                           (5, 5, 1), (5, 7, 1), (20, 2, 1), (30, 2, 1),
                           (40, 2, 1))


@pytest.mark.parametrize("T,nx,nu", ONE_CONTROL_WARP_SHAPES)
def test_k3_rule_takes_the_warp_layout_at_the_one_control_shapes(T, nx, nu):
    assert riccati_cuda.kernel_for(T, nx, nu) == "riccati_horizon_warp"


@pytest.mark.parametrize("shape", CARTPOLE_SHAPES)
def test_k4_rule_takes_the_warp_layout_at_the_cartpole_shapes(shape):
    assert trajqp_fused_cuda.layout_for(*shape) == "warp"


def _shapes(text, macro):
    """The tuples of the X(...) list of ``#define <macro>(X)``."""
    body = re.search(r"#define " + macro + r"\(X\)((?:[^\n]*\\\n)*[^\n]*)",
                     text).group(1)
    return {tuple(int(v) for v in m.split(","))
            for m in re.findall(r"X\(([\d, ]+)\)", body)}


def _dispatch_shapes(text, fields):
    """The shapes of a dispatch list of ``if (a == N && ...)`` lines."""
    pattern = r" && ".join(rf"{f} == (\d+)" for f in fields)
    return {tuple(int(v) for v in m)
            for m in re.findall(r"if \(" + pattern + r"\)", text)}


def test_each_source_instantiates_its_wrappers_table():
    """The warp sources' shape lists and the thread source's dispatch list
    are the wrappers' tables, and no shape has both K4 layouts."""
    read = lambda name: (CSRC / f"{name}.cu").read_text()
    assert _shapes(read("riccati_horizon_warp"),
                   "RICCATI_HORIZON_WARP_SHAPES") == set(
        riccati_cuda.HORIZON_WARP_BUILT)
    assert _shapes(read("trajqp_fused_warp"), "TRAJQP_WARP_SHAPES") == set(
        trajqp_fused_cuda.WARP_BUILT)
    assert _dispatch_shapes(read("trajqp_fused"), ("T", "nx", "nu")) == set(
        trajqp_fused_cuda.BUILT)
    assert not set(trajqp_fused_cuda.BUILT) & set(
        trajqp_fused_cuda.WARP_BUILT)


def test_k3_warp_shape_on_the_cpu_takes_the_plain_version():
    """CPU tensors at a warp-layout shape take the plain version, bit for
    bit, and launch nothing."""
    args = lqr_problem(2, 20, 12, 4, torch.float64, seed=1, device="cpu")
    before = (riccati_cuda.launches, riccati_cuda.horizon_launches)
    out = riccati_cuda.batched_lqr_kkt_solve(*args, REG)
    ref = riccati.batched_lqr_kkt_solve(*args, REG)
    assert all(torch.equal(a, b) for a, b in zip(out, (ref.dx, ref.du,
                                                        ref.lam)))
    assert (riccati_cuda.launches, riccati_cuda.horizon_launches) == before


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("the warp emulation builds with g++, not found")


@pytest.mark.parametrize("T,nx,nu", [(20, 12, 4), (5, 16, 4)])
def test_warp_emulation_k3_matches_plain(T, nx, nu):
    """K3's warp-layout horizon kernel, float64, B 2 (one block of two
    warps), in the emulation: within 1e-12 of the port's plain version
    and, at the quadrotor expert's (20, 12, 4), within 1e-10 of the JAX
    package's plain solve on the same numpy inputs."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    args = lqr_problem(2, T, nx, nu, torch.float64, seed=T + nx,
                       device="cpu")
    out = warp_emu.riccati_horizon_warp(args, REG)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    ref = riccati.batched_lqr_kkt_solve(*args, REG)
    assert _rel(out, (ref.dx, ref.du, ref.lam)) <= 1e-12
    if (T, nx, nu) == (20, 12, 4):
        sol = jax.jit(jax_riccati.batched_lqr_kkt_solve)(
            *(jnp.asarray(a.numpy()) for a in args), REG)
        assert _rel(out, (sol.dx, sol.du, sol.lam)) <= 1e-10


@pytest.mark.parametrize("T,nx,nu", [(60, 4, 1), (10, 6, 1), (30, 2, 1)])
def test_warp_emulation_k3_one_control_matches_plain(T, nx, nu):
    """K3's warp-layout horizon kernel at the one-control shapes it took
    over from the one-thread kernel (the cp1 stabilize planner's (60, 4, 1),
    the cp2 expert's (10, 6, 1) and the integrator expert's (30, 2, 1)),
    float64, B 3 (two blocks of two
    warps, the last one ragged), in the emulation: within 1e-13 of the
    port's plain version, relative to each output's largest entry (the
    same sums in the same order, so rounding differs only where the plain
    version's batched matmuls order a sum otherwise)."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    args = lqr_problem(3, T, nx, nu, torch.float64, seed=T + nx,
                       device="cpu")
    out = warp_emu.riccati_horizon_warp(args, REG)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    ref = riccati.batched_lqr_kkt_solve(*args, REG)
    assert _rel(out, (ref.dx, ref.du, ref.lam)) <= 1e-13


def test_warp_emulation_k4_cartpole_matches_plain():
    """K4's warp layout at cp2's (5, 6, 1), float64, B 2, on the K4
    profiler's random box QPs (cold-started), in the emulation: within
    K4W_TOL of the plain version on all eight outputs."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    arrays, box = prof.problem(2, 5, 6, 1, torch.float64, device="cpu")
    args = (*arrays, *prof.cold_start(*arrays), box.u_lo, box.u_hi)
    out = warp_emu.fused_trajqp_solve_warp(*args)
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    for got, want in zip(out, ref):
        err = float((got - want).abs().max()) / max(1.0, float(
            want.abs().max()))
        assert err <= K4W_TOL[torch.float64]
