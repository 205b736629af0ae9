"""K3's unrolled kernel (csrc/riccati.cu: one thread an element, its block
staged through shared memory) and K4's thread layout (csrc/trajqp_fused.cu)
on the CPU, built with g++ (``utils.warp_emu``: one POSIX thread per CUDA
thread, shared memory filled with NaN bytes, so a read of an unwritten word
shows).

K3: the staged kernel is held bit for bit to the same source's
``riccati_solve`` run unstaged, one element after another straight from
the inputs (as the kernel loaded them before it staged its block), at
batches that leave the last block partial and on inputs at a storage
offset that is not 16-byte aligned; and to the JAX package's
``batched_lqr_kkt_solve`` within K3_TOL (chip_smoke.py's).

K4: the thread layout built for the host is held to the JAX package's
``fused_trajqp_solve`` (its Pallas kernel in interpret mode, as
tests/test_torch_trajqp.py runs it) on the same numpy inputs within K4_TOL
(chip_smoke.py's) on all eight outputs, each error over max(1, the
output's largest entry); an element poisoned with NaN keeps the plain
version's NaNs and leaves the other elements as they were; and its ratio
test alone keeps the NaN semantics of a minimum over every entry's ratio.

g++ does not contract multiply-adds here, so the emulation runs the
kernels' arithmetic and order, not the card's rounding. The tests skip
where g++ is missing."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import K3_TOL, K4_TOL
from diff_qp_mpc_tpu.ops import riccati as jax_riccati
from diff_qp_mpc_tpu.ops.trajqp_fused_pallas import (
    fused_trajqp_solve as jax_fused_trajqp_solve,
)
from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import lqr_problem
from diff_qp_mpc_tpu_torch.ops import riccati_cuda, trajqp_fused_cuda

REG = 1e-9
NAN = float("nan")


@pytest.fixture(autouse=True)
def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("the emulation builds with g++, not found")


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _at_offset(a, offset):
    """``a`` as a contiguous view at ``offset`` scalars into a larger
    storage: 8 bytes in float64, so not on a 16-byte boundary."""
    flat = torch.cat([a.new_zeros(offset), a.reshape(-1)])
    return flat[offset:].view(a.shape)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("T,nx,nu", [(5, 2, 1), (5, 6, 1)])
def test_k3_staged_matches_unstaged_and_jax(T, nx, nu, offset):
    """float64, at the table's elements a block plus 3 (the last block
    partial): bit for bit the unstaged solve, and within K3_TOL of JAX's
    plain Riccati solve, relative to each output's largest entry."""
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    dtype = torch.float64
    B = riccati_cuda.ELEMENTS_PER_BLOCK + 3
    args = lqr_problem(B, T, nx, nu, dtype, seed=B + nx, device="cpu")
    staged_args = [_at_offset(a, offset) for a in args]
    assert all(a.storage_offset() == offset and a.is_contiguous()
               for a in staged_args)
    want = warp_emu.riccati_unstaged(args, REG)
    assert _same(warp_emu.riccati_staged(staged_args, REG), want)
    sol = jax.jit(jax_riccati.batched_lqr_kkt_solve)(
        *(jnp.asarray(a.numpy()) for a in args), REG)
    for g, w in zip(want, (sol.dx, sol.du, sol.lam)):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max() / np.abs(w).max()) \
            <= K3_TOL[dtype]


@pytest.mark.parametrize("T,nx,nu", riccati_cuda.BUILT)
def test_k3_staged_every_shape_same_bits(T, nx, nu):
    """float32 at every shape the kernel is built for, at two blocks and
    five elements of its elements a block: the unstaged solve's bits; and
    the elements a block that the source fixes at compile time are the
    wrapper's."""
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    epb = riccati_cuda.ELEMENTS_PER_BLOCK
    assert all(warp_emu.riccati_elements_per_block(d, T, nx, nu) == epb
               for d in (torch.float32, torch.float64))
    args = lqr_problem(2 * epb + 5, T, nx, nu, torch.float32, seed=nx + nu,
                       device="cpu")
    assert _same(warp_emu.riccati_staged(args, REG),
                 warp_emu.riccati_unstaged(args, REG))


def _jax_k4(qp, box, dtype):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    out = jax_fused_trajqp_solve(
        *(jnp.asarray(a.numpy(), jdt) for a in qp), tuple(box.u_lo),
        tuple(box.u_hi), max_iter=12, reg=REG, interpret=True)
    return [np.asarray(o) for o in out]


# the JAX kernel in interpret mode takes ~10 s at (5, 2, 1) and ~35 s at
# (5, 4, 1) on one core, so (5, 4, 1) runs in float64 only
@pytest.mark.parametrize("shape,dtype", [
    ((5, 2, 1), torch.float64), ((5, 2, 1), torch.float32),
    ((5, 4, 1), torch.float64)], ids=str)
def test_k4_thread_host_build_matches_jax(shape, dtype):
    """The profiler benchmark's random box QPs, B 5, cold-started, at the
    ip path's budget (max_iter 12, reg 1e-9)."""
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    arrays, box = prof.problem(5, *shape, dtype, device="cpu")
    qp = (*arrays, *prof.cold_start(*arrays))
    out = warp_emu.fused_trajqp_solve_thread(*qp, box.u_lo, box.u_hi,
                                             max_iter=12, reg=REG)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    for g, w in zip(out, _jax_k4(qp, box, dtype)):
        err = float(np.abs(g.numpy() - w).max()) / max(1.0,
                                                      float(np.abs(w).max()))
        assert err <= K4_TOL[dtype]


def test_k4_thread_poisoned_element_keeps_nan():
    """One element's QP poisoned with NaN (its u_init and a cost entry), in
    float64 at (5, 2, 1), B 4: its outputs are NaN where the plain
    version's are (its u among them: a NaN total never becomes the best),
    and every other element's within K4_TOL of the plain version's."""
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    arrays, box = prof.problem(4, 5, 2, 1, torch.float64, device="cpu")
    qp = [a.clone() for a in (*arrays, *prof.cold_start(*arrays))]
    qp[7][2, 1] = NAN  # u_init: its slacks start NaN
    qp[1][2, 3, 0] = NAN  # c
    out = warp_emu.fused_trajqp_solve_thread(*qp, box.u_lo, box.u_hi,
                                             max_iter=12, reg=REG)
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(
        *qp, box.u_lo, box.u_hi, max_iter=12, reg=REG)
    keep = torch.tensor([True, True, False, True])
    assert bool(torch.isnan(out[1][2]).any())  # u: no iterate is better
    for g, w in zip(out, ref):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        err = float((g[keep] - w[keep]).abs().max()) / max(
            1.0, float(w[keep].abs().max()))
        assert err <= K4_TOL[torch.float64]


def test_k4_ratio_test_semantics():
    """``max_step`` alone: the cap at 1; the least −v/dv over dv < 0
    (chosen by cross products, divided once); a NaN v where dv < 0 gives
    NaN; a NaN dv is skipped; a NaN v where dv ≥ 0 is skipped."""
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    v = [1.0] * 20
    up = [0.5] * 20
    assert warp_emu.k4_max_step(v, up) == 1.0
    dv = list(up)
    dv[3], dv[12], dv[17] = -4.0, -2.0, -0.5  # ratios 0.25, 0.5, 2
    v[12] = 0.3  # ratio 0.15: the blocking entry
    assert warp_emu.k4_max_step(v, dv) == -0.3 / -2.0
    nan_v = list(v)
    nan_v[8] = NAN
    assert np.isnan(warp_emu.k4_max_step(nan_v, dv[:8] + [-1.0] + dv[9:]))
    assert warp_emu.k4_max_step(nan_v, dv) == -0.3 / -2.0  # dv[8] > 0
    nan_dv = list(dv)
    nan_dv[5] = NAN
    assert warp_emu.k4_max_step(v, nan_dv) == -0.3 / -2.0
