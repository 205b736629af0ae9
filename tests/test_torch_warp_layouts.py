"""The warp layouts of K1 (csrc/btsolve.cu at n 16) and K2 (the cartpoles,
csrc/al_fused_cartpole1l.cu and al_fused_cartpole2l.cu, and the quadrotor)
on the CPU: K1's layout rule as plain Python, the sources' entries against
the wrapper's table, and the kernels themselves in the pthread emulation of
a warp (``utils.warp_emu``: one thread per lane, g++) against their plain
versions. The emulation tests skip where g++ is missing."""
import re
import shutil

import pytest
import torch

from diff_qp_mpc_tpu_torch.benchmarks import k2_models
from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import random_bt_spd
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve, btsolve_cuda
from diff_qp_mpc_tpu_torch.utils.cuda_build import CSRC

CARTPOLES = ("cartpole1l", "cartpole2l")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T", [1, 5, 10])
def test_k1_rule_takes_warp_at_n16(dtype, T):
    """At the quadrotor's block size the rule takes the warp layout at any
    T, and the warp layout has an instantiation only there."""
    assert btsolve_cuda.choose_layout(dtype, 16, T) == "warp"
    assert btsolve_cuda.WARP_SIZES == (16,)
    assert btsolve_cuda.WARP_COMPUTE[torch.float64] == torch.float64
    for n in set(btsolve_cuda.BLOCK_SIZES) - {16}:
        assert btsolve_cuda.choose_layout(dtype, n, T) != "warp"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_rule_takes_stream_where_the_warp_block_does_not_fit(dtype):
    """The warp layout's block at n 16 (two elements, computing in float64)
    fits an H100's 232,448 B up to T 26; above, and under a smaller limit,
    the rule takes the streaming kernel, which serves any T."""
    assert btsolve_cuda.warp_block_bytes(5, 16, torch.float64) == 2 * 20224
    assert btsolve_cuda.warp_block_bytes(5, 16, torch.float32) == 20224
    assert btsolve_cuda.warp_block_bytes(26, 16, torch.float64) <= \
        btsolve_cuda.H100_SMEM_PER_BLOCK < \
        btsolve_cuda.warp_block_bytes(27, 16, torch.float64)
    assert btsolve_cuda.choose_layout(dtype, 16, 26) == "warp"
    for T in (27, 30, 100):
        assert btsolve_cuda.choose_layout(dtype, 16, T) == "stream"
    small = btsolve_cuda.warp_block_bytes(5, 16, torch.float64) - 1
    assert btsolve_cuda.choose_layout(dtype, 16, 5, small) == "stream"


def test_k2_cartpoles_take_the_warp_layout():
    """Every (T, dtype) a cartpole is built for runs the warp layout, from
    one source per model; no group-layout instantiation of a cartpole is
    left (its host build instantiates the one-lane kernel)."""
    cases = {(b.name, T, dtype) for b in al_fused_cuda.BUILT.values()
             if b.name in CARTPOLES
             for dtype, hs in b.horizons.items() for T in hs}
    assert {(n, T) for n, T, _ in cases} == {
        (n, T) for n in CARTPOLES for T in (5, 10)}
    for name in CARTPOLES:
        built = al_fused_cuda.built_for(k2_models.model(name))
        assert (built.layout, built.library) == ("warp", f"al_fused_{name}")
        text = (CSRC / f"{built.library}.cu").read_text()
        assert "AL_FUSED_CASE" not in text and "AL_RESIDENT" not in text
    assert not [lib for lib in al_fused_cuda.LIBRARIES
                if "cartpole" in lib and lib not in (
                    "al_fused_cartpole1l", "al_fused_cartpole2l")]


def _warp_cases(library):
    """{(T, dtype, W)} of the AL_WARP_CASEs in csrc/<library>.cu's launch
    entries, and of the AL_WARP_SMEM_CASEs in its shared-memory entries."""
    text = (CSRC / f"{library}.cu").read_text()
    out = {"AL_WARP_ENTRY": set(), "AL_WARP_SMEM_ENTRY": set()}
    for m in re.finditer(r"(AL_WARP_(?:SMEM_)?ENTRY)\((\w+),", text):
        depth, i = 1, m.end()
        while depth:  # to the invocation's closing parenthesis
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        dtype = torch.float32 if m.group(2).endswith("f32") else \
            torch.float64
        case = m.group(1).replace("ENTRY", "CASE")
        out[m.group(1)] |= {(int(T), dtype, int(W)) for T, W in re.findall(
            case + r"\((\d+), [\w:]+, \w+, (\d+)\)", text[m.end():i])}
    return out


WARP_MODELS = [name for name in k2_models.ENVS if al_fused_cuda.built_for(
    k2_models.model(name)).layout == "warp"]


@pytest.mark.parametrize("name", WARP_MODELS)
def test_every_warp_table_entry_has_an_al_warp_case(name):
    """Each (T, dtype) of the wrapper's table for a model on the warp
    layout (the cartpoles and the quadrotor), at the table's warps per
    element, is an AL_WARP_CASE (and an AL_WARP_SMEM_CASE) of its source,
    under the entry names the wrapper calls, and the source instantiates
    no other (T, dtype, W)."""
    built = al_fused_cuda.built_for(k2_models.model(name))
    table = {(T, dtype, built.warps)
             for dtype, hs in built.horizons.items() for T in hs}
    assert built.warps in (1, 2, 4)
    cases = _warp_cases(built.library)
    assert cases["AL_WARP_ENTRY"] == cases["AL_WARP_SMEM_ENTRY"] == table
    text = (CSRC / f"{built.library}.cu").read_text()
    for dtype in built.horizons:
        for kw in (dict(), dict(smem=True)):
            assert built.symbol(dtype, **kw) + "," in text


def test_k2_cartpole_on_the_cpu_takes_the_plain_version():
    """CPU tensors take the plain version, bit for bit, at either group
    width the warp layout accepts; a group width outside GROUPS is
    refused."""
    args = k2_models.problem("cartpole1l", 2, 5, torch.float64, seed=0,
                             device="cpu")
    ref = al_fused_cuda.fused_al_solve_reference(*args, al_iter=1,
                                                 n_newton=1)
    for group in (None, 32):
        out = al_fused_cuda.fused_al_solve(*args, al_iter=1, n_newton=1,
                                           group=group)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError):
        al_fused_cuda.fused_al_solve(*args, group=3)


def _needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("the warp emulation builds with g++, not found")


def test_warp_emulation_k1_matches_plain():
    """K1's warp kernel, float64, n 16, T 5, B 3 (two blocks of two warps,
    the last one ragged), in the emulation: within 1e-12 of the plain
    version, relative to the solution's largest entry."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    D, O, b = random_bt_spd(3, 5, 16, torch.float64, seed=3, device="cpu")
    x = warp_emu.btsolve_warp(D, O, b, 1e-7)
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    assert bool(torch.isfinite(x).all())
    assert float((x - ref).abs().max() / ref.abs().max()) <= 1e-12


def test_warp_emulation_k2_cartpole_matches_plain():
    """K2's warp instantiation for Cartpole2L, float64, T 5, B 2, in the
    emulation: every element within k2_models.TOL of the plain version."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    args = k2_models.problem("cartpole2l", 2, 5, torch.float64, seed=2,
                             device="cpu")
    out = warp_emu.fused_al_solve_warp(*args, **k2_models.BUDGET)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **k2_models.BUDGET)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    el = k2_models.element_errors(out, ref)
    assert float(el.max()) <= k2_models.TOL[torch.float64]


@pytest.mark.parametrize("name,T,dtype", [
    ("quadrotor", 5, torch.float64), ("cartpole2l", 10, torch.float32)],
    ids=str)
def test_warp_emulation_k2_warps_match_w1(name, T, dtype):
    """K2's warp layout at its source's W warps per element (each element a
    block of its own) against W 1 (two elements a block) in the emulation,
    built at both: the same bits, since every entry keeps its expression
    and its order of summation. B 3: a ragged last block at W 1. Against the plain
    version: the quadrotor (float64) every element within k2_models.TOL;
    cp2 at T 10, which has no float64 instantiation, in float32 within the
    card's rule (TOL but for the share limit, the median within
    MEDIAN_LIMIT)."""
    _needs_gxx()
    from diff_qp_mpc_tpu_torch.utils import warp_emu

    args = k2_models.problem(name, 3, T, dtype, seed=3, device="cpu")
    bud = k2_models.budget(name)
    W = al_fused_cuda.built_for(args[0]).warps
    assert W > 1
    w1 = warp_emu.fused_al_solve_warp(*args, **bud, warps=1)
    out = warp_emu.fused_al_solve_warp(*args, **bud, warps=W)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert k2_models._same(out, w1)
    el = k2_models.element_errors(
        out, al_fused_cuda.fused_al_solve_reference(*args, **bud))
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.share_limit(name, dtype)
    assert float(el.median()) <= k2_models.MEDIAN_LIMIT[dtype]
