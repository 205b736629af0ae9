"""K2's line search over a group of lanes, and the wrappers' pure choices.

The kernel (csrc/al_fused.cu) spreads the n_ls candidates of each line
search over G lanes: lane ℓ scans k ≡ ℓ (mod G) in ascending order with the
serial strict-`<` rule from float32's max, then a butterfly over the group
(``__shfl_xor_sync``, log₂G rounds) keeps the least (merit, k) in
lexicographic order. A numpy model of that pick is held here to the serial
rule of the JAX kernel (al_fused_pallas.py ls_body): the same k, the same
merit to the bit, for merits drawn with ties, ±0, NaN, ±inf and float32's
max. The card tests (test_torch_cuda_kernels.py) hold the kernel itself at
every G bit-identical to G = 1.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda, btsolve_cuda

F32_MAX = float(np.finfo(np.float32).max)
SPECIAL = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), F32_MAX,
           -F32_MAX, float(np.nextafter(np.float32(F32_MAX), 0)), 1.0, 1.0,
           -2.5, 1e-30]


def serial_pick(m, dtype):
    """ls_body's rule: strict < from float32's max, k = n_ls for none."""
    best_m, best_k = dtype(F32_MAX), len(m)
    for k, mk in enumerate(m):
        if mk < best_m:
            best_m, best_k = mk, k
    return best_m, best_k


def group_pick(m, G, dtype):
    """Per-lane first minimum over k ≡ ℓ (mod G), then the (m, k)
    butterfly; every lane must end with the same pair."""
    n = len(m)
    lanes = [serial_pick_from(m, range(lane, n, G), dtype)
             for lane in range(G)]
    s = 1
    while s < G:
        nxt = []
        for lane in range(G):
            bm, bk = lanes[lane]
            om, ok = lanes[lane ^ s]
            if om < bm or (om == bm and ok < bk):
                bm, bk = om, ok
            nxt.append((bm, bk))
        lanes, s = nxt, s << 1
    assert all(_same(p, lanes[0]) for p in lanes)
    return lanes[0]


def serial_pick_from(m, ks, dtype):
    best_m, best_k = dtype(F32_MAX), len(m)
    for k in ks:
        if m[k] < best_m:
            best_m, best_k = m[k], k
    return best_m, best_k


def _same(a, b):
    """Equal k and bit-equal merit."""
    return a[1] == b[1] and np.asarray(a[0]).tobytes() == \
        np.asarray(b[0]).tobytes()


merits = st.lists(st.one_of(st.sampled_from(SPECIAL),
                            st.floats(width=32, allow_nan=True),
                            st.integers(-3, 3).map(float)),
                  min_size=1, max_size=40)


@settings(max_examples=300, deadline=None)
@given(m=merits, G=st.sampled_from(al_fused_cuda.GROUPS),
       dtype=st.sampled_from([np.float32, np.float64]))
def test_group_pick_equals_serial_rule(m, G, dtype):
    m = [dtype(v) for v in m]
    assert _same(group_pick(m, G, dtype), serial_pick(m, dtype))


@pytest.mark.parametrize("G", al_fused_cuda.GROUPS)
@pytest.mark.parametrize("n_ls", [1, 7, 20, 33, 40])
def test_group_pick_ties_and_none(G, n_ls):
    """All equal: the first k wins; all NaN or at float32's max: none
    (k = n_ls, so the step is 0); the least of −0 and +0 is the first."""
    f = np.float32
    assert group_pick([f(2.0)] * n_ls, G, f)[1] == 0
    for v in (float("nan"), F32_MAX, float("inf")):
        assert group_pick([f(v)] * n_ls, G, f) == (f(F32_MAX), n_ls)
    zeros = [f(0.0) if k % 2 else f(-0.0) for k in range(n_ls)]
    assert _same(group_pick(zeros, G, f), (f(-0.0), 0))


# resident threads of K2 at T 5, float32 on an H100 80GB HBM3 per G, as
# CUDA's occupancy calculator reads them: 4 blocks of 64 a SM at each G's
# register count (195 at G 1, 201-203 above), 132 SMs
H100_RESIDENT = {G: 4 * 64 * 132 for G in al_fused_cuda.GROUPS}


@pytest.mark.parametrize("B,G", [(1, 32), (64, 32), (256, 32), (1056, 32),
                                 (1057, 16), (4096, 8), (33792, 1),
                                 (262144, 1)])
def test_choose_group_h100(B, G):
    assert al_fused_cuda.choose_group(B, H100_RESIDENT) == G


@given(B=st.integers(1, 1 << 20),
       threads=st.lists(st.integers(0, 1 << 22),
                        min_size=len(al_fused_cuda.GROUPS),
                        max_size=len(al_fused_cuda.GROUPS)))
def test_choose_group_is_widest_that_fits(B, threads):
    resident = dict(zip(al_fused_cuda.GROUPS, threads))
    G = al_fused_cuda.choose_group(B, resident)
    assert G in al_fused_cuda.GROUPS
    assert G == 1 or B * G <= resident[G]
    assert all(B * H > resident[H] for H in al_fused_cuda.GROUPS if H > G)


def _k2_args(B=3, T=5):
    rng = np.random.RandomState(0)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    x0 = rng.uniform(-0.5, 0.5, (B, 2))
    return (Pendulum(), t(np.broadcast_to([10.0, 1.0, 0.01], (B, T, 3))),
            t(rng.randn(B, T, 3)), t(x0), (-3.0,), (3.0,),
            t(np.repeat(x0[:, None], T, 1)), torch.zeros(B, T, 1,
                                                         dtype=torch.float64))


def test_fused_al_solve_group_does_not_change_cpu_result():
    """On the CPU the plain version runs whatever the group; a group the
    kernel does not take is refused there too."""
    args = _k2_args()
    kw = dict(al_iter=1, n_newton=2)
    ref = al_fused_cuda.fused_al_solve(*args, **kw)
    for G in al_fused_cuda.GROUPS:
        out = al_fused_cuda.fused_al_solve(*args, **kw, group=G)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    for bad in (0, 3, 64):
        with pytest.raises(ValueError):
            al_fused_cuda.fused_al_solve(*args, **kw, group=bad)


@pytest.mark.parametrize("dtype,n,T,layout", [
    (torch.float32, 3, 5, "onchip"), (torch.float32, 3, 10, "onchip"),
    (torch.float32, 5, 5, "onchip"), (torch.float32, 5, 10, "stream"),
    (torch.float32, 3, 7, "stream"), (torch.float32, 7, 5, "stream"),
    (torch.float32, 16, 5, "warp"), (torch.float64, 3, 5, "onchip"),
    (torch.float64, 3, 10, "stream"), (torch.float64, 5, 5, "stream"),
    (torch.float16, 3, 5, "stream")])
def test_choose_layout(dtype, n, T, layout):
    """On chip at the shapes whose element fits in registers without
    spills (the main path's (3, 5) in both dtypes), a warp per element at
    the quadrotor's n 16, streaming elsewhere."""
    assert btsolve_cuda.choose_layout(dtype, n, T) == layout


def test_choose_layout_covers_every_onchip_shape():
    for dtype, shapes in btsolve_cuda.ONCHIP_SHAPES.items():
        for n, T in shapes:
            assert n in btsolve_cuda.BLOCK_SIZES
            assert btsolve_cuda.choose_layout(dtype, n, T) == "onchip"


def test_batched_factor_solve_layout_on_cpu():
    """CPU tensors take the plain version whatever the layout; a layout the
    kernel does not have is refused."""
    rng = np.random.RandomState(0)
    B, T, n = 2, 5, 3
    L = np.tril(rng.randn(B, T, n, n)) + 3 * np.eye(n)
    D = torch.tensor(L @ L.transpose(0, 1, 3, 2))
    O = torch.tensor(0.1 * rng.randn(B, T - 1, n, n))
    b = torch.tensor(rng.randn(B, T, n))
    ref = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7)
    for layout in btsolve_cuda.LAYOUTS:
        x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout=layout)
        assert torch.equal(x, ref)
    with pytest.raises(ValueError):
        btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout="onchip_rinv")
