"""The port's CUDA kernels against their plain PyTorch versions, on the card.
This file imports no JAX, so it runs on the GPU machine:

    python -m pytest -p no:xdist -o addopts="" -m cuda tests/test_torch_cuda_kernels.py

Without a CUDA device every test skips. Tolerances as in chip_smoke.py."""
import numpy as np
import pytest
import torch

from diff_qp_mpc_tpu_torch.benchmarks import k2_models
from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import (
    F32_VS_F64_RATIO,
    K1_TOL,
)
from diff_qp_mpc_tpu_torch.core.types import ALState, Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import (
    al_fused_cuda,
    btsolve,
    btsolve_cuda,
    riccati,
    riccati_cuda,
    sin_chain_cuda,
    trajqp_fused_cuda,
)
from diff_qp_mpc_tpu_torch.solvers import al_mpc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _system(B, T, n, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    Ld = np.tril(0.3 * rng.randn(B, T, n, n), -1) + np.eye(n) * (
        1.0 + rng.rand(B, T, n, 1))
    Ls = 0.3 * rng.randn(B, T, n, n)
    D = Ld @ Ld.transpose(0, 1, 3, 2)
    D[:, 1:] += Ls[:, 1:] @ Ls[:, 1:].transpose(0, 1, 3, 2)
    O = Ls[:, 1:] @ Ld[:, :-1].transpose(0, 1, 3, 2)
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return to(D), to(O), to(rng.randn(B, T, n))


@pytest.mark.parametrize("n", btsolve_cuda.BLOCK_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_btsolve_kernel_matches_plain(cuda, n, dtype, tol):
    D, O, b = _system(100, 5, n, dtype, cuda, seed=n)
    before = btsolve_cuda.launches
    x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7)
    assert btsolve_cuda.launches == before + 1
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    assert float((x - ref).abs().max() / ref.abs().max()) <= tol


def test_btsolve_kernel_refuses_unbuilt_block_size(cuda):
    """n 8 has no instantiation (n 4, which this test used before, is the
    cos/sin pendulum's and is built)."""
    D, O, b = _system(4, 3, 8, torch.float32, cuda)
    with pytest.raises(ValueError):
        btsolve_cuda.batched_factor_solve(D, O, b)


# every (dtype, n, T, layout) K1 takes: the on-chip layouts at their built
# shapes, the streaming layout at each of them and at every block size, the
# warp layout at its block size over horizons (T 1: no off-diagonal block)
K1_CASES = sorted({(dt, n, T, lay)
                   for dt, shapes in btsolve_cuda.ONCHIP_SHAPES.items()
                   for n, T in shapes
                   for lay in ("onchip", "stream")}
                  | {(dt, n, 5, "stream") for dt in K1_TOL
                     for n in btsolve_cuda.BLOCK_SIZES}
                  # the cartpoles' shapes at T 10 (n 5 cp1, n 7 cp2)
                  | {(dt, n, 10, "stream") for dt in K1_TOL
                     for n in (5, 7)}
                  | {(dt, n, T, "warp") for dt in K1_TOL
                     for n in btsolve_cuda.WARP_SIZES for T in (1, 5)},
                  key=str)


@pytest.mark.parametrize("dtype,n,T,layout", K1_CASES, ids=str)
def test_btsolve_layouts_match_plain(cuda, dtype, n, T, layout):
    D, O, b = _system(100, T, n, dtype, cuda, seed=n + T)
    before = btsolve_cuda.launches
    x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout=layout)
    assert btsolve_cuda.launches == before + 1
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    assert bool(torch.isfinite(x).all())
    assert float((x - ref).abs().max() / ref.abs().max()) <= K1_TOL[dtype]


@pytest.mark.parametrize("dtype", list(K1_TOL))
def test_btsolve_layouts_bit_identical(cuda, dtype):
    """The on-chip layout keeps the streaming kernel's arithmetic and its
    order, so the two agree to the bit."""
    D, O, b = _system(300, 5, 3, dtype, cuda, seed=1)
    x_on = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout="onchip")
    x_st = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout="stream")
    assert torch.equal(x_on, x_st)


def test_btsolve_onchip_refuses_unbuilt_shape(cuda):
    D, O, b = _system(4, 5, 7, torch.float32, cuda)
    with pytest.raises(ValueError):
        btsolve_cuda.batched_factor_solve(D, O, b, layout="onchip")


@pytest.mark.parametrize("dtype,compute,T", [
    (torch.float32, torch.float32, 5), (torch.float32, torch.float64, 5),
    (torch.float32, torch.float64, 10), (torch.float64, torch.float64, 5),
    (torch.float64, torch.float64, 10)])
def test_btsolve_warp_compute_types(cuda, dtype, compute, T):
    """The warp layout at n 16 in each compute type against the plain
    version computing in that type on the same inputs (K1_TOL of the input
    dtype: at T 10 these systems leave a float32 solve 1.7e-4 off the
    float64 one, so a float64 computation is held to the float64
    solution); one launch, counted in both counts."""
    D, O, b = _system(100, T, 16, dtype, cuda, seed=7)
    before = (btsolve_cuda.launches, btsolve_cuda.warp_launches)
    x = btsolve_cuda._launch(D, O, b, 1e-7, "warp", compute)
    assert (btsolve_cuda.launches, btsolve_cuda.warp_launches) == (
        before[0] + 1, before[1] + 1)
    ref = btsolve.batched_factor_solve(
        *(a.to(compute) for a in (D, O, b)), 1e-7).to(dtype)
    assert bool(torch.isfinite(x).all())
    assert float((x - ref).abs().max() / ref.abs().max()) <= K1_TOL[dtype]


def test_btsolve_warp_shared_memory(cuda):
    """An element's D, O and b in shared memory, rows padded to n + 1: the
    sizes at n 16, two elements a block (warp_block_bytes alike); at a T
    whose block asks for more than the device allows, the rule takes the
    streaming kernel, and the warp layout forced there is refused at
    launch, and nothing launches."""
    n = 16
    for T in (1, 5, 10):
        for dtype, compute, size in ((torch.float32, torch.float32, 4),
                                     (torch.float32, torch.float64, 8),
                                     (torch.float64, torch.float64, 8)):
            sm = btsolve_cuda.warp_smem(dtype, T, n, cuda, compute)
            words = (2 * T - 1) * n * (n + 1) + T * n
            assert sm["per_element"] == words * size
            assert sm["per_block"] == 2 * words * size
            assert sm["per_block"] == btsolve_cuda.warp_block_bytes(
                T, n, compute)
            assert sm["per_block"] <= sm["device_max"]
    sm = btsolve_cuda.warp_smem(torch.float64, 30, n, cuda)
    assert sm["per_block"] > sm["device_max"]
    for dtype in (torch.float32, torch.float64):
        assert btsolve_cuda.choose_layout(dtype, n, 30,
                                          sm["device_max"]) == "stream"
        D, O, b = _system(2, 30, n, dtype, cuda)
        before = (btsolve_cuda.launches, btsolve_cuda.warp_launches)
        x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7)
        assert (btsolve_cuda.launches, btsolve_cuda.warp_launches) == (
            before[0] + 1, before[1])
        # the streaming kernel computes n 16 in float64 (csrc/btsolve.cu's
        # Compute), so it is held to the plain version computing in float64:
        # at T 30 these systems leave a float32 solve 3.5e-4 off that one
        ref = btsolve.batched_factor_solve(
            *(a.double() for a in (D, O, b)), 1e-7).to(dtype)
        assert bool(torch.isfinite(x).all())
        assert float((x - ref).abs().max() / ref.abs().max()) <= \
            K1_TOL[dtype]
    before = btsolve_cuda.launches
    with pytest.raises(RuntimeError, match="warp"):
        btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout="warp")
    assert btsolve_cuda.launches == before


def test_btsolve_warp_refuses_unbuilt(cuda):
    """The warp layout at a block size without an instantiation, and a
    float32 computation of float64 inputs, raise before any launch."""
    before = btsolve_cuda.launches
    D, O, b = _system(4, 5, 3, torch.float32, cuda)
    with pytest.raises(ValueError):
        btsolve_cuda.batched_factor_solve(D, O, b, layout="warp")
    D, O, b = _system(4, 5, 16, torch.float64, cuda)
    with pytest.raises(ValueError):
        btsolve_cuda._launch(D, O, b, 0.0, None, torch.float32)
    with pytest.raises(ValueError):
        btsolve_cuda._launch(D, O, b, 0.0, "stream", torch.float64)
    assert btsolve_cuda.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-2),
                                       (torch.float64, 1e-6)])
def test_al_fused_kernel_matches_plain(cuda, dtype, tol):
    B, T = 100, 5
    rng = np.random.RandomState(0)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, 2), axis=1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, 3)).copy()
    c = -Cd * np.concatenate([x_ref, np.zeros((B, T, 1))], -1)
    to = lambda a: torch.tensor(a, dtype=dtype, device=cuda)
    args = (Pendulum(), to(Cd), to(c), to(x0), (-3.0,), (3.0,), to(x_ref),
            torch.zeros(B, T, 1, dtype=dtype, device=cuda))
    kw = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)
    before = al_fused_cuda.launches
    out = al_fused_cuda.fused_al_solve(*args, **kw)
    assert al_fused_cuda.launches == before + 1
    ref = al_fused_cuda.fused_al_solve_reference(*args, **kw)
    for i in (0, 4):  # xu and res, as chip_smoke.py checks them
        assert float((out[i] - ref[i]).abs().max()) <= tol


K2_TOL = {torch.float32: 1e-2, torch.float64: 1e-6}
K2_KW = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)


def _k2_args(B, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    T = 5
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, 2), axis=1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, 3)).copy()
    c = -Cd * np.concatenate([x_ref, np.zeros((B, T, 1))], -1)
    to = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return (Pendulum(), to(Cd), to(c), to(x0), (-3.0,), (3.0,), to(x_ref),
            torch.zeros(B, T, 1, dtype=dtype, device=device))


def _bits_equal(a, b):
    return all(torch.equal(x.view(torch.int64 if x.dtype == torch.float64
                                  else torch.int32),
                           y.view(torch.int64 if y.dtype == torch.float64
                                  else torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("B", [64, 256])
@pytest.mark.parametrize("group", al_fused_cuda.GROUPS[1:])
@pytest.mark.parametrize("dtype", list(K2_TOL))
def test_al_fused_groups_bit_identical(cuda, B, group, dtype):
    args = _k2_args(B, dtype, cuda, seed=B)
    ref = al_fused_cuda.fused_al_solve(*args, **K2_KW, group=1)
    out = al_fused_cuda.fused_al_solve(*args, **K2_KW, group=group)
    assert _bits_equal(out, ref)


@pytest.mark.parametrize("dtype", list(K2_TOL))
def test_al_fused_groups_tie_case(cuda, dtype):
    """Newton direction 0 (x0 = 0, c = 0, zero warm start): every candidate
    ties with the incumbent, no step is taken at any G."""
    B, T = 64, 5
    Cd = torch.tensor([10.0, 1.0, 0.01], dtype=dtype,
                      device=cuda).expand(B, T, 3).contiguous()
    z = lambda *s: torch.zeros(s, dtype=dtype, device=cuda)
    args = (Pendulum(), Cd, z(B, T, 3), z(B, 2), (-3.0,), (3.0,),
            z(B, T, 2), z(B, T, 1))
    outs = [al_fused_cuda.fused_al_solve(*args, **K2_KW, group=G)
            for G in al_fused_cuda.GROUPS]
    for out in outs[1:]:
        assert _bits_equal(out, outs[0])
    assert float(outs[0][0].abs().max()) == 0.0


# K2 at G 32 puts two elements in a block of 64 threads and at G 8 eight:
# B 1, 65, 129 leave the last block partly empty at every G, and B 3 at G
# 8 or 16 leaves lanes of the last warp without a group
@pytest.mark.parametrize("B", (1, 3, 65, 129))
@pytest.mark.parametrize("group", [None, 8, 16, 32])
@pytest.mark.parametrize("dtype", list(K2_TOL))
def test_al_fused_kernel_edge_batches(cuda, B, group, dtype):
    args = _k2_args(B, dtype, cuda, seed=B)
    out = al_fused_cuda.fused_al_solve(*args, **K2_KW, group=group)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **K2_KW)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    for i in (0, 4):
        assert float((out[i] - ref[i]).abs().max()) <= K2_TOL[dtype]
    assert _bits_equal(out, al_fused_cuda.fused_al_solve(*args, **K2_KW,
                                                         group=1))


def test_al_fused_refuses_unbuilt_group(cuda):
    args = _k2_args(4, torch.float32, cuda)
    with pytest.raises(ValueError):
        al_fused_cuda.fused_al_solve(*args, group=3)


@pytest.mark.parametrize("dtype,T", [(torch.float32, 5),
                                     (torch.float32, 10),
                                     (torch.float64, 5)])
def test_al_fused_group_rule_on_card(cuda, dtype, T):
    """The occupancy query gives whole blocks of 64 on every SM at every G,
    and the rule's G fits the batch into them (or is 1)."""
    resident = al_fused_cuda.resident_threads(dtype, T, cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sorted(resident) == sorted(al_fused_cuda.GROUPS)
    for threads in resident.values():
        assert threads > 0 and threads % (64 * sms) == 0
    for B in (1, 64, 256, 4096, 262144):
        G = al_fused_cuda.choose_group(B, resident)
        assert G == 1 or B * G <= resident[G]


def test_solve_fused_stateful_launches_once_per_al_iteration(cuda):
    B, T = 8, 5
    cost = DiagQuadCost(
        Cd=torch.tensor([10.0, 1.0, 0.01], device=cuda).expand(B, T, 3),
        c=torch.zeros(B, T, 3, device=cuda))
    st = ALState.init(B, T, 2, 1, dtype=torch.float32, device=cuda)
    before = al_fused_cuda.launches
    x, u, st, stats = al_mpc.solve_fused_stateful(
        Pendulum(), cost, torch.full((B, 2), 0.2, device=cuda),
        Bounds(u_lo=(-3.0,), u_hi=(3.0,)), st, al_mpc.ALConfig())
    assert al_fused_cuda.launches == before + 2
    assert torch.isfinite(x).all() and torch.isfinite(stats.dyn_res).all()


def _lqr_problem(B, T, nx, nu, dtype, device, seed=0):
    """Random LQR-KKT system with SPD stage costs (K3's inputs)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T, nx, nx)
    Mu = rng.randn(B, T, nu, nu)
    arrays = (M @ M.transpose(0, 1, 3, 2) + np.eye(nx),
              0.2 * rng.randn(B, T, nx, nu),
              Mu @ Mu.transpose(0, 1, 3, 2) + np.eye(nu),
              rng.randn(B, T, nx), rng.randn(B, T, nu),
              np.eye(nx) + 0.1 * rng.randn(B, T - 1, nx, nx),
              0.2 * rng.randn(B, T - 1, nx, nu),
              0.1 * rng.randn(B, T - 1, nx), rng.randn(B, nx))
    return [torch.tensor(a, dtype=dtype, device=device) for a in arrays]


@pytest.mark.parametrize("T,nx,nu", riccati_cuda.BUILT)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_riccati_kernel_matches_plain(cuda, T, nx, nu, dtype, tol):
    args = _lqr_problem(100, T, nx, nu, dtype, cuda, seed=nx)
    before = riccati_cuda.launches
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    assert riccati_cuda.launches == before + 1
    ref = riccati.batched_lqr_kkt_solve(*args, 1e-9)
    for got, want in zip(out, (ref.dx, ref.du, ref.lam)):
        assert float((got - want).abs().max() / want.abs().max()) <= tol


# K3 runs one thread per element in blocks of 128, K4 in blocks of 64: one
# element alone, and one more than a block of either (65, 129), leave the
# last block ragged.
EDGE_BATCHES = (1, 65, 129)
# Element isolation: (batch, poisoned elements). 264 = 2·128 + 8 = 4·64 + 8
# puts element 263 in a ragged last block of either kernel, beside 5 in a
# full one.
ISOLATION_CASES = [(40, (5,)), (264, (5, 263))]


def _unpoisoned(B, poisoned, device):
    keep = torch.ones(B, dtype=torch.bool, device=device)
    keep[list(poisoned)] = False
    return keep


# the block size each K1 layout's edge and isolation tests take
K1_LAYOUT_N = {"onchip": 3, "stream": 3, "warp": 16}


@pytest.mark.parametrize("B", EDGE_BATCHES)
@pytest.mark.parametrize("layout", btsolve_cuda.LAYOUTS)
@pytest.mark.parametrize("dtype", list(K1_TOL))
def test_btsolve_kernel_edge_batches(cuda, B, layout, dtype):
    D, O, b = _system(B, 5, K1_LAYOUT_N[layout], dtype, cuda, seed=B)
    x = btsolve_cuda.batched_factor_solve(D, O, b, 1e-7, layout=layout)
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    assert bool(torch.isfinite(x).all())
    assert float((x - ref).abs().max() / ref.abs().max()) <= K1_TOL[dtype]


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("layout", btsolve_cuda.LAYOUTS)
def test_btsolve_kernel_isolates_elements(cuda, B, poisoned, poison, layout):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical."""
    args = _system(B, 5, K1_LAYOUT_N[layout], torch.float32, cuda, seed=3)
    clean = btsolve_cuda.batched_factor_solve(*args, 1e-7, layout=layout)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = btsolve_cuda.batched_factor_solve(*bad, 1e-7, layout=layout)
    keep = _unpoisoned(B, poisoned, cuda)
    assert torch.equal(clean[keep], dirty[keep])


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("group", [None, 8, 32])
def test_al_fused_kernel_isolates_elements(cuda, B, poisoned, poison, group):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical, whatever the group width."""
    model, *arrays, = _k2_args(B, torch.float32, cuda, seed=4)
    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    box = ((-3.0,), (3.0,))

    def run(ts):
        Cd, c, x0, xi, ui = ts
        return al_fused_cuda.fused_al_solve(model, Cd, c, x0, *box, xi, ui,
                                            **K2_KW, group=group)

    clean = run(tensors)
    bad = [a.clone() for a in tensors]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = run(bad)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


@pytest.mark.parametrize("B", EDGE_BATCHES)
@pytest.mark.parametrize("T,nx,nu", riccati_cuda.BUILT)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_riccati_kernel_edge_batches(cuda, B, T, nx, nu, dtype, tol):
    args = _lqr_problem(B, T, nx, nu, dtype, cuda, seed=B)
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    ref = riccati.batched_lqr_kkt_solve(*args, 1e-9)
    for got, want in zip(out, (ref.dx, ref.du, ref.lam)):
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max() / want.abs().max()) <= tol


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("T,nx,nu", riccati_cuda.BUILT)
def test_riccati_kernel_isolates_elements(cuda, B, poisoned, poison, T, nx,
                                          nu):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical."""
    args = _lqr_problem(B, T, nx, nu, torch.float32, cuda, seed=nx)
    clean = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = riccati_cuda.batched_lqr_kkt_solve(*bad, 1e-9)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


def test_riccati_kernel_refuses_unbuilt_size(cuda):
    """A shape neither K3 kernel is built for raises: (nx, nu) = (3, 1)
    at T 4 (since the horizon kernel takes (2, 1) at any T, the shape this
    test used before is now served)."""
    args = _lqr_problem(4, 4, 3, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        riccati_cuda.batched_lqr_kkt_solve(*args)
    before = (riccati_cuda.launches, riccati_cuda.horizon_launches)
    riccati_cuda.batched_lqr_kkt_solve(
        *_lqr_problem(4, 4, 2, 1, torch.float32, cuda))
    assert (riccati_cuda.launches, riccati_cuda.horizon_launches) == (
        before[0], before[1] + 1)


# the MPC expert planners' (T, nx, nu) (learning/datagen.py), which the
# horizon kernel serves
HORIZON_SHAPES = [(10, 6, 1), (20, 2, 1), (30, 2, 1), (40, 2, 1),
                  (60, 4, 1), (80, 4, 1), (120, 6, 1), (20, 12, 4),
                  # T 5 where the unrolled kernel lacks the shape: the
                  # quadrotor's ip path, CartpoleCosSin's, and the
                  # slew-augmented cp1, cp2 and quadrotor
                  (5, 12, 4), (5, 5, 1), (5, 7, 1), (5, 16, 4)]


def _horizon_errors(out, args):
    """(kernel vs the float64 solution, plain float32 vs it) relative to
    the float64 solution's largest entry, or (kernel vs plain, 0) in
    float64."""
    plain = riccati.batched_lqr_kkt_solve(*args, 1e-9)
    plain = (plain.dx, plain.du, plain.lam)
    if args[0].dtype == torch.float64:
        ref = plain
    else:
        ref = riccati.batched_lqr_kkt_solve(*(a.double() for a in args),
                                            1e-9)
        ref = (ref.dx, ref.du, ref.lam)
    rel = lambda got: max(float((g.double() - w).abs().max()
                                / w.abs().max()) for g, w in zip(got, ref))
    return rel(out), (rel(plain) if args[0].dtype == torch.float32 else 0.0)


@pytest.mark.parametrize("T,nx,nu", HORIZON_SHAPES)
@pytest.mark.parametrize("B", [64, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_riccati_horizon_kernel_matches_plain(cuda, T, nx, nu, B, dtype):
    """The horizon kernel at every planner shape: float64 within 1e-10 of
    the plain version; float32 against the float64 solution, within
    F32_VS_F64_RATIO of the plain float32 version's error (or 1e-4)."""
    args = _lqr_problem(B, T, nx, nu, dtype, cuda, seed=T + nx)
    before = (riccati_cuda.launches, riccati_cuda.horizon_launches)
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    assert (riccati_cuda.launches, riccati_cuda.horizon_launches) == (
        before[0], before[1] + 1)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    err, plain_err = _horizon_errors(out, args)
    if dtype == torch.float64:
        assert err <= 1e-10
    else:
        assert err <= max(1e-4, F32_VS_F64_RATIO * plain_err)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.float64, 1e-10)])
def test_riccati_horizon_kernel_matches_unrolled_at_T5(cuda, dtype, tol):
    """At (5, 6, 1), where the unrolled kernel serves, the horizon kernel
    built for (6, 1) (launched by name, as chip_smoke.py times it) solves
    the same systems alike."""
    args = _lqr_problem(100, 5, 6, 1, dtype, cuda, seed=6)
    unrolled = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    before = riccati_cuda.horizon_launches
    horizon = riccati_cuda._launch(args, 1e-9, "riccati_horizon_warp")
    assert riccati_cuda.horizon_launches == before + 1
    for a, b in zip(horizon, unrolled):
        assert float((a - b).abs().max() / b.abs().max()) <= tol


def test_queued_events_time_one_kernel(cuda):
    """timing.queued_events_ms brackets the kernel's device work: positive,
    and no more than the back-to-back events' time per call, which also
    holds each call's host launch."""
    from diff_qp_mpc_tpu_torch.benchmarks import timing

    args = _lqr_problem(64, 20, 2, 1, torch.float32, cuda)
    kern = lambda: riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    ms = timing.queued_events_ms(kern, 10)
    assert 0.0 < ms <= 1.5 * timing.events_ms(kern, 10)


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("T,nx,nu", [(10, 6, 1), (20, 12, 4)])
def test_riccati_horizon_kernel_isolates_elements(cuda, B, poisoned, T, nx,
                                                  nu):
    """A non-finite input of some elements leaves every other element's
    outputs bit-identical (the workspace is per element)."""
    args = _lqr_problem(B, T, nx, nu, torch.float32, cuda, seed=nx)
    clean = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = float("nan")
    dirty = riccati_cuda.batched_lqr_kkt_solve(*bad, 1e-9)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


# K3's horizon kernel on the warp layout (csrc/riccati_horizon_warp.cu):
# the quadrotor's ip and expert shapes and its slew shape
K3_WARP_SHAPES = [(5, 12, 4), (20, 12, 4), (5, 16, 4)]


@pytest.mark.parametrize("T,nx,nu", K3_WARP_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_riccati_horizon_warp_matches_plain(cuda, T, nx, nu, dtype):
    """The shapes of HORIZON_WARP_BUILT route to the warp layout (one warp
    an element, counted in horizon_launches):
    float64 within 1e-10 of the plain version; float32 against the float64
    solution within F32_VS_F64_RATIO of the plain float32 version's error
    (or 1e-4)."""
    assert riccati_cuda.kernel_for(T, nx, nu) == "riccati_horizon_warp"
    args = _lqr_problem(64, T, nx, nu, dtype, cuda, seed=T + nx + 1)
    before = (riccati_cuda.launches, riccati_cuda.horizon_launches)
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    assert (riccati_cuda.launches, riccati_cuda.horizon_launches) == (
        before[0], before[1] + 1)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    err, plain_err = _horizon_errors(out, args)
    if dtype == torch.float64:
        assert err <= 1e-10
    else:
        assert err <= max(1e-4, F32_VS_F64_RATIO * plain_err)


# one warp per element, two a block: one element alone, a ragged last
# block (33), and one more than 64
@pytest.mark.parametrize("B", [1, 33, 65])
@pytest.mark.parametrize("T,nx,nu", [(20, 12, 4), (5, 16, 4)])
def test_riccati_horizon_warp_edge_batches(cuda, B, T, nx, nu):
    args = _lqr_problem(B, T, nx, nu, torch.float64, cuda, seed=B)
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert _horizon_errors(out, args)[0] <= 1e-10


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
def test_riccati_horizon_warp_isolates_elements(cuda, B, poisoned, poison):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical (each warp its own shared memory and
    workspace)."""
    args = _lqr_problem(B, 5, 16, 4, torch.float32, cuda, seed=16)
    clean = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = riccati_cuda.batched_lqr_kkt_solve(*bad, 1e-9)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


def test_riccati_horizon_warp_shared_memory(cuda):
    """Each instantiation's block fits the device, an element holds at
    least its stage's blocks, P and p, and the size does not depend on
    T."""
    for nx, nu in riccati_cuda.HORIZON_WARP_BUILT:
        for dtype in (torch.float32, torch.float64):
            sm = riccati_cuda.warp_smem(dtype, nx, nu, cuda)
            stage = (2 * nx * nx + 2 * nx * nu + nu * nu + 3 * nx + nu
                     + nx * nx + nx)
            assert sm["per_element"] >= stage * dtype.itemsize
            assert sm["per_block"] <= sm["device_max"]


def test_riccati_horizon_warp_refuses_unbuilt(cuda):
    """The warp layout cannot be launched, or its shared memory asked, at
    an (nx, nu) it has no instantiation for."""
    args = _lqr_problem(4, 5, 3, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="not built"):
        riccati_cuda._launch(args, 1e-9, "riccati_horizon_warp")
    with pytest.raises(ValueError, match="not built"):
        riccati_cuda.warp_smem(torch.float32, 3, 1, cuda)


# the one-control shapes that the warp-layout horizon kernel took over from
# the one-thread kernel (riccati_cuda.kernel_for)
K3_MOVED_SHAPES = [s for s in HORIZON_SHAPES if s[2] == 1
                   and riccati_cuda.kernel_for(*s) == "riccati_horizon_warp"]


@pytest.mark.parametrize("T,nx,nu", K3_MOVED_SHAPES)
@pytest.mark.parametrize("B", [8, 64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_riccati_horizon_warp_moved_shapes_match_plain(cuda, T, nx, nu, B,
                                                       dtype):
    """The warp layout at the one-control planner and slew shapes, each
    launch counted in horizon_launches: float64
    within 1e-13 of the plain version (relative to each output's largest
    entry); float32 against the float64 solution within F32_VS_F64_RATIO
    of the plain float32 version's error."""
    args = _lqr_problem(B, T, nx, nu, dtype, cuda, seed=T + nx + B)
    before = riccati_cuda.horizon_launches
    out = riccati_cuda.batched_lqr_kkt_solve(*args, 1e-9)
    assert riccati_cuda.horizon_launches == before + 1
    assert all(bool(torch.isfinite(o).all()) for o in out)
    err, plain_err = _horizon_errors(out, args)
    if dtype == torch.float64:
        assert err <= 1e-13
    else:
        assert err <= F32_VS_F64_RATIO * plain_err


def _trajqp_problem(B, T, nx, nu, dtype, device, seed=0):
    """Random box-constrained trajectory QP (tests/test_trajqp_fused.py's
    inputs) and a cold start: u at the box midpoint, x its rollout."""
    n = nx + nu
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T, n, n)
    arrays = (0.1 * M @ M.transpose(0, 1, 3, 2) + np.eye(n),
              0.3 * rng.randn(B, T, n),
              np.eye(nx) + 0.1 * rng.randn(B, T - 1, nx, nx),
              0.3 * rng.randn(B, T - 1, nx, nu),
              0.1 * rng.randn(B, T - 1, nx), 0.5 * rng.randn(B, nx))
    C, c, A, Bm, f, x0 = (torch.tensor(a, dtype=dtype, device=device)
                          for a in arrays)
    xs = [x0]
    for t in range(T - 1):  # u = 0
        xs.append((A[:, t] @ xs[-1][..., None])[..., 0] + f[:, t])
    return (C, c, A, Bm, f, x0, torch.stack(xs, 1),
            torch.zeros(B, T, nu, dtype=dtype, device=device))


@pytest.mark.parametrize("T,nx,nu", trajqp_fused_cuda.BUILT)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-8)])
def test_trajqp_fused_kernel_matches_plain(cuda, T, nx, nu, dtype, tol):
    args = _trajqp_problem(100, T, nx, nu, dtype, cuda, seed=nx)
    box = ((-1.5,) * nu, (1.5,) * nu)
    before = trajqp_fused_cuda.launches
    out = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    assert trajqp_fused_cuda.launches == before + 1
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args, *box)
    # all eight outputs (x, u, λ, z_hi, z_lo, s_hi, s_lo, resids), each
    # error over max(1, the field's largest entry), as chip_smoke.py
    names = ("x", "u", "lam", "z_hi", "z_lo", "s_hi", "s_lo", "resids")
    assert len(out) == len(ref) == len(names)
    for name, got, want in zip(names, out, ref):
        assert bool(torch.isfinite(got).all()), name
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) / scale <= tol, name
    assert float(out[1].abs().max()) <= 1.5 + 1e-4


def _trajqp_errors(out, ref):
    """Per output, max |out − ref| over max(1, max |ref|)."""
    return [float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
            for g, w in zip(out, ref)]


@pytest.mark.parametrize("B", EDGE_BATCHES)
@pytest.mark.parametrize("T,nx,nu", trajqp_fused_cuda.BUILT)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.float64, 1e-8)])
def test_trajqp_fused_kernel_edge_batches(cuda, B, T, nx, nu, dtype, tol):
    args = _trajqp_problem(B, T, nx, nu, dtype, cuda, seed=B)
    box = ((-1.5,) * nu, (1.5,) * nu)
    out = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args, *box)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert max(_trajqp_errors(out, ref)) <= tol


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("T,nx,nu", trajqp_fused_cuda.BUILT)
def test_trajqp_fused_kernel_isolates_elements(cuda, B, poisoned, poison, T,
                                               nx, nu):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical."""
    args = _trajqp_problem(B, T, nx, nu, torch.float32, cuda, seed=nx)
    box = ((-1.5,) * nu, (1.5,) * nu)
    clean = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = trajqp_fused_cuda.fused_trajqp_solve(*bad, *box)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


def test_trajqp_fused_kernel_refuses_unbuilt_size(cuda):
    args = _trajqp_problem(4, 5, 2, 2, torch.float32, cuda)
    with pytest.raises(ValueError):
        trajqp_fused_cuda.fused_trajqp_solve(*args, (-1.0,) * 2, (1.0,) * 2)


@pytest.mark.parametrize("n_streams", [1, 3, 8])
def test_sin_chain_kernel_matches_plain(cuda, n_streams):
    """K5 on 64 tiles, 256 sins, inputs in (0.1, 0.9); 1e-5 absolute as
    chip_smoke.py holds it (sin is contractive on (0, 1], so per-step ulp
    differences do not grow)."""
    rng = np.random.RandomState(n_streams)
    x = torch.tensor(rng.uniform(0.1, 0.9, (64, n_streams, 8, 128)),
                     dtype=torch.float32, device=cuda)
    before = sin_chain_cuda.launches
    out = sin_chain_cuda.sin_chain(x, 256)
    assert sin_chain_cuda.launches == before + 1
    ref = sin_chain_cuda.sin_chain_reference(x, 256)
    assert out.shape == (64, 8, 128)
    assert float((out - ref).abs().max()) <= 1e-5


def test_sin_chain_kernel_refuses_unbuilt_streams(cuda):
    x = torch.full((2, 9, 8, 128), 0.5, device=cuda)
    with pytest.raises(ValueError):
        sin_chain_cuda.sin_chain(x, 4)


# ----------------------------------------------- implicit backwards ----
def test_k1_on_al_newton_systems(cuda):
    """K1 float32 on the AL path's own Newton systems (ρ 1 … 1e6, reg 1e-7,
    B 4096), gradient and cotangent right-hand sides: its error from the
    float64 solution within K1_AL_RATIO of the plain float32 version's
    (``k1_al_systems`` raises otherwise)."""
    from diff_qp_mpc_tpu_torch.benchmarks import kernel_layouts

    rows = kernel_layouts.k1_al_systems()
    assert len(rows) == 2 * len(kernel_layouts.K1_AL_RHOS)
    for r in rows:
        assert r["max_rel_err_kernel"] <= (kernel_layouts.K1_AL_RATIO
                                           * r["max_rel_err_plain"])


def test_k1_on_cp1_al_newton_systems(cuda):
    """As above on cp1's own AL Newton systems (T 10, n 5, B 256), the
    shape of cp1's scan closed loop and of its fused training's
    backward."""
    from diff_qp_mpc_tpu_torch.benchmarks import kernel_layouts

    rows = kernel_layouts.k1_al_systems(B=256, model_name="cartpole1l",
                                        T_=10)
    assert {(r["n"], r["T"]) for r in rows} == {(5, 10)}
    for r in rows:
        assert r["max_rel_err_kernel"] <= (kernel_layouts.K1_AL_RATIO
                                           * r["max_rel_err_plain"])


def _tracking_cost(B, T, device, seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, 2), axis=1)
    ref = np.concatenate([ref, 0.5 * rng.randn(B, T, 1)], -1)
    to = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return to(x0), to(ref), to(rng.randn(B, T, 3))


@pytest.mark.parametrize("path", ["solve", "fused", "fused_stateful"])
def test_al_backward_is_one_k1_launch(cuda, path):
    """A differentiable AL solve on the card: the backward launches K1 once
    and its float64 gradient matches the CPU's (plain versions) to 1e-6
    relative, the forward's own near-tie spread."""
    B, T = 16, 5
    grads = []
    for device in ("cpu", "cuda"):
        x0, ref, W = (a.to(device) for a in _tracking_cost(B, T, cuda))
        ref.requires_grad_()
        Cd = torch.tensor([10.0, 1.0, 0.01], dtype=torch.float64,
                          device=device).expand(B, T, 3)
        cost = DiagQuadCost(Cd=Cd, c=-Cd * ref)
        st = ALState.init(B, T, 2, 1, dtype=torch.float64, device=device)
        bounds = Bounds(u_lo=(-3.0,), u_hi=(3.0,))
        cfg = al_mpc.ALConfig()
        if path == "solve":
            bounds = Bounds(u_lo=torch.tensor([-3.0], dtype=torch.float64,
                                              device=device),
                            u_hi=torch.tensor([3.0], dtype=torch.float64,
                                              device=device))
            x, u, _, _ = al_mpc.solve(Pendulum(), cost, x0, bounds, st, cfg)
        elif path == "fused":
            x, u, _ = al_mpc.solve_fused(Pendulum(), cost, x0, bounds, cfg)
        else:
            x, u, _, _ = al_mpc.solve_fused_stateful(Pendulum(), cost, x0,
                                                     bounds, st, cfg)
        loss = (W * torch.cat([x, u], -1)).sum()
        before = btsolve_cuda.launches
        loss.backward()
        assert btsolve_cuda.launches == before + (device != "cpu")
        grads.append(ref.grad.cpu())
    err = float((grads[1] - grads[0]).abs().max() / grads[0].abs().max())
    assert err <= 1e-6


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_trajqp_layer_backward_is_one_k3_launch(cuda, kernel):
    """traj_qp_layer's backward on the card launches K3 once on both
    paths, and its float64 gradient w.r.t. (C, c, x0) matches the CPU's to
    1e-9 relative (the IPM and its backward are continuous)."""
    from diff_qp_mpc_tpu_torch.solvers import trajqp

    B, T = 16, 5
    grads = []
    for device in ("cpu", "cuda"):
        x0, ref, W = (a.to(device) for a in _tracking_cost(B, T, cuda,
                                                           seed=1))
        C = torch.diag_embed(torch.tensor(
            [10.0, 1.0, 0.01], dtype=torch.float64,
            device=device).expand(B, T, 3)).requires_grad_()
        c = (-10.0 * ref).requires_grad_()
        x0 = x0.requires_grad_()
        x_lin = ref[..., :2].detach()
        u_lin = ref[..., 2:].detach()
        x_next, A, Bm = Pendulum().linearize(x_lin, u_lin)
        f = x_next - (A @ x_lin[:, :-1, :, None])[..., 0] \
            - (Bm @ u_lin[:, :-1, :, None])[..., 0]
        if kernel == "fused":
            layer, bounds = trajqp.traj_qp_layer_static, Bounds(
                u_lo=(-3.0,), u_hi=(3.0,))
        else:
            layer = trajqp.traj_qp_layer
            bounds = Bounds(
                u_lo=torch.tensor([-3.0], dtype=torch.float64, device=device),
                u_hi=torch.tensor([3.0], dtype=torch.float64, device=device))
        w = layer(C, c, A.contiguous(), Bm.contiguous(), f.contiguous(), x0,
                  bounds, trajqp.TrajQPConfig(kernel=kernel))
        before = riccati_cuda.launches
        (W * w).sum().backward()
        assert riccati_cuda.launches == before + (device != "cpu")
        grads.append([a.grad.cpu() for a in (C, c, x0)])
    for g_cpu, g_card in zip(*grads):
        assert float((g_card - g_cpu).abs().max()
                     / g_cpu.abs().max()) <= 1e-9


# ------------------------------------ K2 on the integrator, cartpoles ----
# k2_models.problem: seeded tracking problems of each model's env; check
# raises unless the kernel agrees with its plain version (TOL per element,
# SHARE_LIMIT of elements outside it) and every G is bit-identical to G 1.
# The quadrotor's and the cartpoles' kernels run one warp per element (the
# "warp" layout, no group width): their own tests follow.
def _layout(name):
    return al_fused_cuda.built_for(k2_models.model(name)).layout


GROUP_MODELS = [name for name in k2_models.ENVS if _layout(name) == "group"]
GROUP_CASES = [c for c in k2_models.CASES if c[0] in GROUP_MODELS]
K2_MODEL_T5 = [(name, torch.float32) for name in GROUP_MODELS]


@pytest.mark.parametrize("name,T,dtype", GROUP_CASES, ids=str)
def test_al_fused_models_match_plain(cuda, name, T, dtype):
    """Every G of the group layout."""
    before = al_fused_cuda.launches
    row = k2_models.check(name, T, dtype, 64)
    assert al_fused_cuda.launches == before + len(al_fused_cuda.GROUPS)
    assert all(row["identical_to_g1"].values())


@pytest.mark.parametrize("B", (1, 3, 65))
@pytest.mark.parametrize("group", [None, 32])
@pytest.mark.parametrize("name,dtype", K2_MODEL_T5, ids=str)
def test_al_fused_models_edge_batches(cuda, name, dtype, B, group):
    args = k2_models.problem(name, B, 5, dtype, seed=B)
    out = al_fused_cuda.fused_al_solve(*args, **K2_KW, group=group)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **K2_KW)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    el = k2_models.element_errors(out, ref)
    # no element outside TOL at these batches but where the model's share
    # limit allows some (the CosSin models in float32)
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.share_limit(name, dtype)
    assert _bits_equal(out, al_fused_cuda.fused_al_solve(*args, **K2_KW,
                                                         group=1))


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("name", list(k2_models.ENVS))
def test_al_fused_models_isolate_elements(cuda, name, B, poisoned, poison):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical."""
    model, *rest = k2_models.problem(name, B, 5, torch.float32, seed=4)
    Cd, c, x0, u_lo, u_hi, xi, ui = rest

    def run(ts):
        Cd_, c_, x0_, xi_, ui_ = ts
        return al_fused_cuda.fused_al_solve(model, Cd_, c_, x0_, u_lo, u_hi,
                                            xi_, ui_, **K2_KW)

    clean = run([Cd, c, x0, xi, ui])
    bad = [a.clone() for a in (Cd, c, x0, xi, ui)]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = run(bad)
    keep = _unpoisoned(B, poisoned, cuda)
    for a, b in zip(clean, dirty):
        assert torch.equal(a[keep], b[keep])


def test_al_fused_refuses_unbuilt_models(cuda):
    """An unbuilt (model, T, dtype) or model raises; no kernel launches.
    (CartpoleCosSin, which this test refused before, is built.)"""
    from diff_qp_mpc_tpu_torch.models import Integrator

    before = al_fused_cuda.launches
    for name, T, dtype in (("cartpole1l", 10, torch.float64),
                           ("cartpole2l", 7, torch.float32),
                           ("cartpole2l", 10, torch.float64),
                           ("integrator", 10, torch.float32),
                           ("quadrotor", 10, torch.float32)):
        args = k2_models.problem(name, 4, T, dtype, seed=0)
        with pytest.raises(ValueError):
            al_fused_cuda.fused_al_solve(*args)
    args = list(k2_models.problem("integrator", 4, 5, torch.float32, 0))
    with pytest.raises(NotImplementedError):
        al_fused_cuda.fused_al_solve(Integrator(nx=4, nu=2), *args[1:])
    assert al_fused_cuda.launches == before


@pytest.mark.parametrize("name", list(k2_models.ENVS))
def test_solve_fused_stateful_models_launch_once_per_al_iteration(cuda,
                                                                  name):
    model, Cd, c, x0, u_lo, u_hi, xi, ui = k2_models.problem(
        name, 8, 5, torch.float32, seed=0)
    st = ALState.init(8, 5, model.nx, model.nu, dtype=torch.float32,
                      device=cuda)
    before = al_fused_cuda.launches
    x, u, st, stats = al_mpc.solve_fused_stateful(
        model, DiagQuadCost(Cd=Cd, c=c), x0, Bounds(u_lo=u_lo, u_hi=u_hi),
        st, al_mpc.ALConfig(al_iter=4))
    assert al_fused_cuda.launches == before + 4
    assert torch.isfinite(x).all() and torch.isfinite(stats.dyn_res).all()


def test_cartpole1l_f32_breakdown_through_k2(cuda):
    """The JAX package's float32 breakdown regression (its
    tests/test_al_fused.py, Cartpole1L at dt 0.01) through K2 on the warp
    layout: al_iter 8 with ρ up to 1e6, reg 1e-6. No NaN in the forward or
    in the gradient (one K1 launch), and dyn_res < 1e-4."""
    from diff_qp_mpc_tpu_torch.models import Cartpole1L

    B, T = 32, 5
    rng = np.random.RandomState(0)
    goal = np.array([0.0, np.pi, 0.0, 0.0, 0.0])
    x0 = torch.tensor(goal[None, :4] + rng.uniform(-0.05, 0.05, (B, 4)),
                      dtype=torch.float32, device=cuda)
    Cd = torch.tensor([1.0, 10.0, 0.1, 0.1, 1e-4], device=cuda).expand(B, T,
                                                                        5)
    c = (-Cd * torch.tensor(goal, dtype=torch.float32, device=cuda)
         ).clone().requires_grad_()
    cfg = al_mpc.ALConfig(al_iter=8, n_newton=4, n_ls=20, rho_max=1e6,
                          reg=1e-6)
    before = (al_fused_cuda.launches, btsolve_cuda.launches)
    x, u, res = al_mpc.solve_fused(
        Cartpole1L(), DiagQuadCost(Cd=Cd, c=c), x0,
        Bounds(u_lo=(-100.0,), u_hi=(100.0,)), cfg,
        u_init=torch.zeros(B, T, 1, device=cuda))
    (u ** 2).sum().backward()
    assert (al_fused_cuda.launches, btsolve_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(u).all() and torch.isfinite(c.grad).all()
    assert float(res.mean()) < 1e-4


# ------------------------------------ K2 on the cartpoles, warp layout ----
# al_fused_warp.cuh instantiated for Cartpole1L and Cartpole2L
# (csrc/al_fused_cartpole1l.cu, al_fused_cartpole2l.cu), which ran the
# group layout before; its sums over the warp and its upper solves run in
# another order, so it is held to the plain version as the group layout was
# (k2_models.TOL, the share limit), not to the group layout's bits. Each
# (T, dtype) runs at its table's warps per element (al_fused_cuda.BUILT).
CARTPOLES = ("cartpole1l", "cartpole2l")
CARTPOLE_CASES = [c for c in k2_models.CASES if c[0] in CARTPOLES]


def _warp_smem_values(nx, nu, T):
    """Values of WarpElement (al_fused_warp.cuh) but its line-search pick:
    Cd, cv, w, grad, d; x0; λ; G; f; L; S; the candidates' steps."""
    n = nx + nu
    return (5 * T * n + nx + (T - 1) * nx + 2 * T * nu
            + (T - 1) * nx * n + (T - 1) * nx + T * n * (n + 1) // 2
            + (T - 1) * n * n + 32 * (T - 1) * nx)


def _warp_smem_bytes(nx, nu, T, dtype):
    """sizeof(WarpElement): the values, then the pick (a value and an
    int), padded to the value's alignment."""
    size = dtype.itemsize
    raw = _warp_smem_values(nx, nu, T) * size + size + 4
    return -(-raw // size) * size


@pytest.mark.parametrize("B", (64, 128, 4096))
@pytest.mark.parametrize("name,T,dtype", CARTPOLE_CASES, ids=str)
def test_al_fused_cartpoles_warp_matches_plain(cuda, name, T, dtype, B):
    args = k2_models.problem(name, B, T, dtype, seed=B)
    before = al_fused_cuda.launches
    out = al_fused_cuda.fused_al_solve(*args, **K2_KW)
    assert al_fused_cuda.launches == before + 1
    ref = al_fused_cuda.fused_al_solve_reference(*args, **K2_KW)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    el = k2_models.element_errors(out, ref)
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.share_limit(name, dtype)
    assert float(el.median()) <= k2_models.MEDIAN_LIMIT[dtype]


@pytest.mark.parametrize("B", (1, 3, 65))
@pytest.mark.parametrize("name,T,dtype", CARTPOLE_CASES, ids=str)
def test_al_fused_cartpoles_warp_edge_batches(cuda, name, T, dtype, B):
    """The warp layout with one element, and with a ragged last block
    where two one-warp elements share a block; group None and 32
    alike."""
    args = k2_models.problem(name, B, T, dtype, seed=B)
    out = al_fused_cuda.fused_al_solve(*args, **K2_KW)
    ref = al_fused_cuda.fused_al_solve_reference(*args, **K2_KW)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    el = k2_models.element_errors(out, ref)
    assert float((el > k2_models.TOL[dtype]).double().mean()) <= \
        k2_models.share_limit(name, dtype)
    assert _bits_equal(out, al_fused_cuda.fused_al_solve(
        *args, **K2_KW, group=32))


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
@pytest.mark.parametrize("name", CARTPOLES)
def test_al_fused_cartpoles_warp_isolates_elements(cuda, name, B, poisoned,
                                                   poison):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical (each warp its own shared memory)."""
    model, *rest = k2_models.problem(name, B, 5, torch.float32, seed=4)
    Cd, c, x0, u_lo, u_hi, xi, ui = rest

    def run(ts):
        Cd_, c_, x0_, xi_, ui_ = ts
        return al_fused_cuda.fused_al_solve(model, Cd_, c_, x0_, u_lo, u_hi,
                                            xi_, ui_, **K2_KW)

    clean = run([Cd, c, x0, xi, ui])
    bad = [a.clone() for a in (Cd, c, x0, xi, ui)]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = run(bad)
    keep = _unpoisoned(B, poisoned, cuda)
    for a, b in zip(clean, dirty):
        assert torch.equal(a[keep], b[keep])


def test_al_fused_cartpoles_warp_shared_memory(cuda):
    """WarpElement's sizes (al_fused_warp.cuh) at the cartpoles' (nx, nu)
    and horizons, at the table's warps per element (two elements a block
    at one warp, one above), within what the card allows."""
    for name, T, dtype in CARTPOLE_CASES:
        model = k2_models.model(name)
        W = al_fused_cuda.built_for(model).warps
        size = _warp_smem_bytes(model.nx, model.nu, T, dtype)
        smem = al_fused_cuda.warp_smem(dtype, T, cuda, model)
        assert smem["per_element"] == size
        assert smem["per_block"] == (2 if W == 1 else 1) * size \
            <= smem["device_max"]


@pytest.mark.parametrize("name", CARTPOLES)
def test_al_fused_cartpoles_layout_rule_on_card(cuda, name):
    """Every launch of a cartpole takes the warp layout: group None or 32,
    whole warps per element; other group widths, and the group layout's
    occupancy query, are refused before any launch."""
    args = k2_models.problem(name, 4, 5, torch.float32, seed=0)
    before = al_fused_cuda.launches
    for group in (1, 8):
        with pytest.raises(ValueError, match="warps per element"):
            al_fused_cuda.fused_al_solve(*args, group=group)
    with pytest.raises(ValueError):
        al_fused_cuda.resident_threads(torch.float32, 5, cuda, args[0])
    assert al_fused_cuda.launches == before


# ------------------------------------------------ K2 on the quadrotor ----
@pytest.mark.parametrize("B", (1,) + k2_models.batches("quadrotor")
                         + (4096,))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_al_fused_quadrotor_matches_plain(cuda, B, dtype):
    """The warp layout, at its table's warps per element, against its
    plain version on hover problems at the checkpoint's budget, B 64 and
    128, the batch edges 1 and 65, and 4096: float64 every element within
    TOL; float32 the share of elements beyond TOL from the plain float64
    result within F32_SHARE_VS_F64. One launch."""
    before = al_fused_cuda.launches
    row = k2_models.check("quadrotor", 5, dtype, B)
    assert al_fused_cuda.launches == before + 1
    assert row["layout"] == "warp" and row["B"] == B


def test_al_fused_quadrotor_shared_memory(cuda):
    """An element's blocks in shared memory: the sizes of WarpElement
    (al_fused_warp.cuh) at nx 12, nu 4, T 5, at the table's warps per
    element (two elements a block at one warp, one above), within what the
    card allows a block."""
    from diff_qp_mpc_tpu_torch.models import RexQuadrotor

    model = RexQuadrotor()
    for dtype in (torch.float32, torch.float64):
        W = al_fused_cuda.built_for(model).warps
        size = _warp_smem_bytes(12, 4, 5, dtype)
        smem = al_fused_cuda.warp_smem(dtype, 5, cuda, model)
        assert smem["per_element"] == size
        assert smem["per_block"] == (2 if W == 1 else 1) * size
        assert smem["per_block"] <= smem["device_max"]


def test_al_fused_quadrotor_refuses_groups(cuda):
    from diff_qp_mpc_tpu_torch.models import RexQuadrotor

    args = k2_models.problem("quadrotor", 4, 5, torch.float32, seed=0)
    before = al_fused_cuda.launches
    for group in (1, 8):
        with pytest.raises(ValueError, match="warps per element"):
            al_fused_cuda.fused_al_solve(*args, group=group)
    with pytest.raises(ValueError):
        al_fused_cuda.resident_threads(torch.float32, 5, cuda,
                                       RexQuadrotor())
    assert al_fused_cuda.launches == before


def test_k1_warp_compute_rule_on_quadrotor_systems(cuda):
    """The rule that sets the warp layout's compute type for float32
    inputs (btsolve_cuda.WARP_COMPUTE), on the quadrotor's AL systems over
    K1_RULE_SEEDS draws at B 128: the type it takes meets K1_AL_RATIO on
    every draw; float32 is taken only if its computation does."""
    from diff_qp_mpc_tpu_torch.benchmarks import kernel_layouts

    out = kernel_layouts.k1_compute_rule()
    rule = btsolve_cuda.WARP_COMPUTE[torch.float32]
    assert out[str(rule)]["every_draw_within"]
    if rule == torch.float64:
        assert not out[str(torch.float32)]["every_draw_within"]


def test_k1_on_quadrotor_al_newton_systems(cuda):
    """K1 at n 16 in float32 on the quadrotor's own AL Newton systems (ρ 1
    … 1e4, reg 1e-7, B 128): within K1_AL_RATIO of the plain float32
    version's error against the float64 solution (raises otherwise)."""
    from diff_qp_mpc_tpu_torch.benchmarks import kernel_layouts

    rows = kernel_layouts.k1_al_systems(
        B=128, rhos=kernel_layouts.K1_QUAD_AL_RHOS, model_name="quadrotor",
        T_=5)
    assert {r["n"] for r in rows} == {16}
    assert len(rows) == 2 * len(kernel_layouts.K1_QUAD_AL_RHOS)


# ------- the slew path (K3 and K4 at (5, 3, 1)), the QP layer, SL1QP ----
def _slew_problem(B, dtype, device, seed=0):
    """Pendulum tracking problems (x0, x_ref, u_ref, Cd, c), as
    tests/test_torch_slew.py draws them."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, 5, 2), axis=1)
    x_ref[:, 0] = x0
    u_ref = 0.5 * rng.randn(B, 5, 1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, 5, 3)).copy()
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    return [torch.tensor(a, dtype=dtype, device=device)
            for a in (x0, x_ref, u_ref, Cd, c)]


def _counts():
    return (btsolve_cuda.launches, al_fused_cuda.launches,
            riccati_cuda.launches, riccati_cuda.horizon_launches,
            trajqp_fused_cuda.launches, sin_chain_cuda.launches,
            trajqp_fused_cuda.warp_launches)


def _slew_solve(device, kernel, prev, requires_grad=False):
    from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

    x0, x_ref, u_ref, Cd, c = _slew_problem(16, torch.float64, device)
    c.requires_grad_(requires_grad)
    bounds = (Bounds(u_lo=(-3.0,), u_hi=(3.0,)) if kernel == "fused" else
              Bounds(u_lo=torch.tensor([-3.0], dtype=torch.float64,
                                       device=device),
                     u_hi=torch.tensor([3.0], dtype=torch.float64,
                                       device=device)))
    prev_ctrl = (torch.full((16, 1), 0.5, dtype=torch.float64,
                            device=device) if prev else None)
    res = sqp_mpc.solve(
        Pendulum(), DiagQuadCost(Cd=Cd, c=c), x0, bounds, u_ref, x_ref,
        sqp_mpc.SQPConfig(qp_iter=2, qp=trajqp.TrajQPConfig(
            kernel=kernel, max_iter=12, reg=1e-9)),
        slew_rate_penalty=50.0, prev_ctrl=prev_ctrl)
    return res, c


@pytest.mark.parametrize("prev", [False, True])
@pytest.mark.parametrize("kernel,index,per_solve", [
    ("scan", 2, 3 * 12 * 2), ("fused", 4, 3)])
def test_slew_solve_runs_its_kernel_at_5_3_1(cuda, kernel, index,
                                             per_solve, prev):
    """sqp_mpc.solve with a slew penalty on the card: exactly (qp_iter + 1)
    × max_iter × 2 K3 launches (scan) or qp_iter + 1 K4 launches (fused)
    at (5, 3, 1) and no other kernel; the backward one K3 launch; u within
    1e-6 of the CPU's in float64 (the SQP tolerance)."""
    before = _counts()
    res, c = _slew_solve(cuda, kernel, prev, requires_grad=True)
    after = _counts()
    want = list(before)
    want[index] += per_solve
    assert after == tuple(want)
    res.u.sum().backward()
    assert riccati_cuda.launches == after[2] + 1
    ref, _ = _slew_solve(torch.device("cpu"), kernel, prev)
    assert float((res.u.detach().cpu() - ref.u).abs().max()) <= 1e-6


@pytest.mark.parametrize("solver", ["dense", "prefactor"])
def test_qp_layer_card_matches_cpu(cuda, solver):
    """The OptNet layer on the card in float64 against the CPU: z within
    1e-8 relative, the six gradients within 1e-6; no kernel of the
    repository is launched (the layer has none)."""
    from diff_qp_mpc_tpu_torch.benchmarks import prof_qp_sizes
    from diff_qp_mpc_tpu_torch.solvers.qp import QPConfig, qp_solve

    cfg = QPConfig(solver=solver)
    outs = []
    before = _counts()
    for device in (cuda, torch.device("cpu")):
        args = prof_qp_sizes.problem(8, 20, 20, 5, torch.float64, device)
        sol = qp_solve(*args, cfg)
        outs.append([sol.z] + list(prof_qp_sizes.forward_backward(
            args, cfg)[1:]))
    assert _counts() == before
    for got, want in zip(*outs):
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) / scale <= 1e-6


def test_sl1qp_launches_no_kernel(cuda):
    """SL1QP (the elastic Riccati recursion, plain PyTorch) launches none of
    K1-K5; its value on the card within 1e-6 of the CPU's in float64."""
    from diff_qp_mpc_tpu_torch.models import Integrator
    from diff_qp_mpc_tpu_torch.solvers import sl1qp_mpc

    outs = []
    before = _counts()
    for device in (cuda, torch.device("cpu")):
        kw = dict(dtype=torch.float64, device=device)
        x0 = torch.tensor(np.random.RandomState(0).randn(4, 2), **kw)
        Cd = torch.tensor([10.0, 10.0, 0.01], **kw).expand(4, 5, 3)
        res = sl1qp_mpc.solve(
            Integrator(nx=2, nu=1, dt=0.1),
            DiagQuadCost(Cd=Cd, c=torch.zeros(4, 5, 3, **kw)), x0,
            Bounds(u_lo=torch.tensor([-3.0], **kw),
                   u_hi=torch.tensor([3.0], **kw)),
            torch.zeros(4, 5, 1, **kw),
            cfg=sl1qp_mpc.SL1QPConfig(qp_iter=4, mu=100.0))
        outs.append(res.u.detach().cpu())
    assert _counts() == before
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-6


# ------------------------------------------- K4 on the warp layout ----
# One warp per element, its blocks in shared memory (csrc/
# trajqp_fused_warp.cu), at the cartpoles' shapes (5, 5, 1)-(5, 7, 1), the
# quadrotor's ip shape (5, 12, 4) and its slew shape (5, 16, 4). Its sums
# over the warp run in another order than the plain version's: float64
# within 1e-9 of each output's largest entry (or 1), float32 within 5e-3,
# as chip_smoke.py holds K4.
K4_WARP_TOL = {torch.float32: 5e-3, torch.float64: 1e-9}


@pytest.mark.parametrize("T,nx,nu", trajqp_fused_cuda.WARP_BUILT)
@pytest.mark.parametrize("dtype", list(K4_WARP_TOL))
def test_trajqp_fused_warp_matches_plain(cuda, T, nx, nu, dtype):
    args = _trajqp_problem(64, T, nx, nu, dtype, cuda, seed=nx)
    box = ((-1.5,) * nu, (1.5,) * nu)
    before = (trajqp_fused_cuda.launches, trajqp_fused_cuda.warp_launches)
    out = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    assert (trajqp_fused_cuda.launches, trajqp_fused_cuda.warp_launches) \
        == (before[0], before[1] + 1)
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args, *box)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    assert max(_trajqp_errors(out, ref)) <= K4_WARP_TOL[dtype]


@pytest.mark.parametrize("B", EDGE_BATCHES)
@pytest.mark.parametrize("T,nx,nu", trajqp_fused_cuda.WARP_BUILT)
def test_trajqp_fused_warp_edge_batches(cuda, B, T, nx, nu):
    args = _trajqp_problem(B, T, nx, nu, torch.float64, cuda, seed=B)
    box = ((-1.5,) * nu, (1.5,) * nu)
    out = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    ref = trajqp_fused_cuda.fused_trajqp_solve_reference(*args, *box)
    assert max(_trajqp_errors(out, ref)) <= K4_WARP_TOL[torch.float64]


@pytest.mark.parametrize("B,poisoned", ISOLATION_CASES)
@pytest.mark.parametrize("poison", [float("nan"), 1e30])
def test_trajqp_fused_warp_isolates_elements(cuda, B, poisoned, poison):
    """A non-finite or huge input of some elements leaves every other
    element's outputs bit-identical (each warp its own shared memory)."""
    args = _trajqp_problem(B, 5, 12, 4, torch.float32, cuda, seed=12)
    box = ((0.0,) * 4, (20.0,) * 4)
    clean = trajqp_fused_cuda.fused_trajqp_solve(*args, *box)
    bad = [a.clone() for a in args]
    for a in bad:
        a[list(poisoned)] = poison
    dirty = trajqp_fused_cuda.fused_trajqp_solve(*bad, *box)
    keep = _unpoisoned(B, poisoned, cuda)
    for c, d in zip(clean, dirty):
        assert torch.equal(c[keep], d[keep])


def test_trajqp_fused_warp_shared_memory(cuda):
    """Each instantiation's block fits the device, and an element holds at
    least its QP's blocks."""
    for T, nx, nu in trajqp_fused_cuda.WARP_BUILT:
        for dtype in K4_WARP_TOL:
            sm = trajqp_fused_cuda.warp_smem(dtype, T, nx, nu, cuda)
            n = nx + nu
            qp = T * n * n + (T - 1) * nx * (nx + nu)
            assert sm["per_element"] >= qp * dtype.itemsize
            assert sm["per_block"] <= sm["device_max"]


def test_trajqp_fused_refuses_unforced_shapes(cuda):
    """A shape neither layout serves raises, and the warp layout cannot be
    forced where it has no instantiation."""
    args = _trajqp_problem(4, 5, 4, 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="warp layout"):
        trajqp_fused_cuda._launch(*args, (-1.0,), (1.0,), 12, 1e-9, 1e-8,
                                  layout="warp")
    args = _trajqp_problem(4, 6, 12, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="no kernel"):
        trajqp_fused_cuda.fused_trajqp_solve(*args, (0.0,) * 4, (20.0,) * 4)


# ------------------------------- every model on every solver path ----
# Each model diff_qp_mpc_tpu_torch.models exports, at its env's shape (the
# CosSin models at their defaults) and T 5, on the AL scan (K1), AL fused
# (K2), ip scan (K3), ip fused (K4) and slew (K3 / K4 at (5, nx + nu, nu))
# paths: no path raises, the path launches its kernel, and its output is
# finite. ROADMAP.md lists what stays unbuilt (Integrator(nx=4, nu=2), K4
# at T ≠ 5); neither is a model's env shape.
MODEL_PATHS = ("al-scan", "al-fused", "ip-scan", "ip-fused", "slew-scan",
               "slew-fused")
MODEL_NAMES = ("pendulum",) + tuple(k2_models.ENVS)


def _model_problem(name, B, device):
    """(model, Cd, c, x0, u_lo, u_hi, x_init, u_init), float64, T 5:
    k2_models.problem's, and for the pendulum its env's."""
    if name != "pendulum":
        return k2_models.problem(name, B, 5, torch.float64, seed=0,
                                 device=device)
    rng = np.random.RandomState(0)
    to = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    x0 = rng.uniform(-0.3, 0.3, (B, 2))
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, 5, 3))
    return (Pendulum(), to(Cd), to(np.zeros((B, 5, 3))), to(x0), (-3.0,),
            (3.0,), to(np.repeat(x0[:, None], 5, 1)), to(np.zeros((B, 5, 1))))


def _model_path(name, path, device):
    """Run ``path`` on ``name``'s problem; returns (u, the kernel ids it
    should launch)."""
    from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

    model, Cd, c, x0, lo, hi, xi, ui = _model_problem(name, 8, device)
    B, T, nx, nu = Cd.shape[0], 5, model.nx, model.nu
    cost = DiagQuadCost(Cd=Cd, c=c)
    kw = dict(dtype=torch.float64, device=device)
    tensor_box = Bounds(u_lo=torch.tensor(lo, **kw),
                        u_hi=torch.tensor(hi, **kw))
    if path == "al-scan":
        st = ALState.init(B, T, nx, nu, dtype=torch.float64, device=device)
        return al_mpc.solve(model, cost, x0, tensor_box, st, al_mpc.ALConfig(),
                            x_init=xi, u_init=ui)[1], ("K1",)
    if path == "al-fused":
        return al_mpc.solve_fused(model, cost, x0, Bounds(u_lo=lo, u_hi=hi),
                                  al_mpc.ALConfig(), x_init=xi,
                                  u_init=ui)[1], ("K2",)
    kernel = path.split("-")[1]
    slew = path.startswith("slew")
    shape = (T, nx + nu if slew else nx, nu)
    if kernel == "scan":
        kid = ("K3" if riccati_cuda.kernel_for(*shape) == "riccati"
               else "K3h")
    else:
        kid = ("K4" if trajqp_fused_cuda.layout_for(*shape) == "thread"
               else "K4w")
    res = sqp_mpc.solve(
        model, cost, x0, Bounds(u_lo=lo, u_hi=hi) if kernel == "fused"
        else tensor_box, ui, xi,
        sqp_mpc.SQPConfig(qp_iter=1, qp=trajqp.TrajQPConfig(
            kernel=kernel, max_iter=12, reg=1e-9)),
        slew_rate_penalty=50.0 if slew else None)
    return res.u, (kid,)


_KERNEL_INDEX = {"K1": 0, "K2": 1, "K3": 2, "K3h": 3, "K4": 4, "K4w": 6}


def test_model_paths_cover_every_exported_model():
    from diff_qp_mpc_tpu_torch import models

    exported = {v for v in vars(models).values() if isinstance(v, type)
                and issubclass(v, models.DynamicsModel)} - {
        models.DynamicsModel, models.Functor, models.Rk4Functor}
    walked = {type(_model_problem(n, 2, "cpu")[0]) for n in MODEL_NAMES}
    assert walked == exported


@pytest.mark.parametrize("path", MODEL_PATHS)
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_every_model_runs_every_solver_path(cuda, name, path):
    before = _counts()
    u, kids = _model_path(name, path, cuda)
    after = _counts()
    assert bool(torch.isfinite(u).all())
    for kid in kids:
        assert after[_KERNEL_INDEX[kid]] > before[_KERNEL_INDEX[kid]], kid
