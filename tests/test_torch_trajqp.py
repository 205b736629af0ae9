"""The port's trajectory-QP interior-point solve (solvers.trajqp) against the
JAX package's: the scan IPM against JAX kernel="scan", and the fused path
(kernel K4's plain version, ops.trajqp_fused_cuda) against JAX
kernel="fused" with its Pallas kernel in interpret mode. Inputs are
tests/test_trajqp_fused.py's (B 16, T 5, nx 3, nu 2, box ±1.5, max_iter 8,
reg 1e-7), cold and warm-started.

Tolerances: the IPM is continuous in its inputs (no line search; the best
iterate only changes hands between nearly equal iterates), so float64 agrees
to 1e-9 absolute; float32 to 1e-4 (the measured spread is 5e-7 on x, u and
λ, amplified near convergence by the z/s ratios of active bounds)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
from diff_qp_mpc_tpu_torch.core.types import Bounds
from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda
from diff_qp_mpc_tpu_torch.solvers import trajqp

TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]
BOX = 1.5


def random_traj_qp(B=16, T=5, nx=3, nu=2, seed=0):
    """tests/test_trajqp_fused.py's random_traj_qp, as numpy arrays."""
    n = nx + nu
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T, n, n)
    return (0.1 * M @ M.transpose(0, 1, 3, 2) + np.eye(n),
            0.3 * rng.randn(B, T, n),
            np.eye(nx) + 0.1 * rng.randn(B, T - 1, nx, nx),
            0.3 * rng.randn(B, T - 1, nx, nu),
            0.1 * rng.randn(B, T - 1, nx), 0.5 * rng.randn(B, nx))


def warm_start(B=16, T=5, nx=3, nu=2):
    rng = np.random.RandomState(4)
    return 0.3 * rng.randn(B, T, nx), 0.3 * rng.randn(B, T, nu)


def jax_cfg(kernel, **kw):
    return jax_trajqp.TrajQPConfig(
        max_iter=kw.get("max_iter", 8), reg=1e-7, kernel=kernel,
        interpret=kernel == "fused")


def port_cfg(kernel, **kw):
    return trajqp.TrajQPConfig(max_iter=kw.get("max_iter", 8), reg=1e-7,
                               kernel=kernel)


def jax_bounds(kernel, nu, jdt):
    if kernel == "fused":  # the fused kernel's static python tuples
        return JaxBounds(u_lo=(-BOX,) * nu, u_hi=(BOX,) * nu)
    return JaxBounds(u_lo=jnp.full((nu,), -BOX, jdt),
                     u_hi=jnp.full((nu,), BOX, jdt))


def port_bounds(kernel, nu, dtype):
    if kernel == "fused":
        return Bounds(u_lo=(-BOX,) * nu, u_hi=(BOX,) * nu)
    return Bounds(u_lo=torch.full((nu,), -BOX, dtype=dtype),
                  u_hi=torch.full((nu,), BOX, dtype=dtype))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_solve_matches_jax(kernel, dtype, jdt, warm):
    arrays = random_traj_qp(seed=3 if warm else 0)
    inits = warm_start() if warm else (None, None)
    nu = arrays[3].shape[-1]
    ref = jax_trajqp.solve(
        *(jnp.asarray(a, jdt) for a in arrays), jax_bounds(kernel, nu, jdt),
        jax_cfg(kernel), *(None if a is None else jnp.asarray(a, jdt)
                           for a in inits))
    before = trajqp_fused_cuda.launches
    got = trajqp.solve(
        *(torch.tensor(a, dtype=dtype) for a in arrays),
        port_bounds(kernel, nu, dtype), port_cfg(kernel),
        *(None if a is None else torch.tensor(a, dtype=dtype)
          for a in inits))
    assert trajqp_fused_cuda.launches == before  # CPU: the plain version
    for name in ref._fields:
        np.testing.assert_allclose(
            npy(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=TOL[dtype], atol=TOL[dtype], err_msg=name)
    assert float(got.u.abs().max()) <= BOX + 1e-6


@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_layer_solves_cold(kernel):
    """traj_qp_layer (traj_qp_layer_static on the fused kernel) takes no
    warm start: u from the box midpoint, x from its affine rollout, as the
    JAX layers' forward."""
    arrays = random_traj_qp(seed=5)
    nu = arrays[3].shape[-1]
    jlayer = (jax_trajqp.traj_qp_layer_static if kernel == "fused"
              else jax_trajqp.traj_qp_layer)
    ref = jlayer(*(jnp.asarray(a) for a in arrays),
                 jax_bounds(kernel, nu, jnp.float64), jax_cfg(kernel))
    tens = [torch.tensor(a) for a in arrays]
    layer = (trajqp.traj_qp_layer_static if kernel == "fused"
             else trajqp.traj_qp_layer)
    w = layer(*tens, port_bounds(kernel, nu, torch.float64), port_cfg(kernel))
    np.testing.assert_allclose(npy(w), np.asarray(ref), rtol=1e-9, atol=1e-9)
    cold = trajqp.solve(*tens, port_bounds(kernel, nu, torch.float64),
                        port_cfg(kernel))
    assert torch.equal(w, torch.cat([cold.x, cold.u], -1))


def test_static_layer_takes_tuple_bounds():
    tens = [torch.tensor(a) for a in random_traj_qp()]
    with pytest.raises(TypeError):
        trajqp.traj_qp_layer_static(*tens, port_bounds("scan", 2,
                                                       torch.float64),
                                    port_cfg("fused"))


def test_unported_kernels_raise():
    with pytest.raises(NotImplementedError):
        trajqp.TrajQPConfig(kernel="pprefix")
    with pytest.raises(ValueError):
        trajqp.TrajQPConfig(kernel="pallas")
    with pytest.raises(ValueError):
        trajqp.riccati_solver("fused")
    assert trajqp.TrajQPConfig(kernel="auto").kernel == "scan"


def test_fused_initial_best_total_is_float32_max():
    """K4 starts its best total at float32's max in every dtype; the scan
    IPM at inf. With no iteration and a residual total above float32's max
    (x_init[0] 1e40 away from x0, float64), the fused path reports float32's
    max and the scan path the total itself, in both packages."""
    arrays = list(random_traj_qp())
    arrays[5] = arrays[5] + 1e40  # x0
    x_init = np.zeros((16, 5, 3))
    totals = {}
    for kernel in ("scan", "fused"):
        ref = jax_trajqp.solve(
            *(jnp.asarray(a) for a in arrays),
            jax_bounds("scan", 2, jnp.float64), jax_cfg("scan", max_iter=0),
            jnp.asarray(x_init)) if kernel == "scan" else None
        got = trajqp.solve(*(torch.tensor(a) for a in arrays),
                           port_bounds(kernel, 2, torch.float64),
                           port_cfg(kernel, max_iter=0), torch.tensor(x_init))
        totals[kernel] = npy(got.resids)
        if ref is not None:
            np.testing.assert_allclose(totals[kernel], np.asarray(ref.resids),
                                       rtol=1e-12)
    f32_max = float(np.finfo(np.float32).max)
    assert (totals["fused"] == f32_max).all()
    assert (totals["scan"] > 1e39).all()


# The K4 profiler's problem (benchmarks/prof_trajqp_fused.py, seed 0) at
# (nx, nu) = (4, 1), B 8: box ±1.5, max_iter 12, reg 1e-7.
PROF_CASE = (8, 5, 4, 1)


def _prof_cfg(kernel):
    return trajqp.TrajQPConfig(max_iter=prof.MAX_ITER, reg=prof.REG,
                               kernel=kernel)


def test_scan_ipm_matches_jax_on_profiler_problem():
    """float64, every field to 1e-9 as the cases above."""
    arrays = prof.problem_arrays(*PROF_CASE)
    ref = jax_trajqp.solve(
        *(jnp.asarray(a) for a in arrays),
        JaxBounds(u_lo=jnp.full((1,), -prof.BOX), u_hi=jnp.full((1,),
                                                               prof.BOX)),
        jax_trajqp.TrajQPConfig(max_iter=prof.MAX_ITER, reg=prof.REG,
                                kernel="scan"))
    got = trajqp.solve(
        *(torch.tensor(a) for a in arrays),
        Bounds(u_lo=torch.full((1,), -prof.BOX, dtype=torch.float64),
               u_hi=torch.full((1,), prof.BOX, dtype=torch.float64)),
        _prof_cfg("scan"))
    for name in ref._fields:
        np.testing.assert_allclose(
            npy(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=1e-9, atol=1e-9, err_msg=name)


def test_fused_plain_matches_scan_on_profiler_problem():
    """K4's plain version against the port's scan IPM at (5, 4, 1),
    float64, as the profiler compares them on the card. They differ only in
    their corner semantics (u clipped again inside, σ's floor, the
    best-total select): measured spread 1.7e-10 on u and the slacks (u sits
    at the box on some stages), ≤ 7.1e-14 on the other fields. Held to
    1e-8, K4's float64 tolerance in chip_smoke.py."""
    arrays = [torch.tensor(a) for a in prof.problem_arrays(*PROF_CASE)]
    bounds = Bounds(u_lo=(-prof.BOX,), u_hi=(prof.BOX,))
    before = trajqp_fused_cuda.launches
    fused = trajqp.solve(*arrays, bounds, _prof_cfg("fused"))
    assert trajqp_fused_cuda.launches == before  # CPU: the plain version
    scan = trajqp.solve(*arrays, bounds, _prof_cfg("scan"))
    for name in scan._fields:
        np.testing.assert_allclose(
            npy(getattr(fused, name)), npy(getattr(scan, name)),
            rtol=1e-8, atol=1e-8, err_msg=name)
    assert float(fused.u.abs().max()) <= prof.BOX + 1e-9
