"""The port's Rex quadrotor against the JAX package's: the rotation maths,
the model's step (RK4 of the array ODE), its closed form ``step_parts``
(K2's functor) and its Jacobian, and K2's plain version on the
quadrotor's hover problems (the policy and its training gradient are in
tests/test_torch_quadrotor_policy.py). JAX on the CPU with x64 on
(tests/conftest.py); the port's tensors on the CPU, so K2 runs its plain
version.

JAX's quadrotor kernel in interpret mode takes minutes at these sizes, so
the JAX side is its scan path (``al_mpc.solve`` with kernel "scan"), which
its own tests/test_al_fused.py holds equal to its kernel."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.models import RexQuadrotor as JaxQuad
from diff_qp_mpc_tpu.models import rotation as jrot
from diff_qp_mpc_tpu_torch.models import RexQuadrotor
from diff_qp_mpc_tpu_torch.models import rotation as trot
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

# the checkpoint's solver budget (its meta.json: qp_iter 2, rho_max 1e4,
# al_reg null: ALConfig's 1e-7)
BUDGET = dict(al_iter=2, n_newton=4, n_ls=20, rho_factor=10.0, rho_max=1e4,
              reg=1e-7)
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(npy(got).astype(np.float64) - ref).max()
                 / np.abs(ref).max())


def _states(B, seed, scale=1.0):
    """Poses beyond the env's draws: position ±1, MRP ±0.3, velocity and
    rates of order 1 (scaled), and controls across the box [0, 20]."""
    rng = np.random.RandomState(seed)
    x = np.concatenate([rng.uniform(-1, 1, (B, 3)), 0.3 * rng.randn(B, 3),
                        scale * rng.randn(B, 3), scale * rng.randn(B, 3)], 1)
    return x, rng.uniform(0.0, 20.0, (B, 4))


# float64 to rounding; float32 to a few float32 ulps of the largest entry
ROT_TOL = {torch.float64: 1e-14, torch.float32: 1e-6}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rotation_matches_jax(dtype):
    rng = np.random.RandomState(0)
    m = 0.5 * rng.randn(64, 3)
    r = rng.randn(64, 3)
    w = rng.randn(64, 3)
    q = np.asarray(jrot.mrp_to_quat(j(m)))
    angles = rng.uniform(-np.pi, np.pi, (3, 64))
    jd = JDT[dtype]
    cases = [
        (trot.mrp_to_quat(t(m, dtype)), jrot.mrp_to_quat(j(m, jd))),
        (trot.quat_to_mrp(t(q, dtype)), jrot.quat_to_mrp(j(q, jd))),
        (trot.quat_rotate(t(q, dtype), t(r, dtype)),
         jrot.quat_rotate(j(q, jd), j(r, jd))),
        (trot.mrp_to_rot(t(m, dtype)), jrot.mrp_to_rot(j(m, jd))),
        (trot.mrp_kinematics(t(m, dtype), t(w, dtype)),
         jrot.mrp_kinematics(j(m, jd), j(w, jd))),
        (trot.euler_to_quat(*t(angles, dtype)),
         jrot.euler_to_quat(*j(angles, jd)))]
    for k, (got, ref) in enumerate(cases):
        assert got.dtype == dtype
        assert _rel(got, ref) <= ROT_TOL[dtype], k


# step and step_parts: float64 to rounding (the closed form is the JAX
# package's _quad_ode_parts operation for operation bar its products by
# known zeros, which only change the sign of a zero); float32 within 2e-6
# of the largest entry: the JAX model under x64 keeps its inertia
# constants in float64 and promotes the step to float64, the port rounds
# them to float32. The Jacobian: float64 1e-12, float32 1e-5 of its
# largest entry (1.5).
STEP_TOL = {torch.float64: 1e-14, torch.float32: 2e-6}
JAC_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_step_step_parts_and_jac_match_jax(dtype):
    jm, tm = JaxQuad(), RexQuadrotor()
    x, u = _states(32, seed=1)
    jd = JDT[dtype]
    xj, uj = j(x, jd), j(u, jd)
    xt, ut = t(x, dtype), t(u, dtype)
    # one jitted call: JAX's eager jacfwd of RK4 takes ~10 s on the CPU
    ref, ref_parts, (JA, JB) = jax.jit(lambda x, u: (
        jm.step(x, u), jnp.stack(jm.step_parts(tuple(x.T), tuple(u.T)), -1),
        jax.vmap(jax.jacfwd(jm.step, argnums=(0, 1)))(x, u)))(xj, uj)
    ref = np.asarray(ref)
    assert _rel(tm.step(xt, ut), ref) <= STEP_TOL[dtype]
    parts = torch.stack(tm.step_parts(xt.unbind(-1), ut.unbind(-1)), -1)
    assert parts.dtype == dtype
    assert _rel(parts, ref_parts) <= STEP_TOL[dtype]
    x_next, (A, B) = tm.jac(xt, ut)
    assert _rel(x_next, ref) <= STEP_TOL[dtype]
    assert (A.dtype, B.dtype) == (dtype, dtype)
    assert _rel(A, JA) <= JAC_TOL[dtype]
    assert _rel(B, JB) <= JAC_TOL[dtype]
    h_jax, h = np.asarray(jm.hover_thrust()), npy(tm.hover_thrust())
    np.testing.assert_allclose(h, h_jax, rtol=1e-15)
    # at the hover thrust, level and at rest, the quadrotor stays put
    hover = tm.step(torch.zeros(1, 12, dtype=torch.float64),
                    tm.hover_thrust()[None])
    assert float(hover.abs().max()) < 1e-12


def test_float32_inertia_inverse_costs_an_ulp():
    """The JAX package's float32 model (x64 off) inverts J in float32; the
    port folds J⁻¹ in float64 and rounds it once. Over one RK4 step from
    states with body rates of order 1 the two float32 steps differ by at
    most 2e-6 of the largest entry, as STEP_TOL holds float32."""
    x, u = _states(32, seed=2)
    with jax.enable_x64(False):
        jm = JaxQuad()
        assert jm._Jinv.dtype == jnp.float32
        ref = np.asarray(jm.step(j(x, jnp.float32), j(u, jnp.float32)))
    got = RexQuadrotor().step(t(x, torch.float32), t(u, torch.float32))
    assert _rel(got, ref) <= STEP_TOL[torch.float32]


def _hover_problem(B, T, seed):
    """The JAX package's quadrotor tracking problems
    (tests/test_al_fused.py): x0 near hover, Cd (10 on position, 1 on the
    rest of the state, 0.1 on u), the goal the origin at hover thrust,
    u_init the hover thrust."""
    rng = np.random.RandomState(seed)
    x0 = np.concatenate([rng.uniform(-0.5, 0.5, (B, 3)),
                         0.05 * rng.randn(B, 3), 0.1 * rng.randn(B, 3),
                         0.05 * rng.randn(B, 3)], 1)
    Cd = np.broadcast_to([10.0] * 3 + [1.0] * 9 + [0.1] * 4,
                         (B, T, 16)).copy()
    goal = np.concatenate([np.zeros(12), npy(RexQuadrotor().hover_thrust())])
    return x0, Cd, -Cd * goal, np.broadcast_to(goal[12:], (B, T, 4)).copy()


# K2's plain version against the JAX scan solve in float64: float64 1e-9
# (the two run one algorithm; the quadrotor's line searches meet no
# near-tie at this budget, where one ulp of an input moves the plain
# version by at most 2.2e-9 on K2's checks, k2_models --plain); float32
# 1e-2, K2's float32 tolerance (float32 alone moves a solve by up to
# 2.8e-3 from float64)
K2_TOL = {torch.float64: 1e-9, torch.float32: 1e-2}
K2_B, K2_T = 4, 5


def _k2_problem(case):
    """The hover problems; and ("bounds") the same with the control
    reference pulled to −5 on two rotors and 30 on the others, so that
    both ends of the box [0, 20], which is not symmetric about 0, bind."""
    x0, Cd, c, u_init = _hover_problem(K2_B, K2_T, seed=0)
    if case == "bounds":
        c[..., 12:] = -Cd[..., 12:] * np.array([-5.0, 30.0, -5.0, 30.0])
    return x0, Cd, c, u_init


@functools.lru_cache(maxsize=None)
def _jax_scan_solve():
    """JAX's scan solve at the budget, in float64, jitted once for every
    case of the test (tracing and compiling it takes ~20 s on the CPU)."""
    import diff_qp_mpc_tpu as dq
    from diff_qp_mpc_tpu.solvers import al_mpc as jax_al

    cfg = jax_al.ALConfig(kernel="scan", **{
        k: v for k, v in BUDGET.items() if k != "rho_factor"})

    def solve(Cd, c, x0, u_init):
        st = dq.ALState.init(K2_B, K2_T, 12, 4, dtype=jnp.float64)
        box = dq.Bounds(u_lo=jnp.zeros((4,)), u_hi=jnp.full((4,), 20.0))
        xr, ur, _, stats = jax_al.solve(JaxQuad(), dq.DiagQuadCost(Cd=Cd, c=c),
                                        x0, box, st, cfg, u_init=u_init)
        return jnp.concatenate([xr, ur], -1), stats.dyn_res

    return jax.jit(solve)


@functools.lru_cache(maxsize=None)
def _jax_k2_reference(case):
    x0, Cd, c, u_init = _k2_problem(case)
    ref, dyn_res = _jax_scan_solve()(j(Cd), j(c), j(x0), j(u_init))
    return np.asarray(ref), np.asarray(dyn_res)


@pytest.mark.parametrize("dtype,case", [(torch.float64, "hover"),
                                        (torch.float32, "hover"),
                                        (torch.float64, "bounds")])
def test_k2_plain_matches_jax_scan_solve(dtype, case):
    """The port's K2 (its plain version here) in ``dtype`` against the JAX
    package's float64 scan solve of the same problem (``_k2_problem``)."""
    x0, Cd, c, u_init = _k2_problem(case)
    ref, dyn_res = _jax_k2_reference(case)
    model = RexQuadrotor()
    x0t, ui = t(x0, dtype), t(u_init, dtype)
    w, *_, res = al_fused_cuda.fused_al_solve(
        model, t(Cd, dtype), t(c, dtype), x0t, (0.0,) * 4, (20.0,) * 4,
        model.rollout(x0t, ui), ui, **BUDGET)
    assert w.dtype == dtype
    assert float(np.abs(ref[..., 12:] - u_init).max()) > 1e-2  # a real solve
    if case == "bounds":  # both ends bind
        assert ref[..., 12:].min() < 1e-3 and ref[..., 12:].max() > 19.9
    np.testing.assert_allclose(npy(w), ref, rtol=K2_TOL[dtype],
                               atol=K2_TOL[dtype])
    np.testing.assert_allclose(npy(res), dyn_res,
                               rtol=K2_TOL[dtype], atol=K2_TOL[dtype])
