"""The port's SQP MPC (solvers.sqp_mpc) against the JAX package's
solve(differentiable=True) on pendulum tracking problems (B 8, T 5,
qp_iter 2), on both trajectory-QP kernels (the JAX fused one in interpret
mode), and the semantics of the JAX solve that the port keeps: the final QP
solved cold, the returned value the line search's rollout, the line
search's baseline the feasible rollout of u_init, its fallback to the last
candidate. Also the pieces it is built on: linearize_trajectory and the
dense cost.

Tolerances: float64 1e-6. The rollout line search takes the largest α whose
cost beats the incumbent; once |Δu| ≲ 1e-6 the candidates' costs tie to
rounding (1e-14), and two correct implementations take different α, which
moves u by up to |Δu| (7.1e-7 on element 4 of these inputs). float32 1e-2,
as the AL tests (float32 alone moves a policy solve by ~4e-3)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.core.types import DiagQuadCost as JaxDiagQuadCost
from diff_qp_mpc_tpu.core.types import LinDx as JaxLinDx
from diff_qp_mpc_tpu.core.types import QuadCost as JaxQuadCost
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.ops import almerit as jax_almerit
from diff_qp_mpc_tpu.solvers import sqp_mpc as jax_sqp
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.core.types import (
    Bounds,
    DiagQuadCost,
    LinDx,
    QuadCost,
)
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import almerit
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

B, T = 8, 5
TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
DTYPES = [(torch.float64, jnp.float64), (torch.float32, jnp.float32)]


def tracking_problem(seed=0):
    """x0, a reference drifting from it (the x_init proposal), u_ref (the
    u_init warm start), and the tracking cost diag(10, 1, 0.01)."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, 2))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, 2), axis=1)
    x_ref[:, 0] = x0
    u_ref = 0.5 * rng.randn(B, T, 1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, 3)).copy()
    c = -Cd * np.concatenate([x_ref, u_ref], -1)
    return x0, x_ref, u_ref, Cd, c


def jax_solve(kernel, jdt, x_goal=None, seed=0):
    x0, x_ref, u_ref, Cd, c = (jnp.asarray(a, jdt)
                               for a in tracking_problem(seed))
    bounds = (JaxBounds(u_lo=(-3.0,), u_hi=(3.0,)) if kernel == "fused"
              else JaxBounds(u_lo=jnp.array([-3.0], jdt),
                             u_hi=jnp.array([3.0], jdt)))
    cfg = jax_sqp.SQPConfig(qp_iter=2, qp=jax_trajqp.TrajQPConfig(
        kernel=kernel, interpret=kernel == "fused"))
    return jax_sqp.solve(JaxPendulum(), JaxDiagQuadCost(Cd=Cd, c=c), x0,
                         bounds, u_ref, x_ref, cfg, differentiable=True,
                         x_goal=x_goal)


def port_solve(kernel, dtype, x_goal=None, seed=0, differentiable=True):
    x0, x_ref, u_ref, Cd, c = (torch.tensor(a, dtype=dtype)
                               for a in tracking_problem(seed))
    bounds = (Bounds(u_lo=(-3.0,), u_hi=(3.0,)) if kernel == "fused"
              else Bounds(u_lo=torch.tensor([-3.0], dtype=dtype),
                          u_hi=torch.tensor([3.0], dtype=dtype)))
    cfg = sqp_mpc.SQPConfig(qp_iter=2,
                            qp=trajqp.TrajQPConfig(kernel=kernel))
    return sqp_mpc.solve(Pendulum(), DiagQuadCost(Cd=Cd, c=c), x0, bounds,
                         u_ref, x_ref, cfg, differentiable=differentiable,
                         x_goal=x_goal)


@pytest.mark.parametrize("dtype,jdt", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("kernel", ["scan", "fused"])
def test_solve_matches_jax(kernel, dtype, jdt):
    ref = jax_solve(kernel, jdt)
    got = port_solve(kernel, dtype)
    for name in ("x", "u", "cost"):
        np.testing.assert_allclose(
            npy(getattr(got, name)), np.asarray(getattr(ref, name)),
            rtol=TOL[dtype], atol=TOL[dtype], err_msg=name)
    assert float(got.u.abs().max()) <= 3.0 + 1e-6
    if dtype == torch.float64:
        # the SQP loop's last line search: same α, and on element 7 no
        # candidate improves, so both fall back to the last one, 0.2⁹
        np.testing.assert_array_equal(npy(got.alpha), np.asarray(ref.alpha))
        assert float(got.alpha[7]) == pytest.approx(0.2 ** 9, rel=1e-12)


def test_terminal_goal_matches_jax():
    """x_goal adds goal_weight 1e6 to the terminal cost: the costs grow
    ~1e6-fold, the line search's candidates tie to rounding at a larger
    |Δu|, and the packages' u differ by up to 3.2e-6; held to 1e-5."""
    goal = np.array([0.0, 0.0])
    ref = jax_solve("scan", jnp.float64, x_goal=jnp.asarray(goal))
    got = port_solve("scan", torch.float64, x_goal=torch.tensor(goal))
    for name in ("x", "u", "cost"):
        np.testing.assert_allclose(npy(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("differentiable", [True, False])
def test_final_qp_start(monkeypatch, differentiable):
    """The SQP iterations' QPs start from the current iterate; the final QP
    starts cold on the differentiable branch (the JAX layer's forward
    takes no warm start) and from the best iterate otherwise."""
    calls = []
    solve = trajqp.solve

    def spy(*args, x_init=None, u_init=None, **kw):
        calls.append((x_init is None, u_init is None))
        return solve(*args, x_init=x_init, u_init=u_init, **kw)

    monkeypatch.setattr(trajqp, "solve", spy)
    port_solve("scan", torch.float64, differentiable=differentiable)
    assert calls[:2] == [(False, False)] * 2
    assert calls[2] == ((True, True) if differentiable else (False, False))


def test_value_is_the_line_search_rollout():
    """x is the feasible rollout of the returned u, not the QP's plan."""
    res = port_solve("scan", torch.float64)
    x0 = torch.tensor(tracking_problem()[0])
    assert torch.equal(res.x, Pendulum().rollout(x0, res.u))


def test_line_search_baseline_is_the_feasible_rollout(monkeypatch):
    """The first line search's incumbent cost is that of u_init's feasible
    rollout, not of the (infeasible, near-zero-cost) x_init proposal."""
    costs = []
    line_search = sqp_mpc.line_search

    def spy(dyn, cost, x, u, dx, du, x0, cost_cur, *rest):
        costs.append(cost_cur)
        return line_search(dyn, cost, x, u, dx, du, x0, cost_cur, *rest)

    monkeypatch.setattr(sqp_mpc, "line_search", spy)
    port_solve("scan", torch.float64)
    x0, x_ref, u_ref, Cd, c = (torch.tensor(a) for a in tracking_problem())
    cost = sqp_mpc._dense_cost(DiagQuadCost(Cd=Cd, c=c), B, T, 3)
    x_feas = Pendulum().rollout(x0, u_ref)
    want = almerit.compute_cost(cost, torch.cat([x_feas, u_ref], -1))
    proposal = almerit.compute_cost(cost, torch.cat([x_ref, u_ref], -1))
    assert torch.equal(costs[0], want)
    assert not torch.allclose(costs[0], proposal)


def test_affine_dynamics_match_jax():
    """LinDx dynamics x' = F [x; u] + f (the linearization taken from the
    caller, the rollouts affine), scan kernel, float64."""
    x0, x_ref, u_ref, Cd, c = tracking_problem(seed=2)
    rng = np.random.RandomState(3)
    F = np.concatenate([np.eye(2) + 0.05 * rng.randn(B, T - 1, 2, 2),
                        0.1 * rng.randn(B, T - 1, 2, 1)], -1)
    f = 0.05 * rng.randn(B, T - 1, 2)
    ref = jax_sqp.solve(
        JaxLinDx(F=jnp.asarray(F), f=jnp.asarray(f)),
        JaxDiagQuadCost(Cd=jnp.asarray(Cd), c=jnp.asarray(c)),
        jnp.asarray(x0), JaxBounds(u_lo=jnp.array([-3.0]),
                                   u_hi=jnp.array([3.0])),
        jnp.asarray(u_ref), jnp.asarray(x_ref), jax_sqp.SQPConfig(qp_iter=2))
    got = sqp_mpc.solve(
        LinDx(F=torch.tensor(F), f=torch.tensor(f)),
        DiagQuadCost(Cd=torch.tensor(Cd), c=torch.tensor(c)),
        torch.tensor(x0), Bounds(u_lo=torch.tensor([-3.0]).double(),
                                 u_hi=torch.tensor([3.0]).double()),
        torch.tensor(u_ref), torch.tensor(x_ref), sqp_mpc.SQPConfig(qp_iter=2))
    for name in ("x", "u", "cost"):
        np.testing.assert_allclose(npy(getattr(got, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_linearize_and_dense_cost_match_jax():
    rng = np.random.RandomState(1)
    x, u = rng.randn(B, T, 2), rng.randn(B, T, 1)
    ref = JaxPendulum().linearize(jnp.asarray(x), jnp.asarray(u))
    got = Pendulum().linearize(torch.tensor(x), torch.tensor(u))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(npy(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    C = rng.randn(B, T, 3, 3)
    c, xu = rng.randn(B, T, 3), rng.randn(B, T, 3)
    np.testing.assert_allclose(
        npy(almerit.compute_cost(QuadCost(C=torch.tensor(C),
                                          c=torch.tensor(c)),
                                 torch.tensor(xu))),
        np.asarray(jax_almerit.compute_cost(
            JaxQuadCost(C=jnp.asarray(C), c=jnp.asarray(c)),
            jnp.asarray(xu))), rtol=1e-12)
