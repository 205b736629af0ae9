"""The implicit backward of the port's AL-MPC solves (solvers.al_mpc.solve,
solve_fused, solve_fused_stateful) against jax.grad through the JAX
package's custom VJPs (its fused paths with the Pallas kernel in interpret
mode), on pendulum tracking problems at the training budget (al_iter 2,
n_newton 4, n_ls 20, rho_max 1e6, reg 1e-7), B 8.

The loss is Σ W ⊙ [x, u] with W from a numpy seed; the gradients w.r.t. the
diagonal cost (Cd, c) are compared relative to their largest entry.
Tolerances: float64 1e-6 relative. Measured at seeds 7 and 11: dc ≤ 3e-11,
dCd ≤ 8.8e-8 (dCd = g ⊙ τ carries the forward solve's own spread, up to
~1e-7 from the line search's near-ties). float32 1e-2 relative, measured
≤ 2.2e-5 on dc and ≤ 6.8e-4 on dCd (float32 alone moves a forward solve by
~5e-3 at these budgets)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.core import types as dq
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.solvers import al_mpc as jax_al
from diff_qp_mpc_tpu_torch.core.types import ALState, Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import newton_al
from diff_qp_mpc_tpu_torch.solvers import al_mpc

B, T, NX, NU = 8, 5, 2, 1
N = NX + NU
TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
MAIN = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)
PATHS = ["solve", "fused", "fused_stateful"]


def _problem(seed):
    """A tracking problem as the policy poses it (x0 in the env's range, a
    drifting reference, Cd = (Q, R), c = −Cd·τ_ref) and loss weights W."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    xu_ref = np.concatenate([x_ref, 0.5 * rng.randn(B, T, NU)], -1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, N)).copy()
    return dict(x0=x0, Cd=Cd, c=-Cd * xu_ref, W=rng.randn(B, T, N))


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(npy(got) - ref).max() / np.abs(ref).max())


def _jax_grads(path, p, jdt):
    """d(Σ W ⊙ xu)/d(Cd, c) through the JAX solve (stateful: the second of
    two chained solves, so that λ/ρ are warm-started)."""
    m = JaxPendulum()
    cfg = (jax_al.ALConfig(kernel="scan", **MAIN) if path == "solve"
           else jax_al.ALConfig(interpret=True, **MAIN))
    x0 = j(p["x0"], jdt)
    bounds = dq.Bounds(u_lo=j([-3.0], jdt), u_hi=j([3.0], jdt))
    st = dq.ALState.init(B, T, NX, NU, hist_len=3, dtype=jdt)
    if path == "fused_stateful":
        cost0 = dq.DiagQuadCost(Cd=j(p["Cd"], jdt), c=j(0.9 * p["c"], jdt))
        _, _, st, _ = jax_al.solve_fused_stateful(m, cost0, x0, bounds, st,
                                                  cfg, differentiable=False)

    def loss(Cd, c):
        cost = dq.DiagQuadCost(Cd=Cd, c=c)
        if path == "solve":
            x, u, _, _ = jax_al.solve(m, cost, x0, bounds, st, cfg)
        elif path == "fused":
            x, u, _ = jax_al.solve_fused(m, cost, x0, bounds, cfg)
        else:
            x, u, _, _ = jax_al.solve_fused_stateful(m, cost, x0, bounds,
                                                     st, cfg)
        return jnp.sum(j(p["W"], jdt) * jnp.concatenate([x, u], -1))

    return jax.grad(loss, argnums=(0, 1))(j(p["Cd"], jdt), j(p["c"], jdt))


def _port_grads(path, p, dtype):
    m = Pendulum()
    cfg = al_mpc.ALConfig(**MAIN)
    x0 = t(p["x0"], dtype)
    bounds = Bounds(u_lo=t([-3.0], dtype), u_hi=t([3.0], dtype))
    st = ALState.init(B, T, NX, NU, hist_len=3, dtype=dtype)
    if path == "fused_stateful":
        cost0 = DiagQuadCost(Cd=t(p["Cd"], dtype), c=t(0.9 * p["c"], dtype))
        _, _, st, _ = al_mpc.solve_fused_stateful(m, cost0, x0, bounds, st,
                                                  cfg)
    Cd = t(p["Cd"], dtype).requires_grad_()
    c = t(p["c"], dtype).requires_grad_()
    cost = DiagQuadCost(Cd=Cd, c=c)
    if path == "solve":
        x, u, new_state, _ = al_mpc.solve(m, cost, x0, bounds, st, cfg)
    elif path == "fused":
        x, u, _ = al_mpc.solve_fused(m, cost, x0, bounds, cfg)
        new_state = None
    else:
        x, u, new_state, _ = al_mpc.solve_fused_stateful(m, cost, x0,
                                                         bounds, st, cfg)
    if new_state is not None:
        assert not any(a.requires_grad for a in (
            new_state.x, new_state.u, new_state.rho, new_state.lam.lam_dyn))
    (t(p["W"], dtype) * torch.cat([x, u], -1)).sum().backward()
    return Cd.grad, c.grad


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("path", PATHS)
def test_vjp_matches_jax_grad(path, dtype):
    p = _problem(7)
    gCd, gc = _port_grads(path, p, dtype)
    jCd, jc = _jax_grads(path, p, JDT[dtype])
    assert _rel(gc, jc) <= TOL[dtype], _rel(gc, jc)
    assert _rel(gCd, jCd) <= TOL[dtype], _rel(gCd, jCd)
    # the x₀ coordinates are pinned: no gradient reaches their cost
    assert float(np.abs(npy(gc)[:, 0, :NX]).max()) == 0.0


def test_sanitize_matches_jax(monkeypatch):
    """Non-finite entries become 0; an element whose largest entry exceeds
    1e8 becomes 0 whole; the guard counts the elements it changed, and
    only once a reader has set its count to 0."""
    rng = np.random.RandomState(0)
    g = rng.randn(6, T, N)
    g[1, 2, 0] = np.nan
    g[2, 4, 2] = np.inf
    g[3, 0, 1] = 5e8
    g[4, 3, 1] = -2e8
    ref = jax_al._sanitize_implicit_grad(jnp.asarray(g))
    assert al_mpc.guard_drops is None  # no reader: nothing is counted
    got = al_mpc._sanitize_implicit_grad(torch.tensor(g))
    np.testing.assert_array_equal(npy(got), np.asarray(ref))
    assert al_mpc.guard_drops is None
    monkeypatch.setattr(al_mpc, "guard_drops", 0)
    got = al_mpc._sanitize_implicit_grad(torch.tensor(g))
    np.testing.assert_array_equal(npy(got), np.asarray(ref))
    assert int(al_mpc.guard_drops) == 4


@pytest.mark.parametrize("path", PATHS)
def test_hessian_blocks_only_for_a_gradient(monkeypatch, path):
    """The serving paths (no grad, or differentiable=False) compute no
    extra Hessian blocks; a differentiable call computes them once."""
    calls = []
    blocks = newton_al.final_pinned_blocks

    def spy(*a, **kw):
        calls.append(1)
        return blocks(*a, **kw)

    monkeypatch.setattr(newton_al, "final_pinned_blocks", spy)
    p = _problem(3)
    m, cfg = Pendulum(), al_mpc.ALConfig(**MAIN)
    bounds = Bounds(u_lo=t([-3.0]), u_hi=t([3.0]))
    Cd, c = t(p["Cd"]), t(p["c"]).requires_grad_()
    st = ALState.init(B, T, NX, NU, dtype=torch.float64)

    def run(**kw):
        cost = DiagQuadCost(Cd=Cd, c=c)
        if path == "solve":
            return al_mpc.solve(m, cost, t(p["x0"]), bounds, st, cfg, **kw)
        if path == "fused":
            return al_mpc.solve_fused(m, cost, t(p["x0"]), bounds, cfg, **kw)
        return al_mpc.solve_fused_stateful(m, cost, t(p["x0"]), bounds, st,
                                           cfg, **kw)

    with torch.no_grad():
        out = run()
    assert not out[0].requires_grad
    out = run(differentiable=False)
    assert calls == [] and not out[0].requires_grad
    out = run()
    assert calls == [1] and out[0].requires_grad
