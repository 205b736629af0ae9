"""The slew-rate option of the port's SQP MPC: ``SlewAugmented`` (models.base)
against the JAX package's (its step, and its Jacobians against jax.jacfwd
of the JAX step), and ``sqp_mpc.solve(slew_rate_penalty=...)`` against
the JAX package's on pendulum tracking problems (B 8, T 5, qp_iter 2,
s 50) with and without ``prev_ctrl`` (the value and the gradient w.r.t.
the cost and x0), on the fused kernel's plain version, with ``x_goal``
(tests/test_sqp_mpc.py:144), and the JAX test's criteria on the port
(tests/test_sqp_mpc.py:90-117).

The augmented problem runs the trajectory QP at (T, nx + nu, nu) = (5, 3,
1) for the pendulum: on CUDA tensors K3 and K4 at that shape
(tests/test_torch_cuda_kernels.py holds them there).

Tolerances: float64 1e-6 on x, u and the cost, the SQP tests' (the
rollout line search's near-ties at convergence; read: ≤ 1.6e-9), the
gradients 1e-6 relative (read: ≤ 9.1e-10); the fused kernel's plain
version against the JAX scan solve 1e-5 (the fused IPM's corner semantics
and the line search's ties; read: ≤ 1.9e-7); Jacobians 1e-12; float32
against the JAX float64 solve 1e-2, as the SQP tests (read: ≤ 1.2e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.core.types import DiagQuadCost as JaxDiagQuadCost
from diff_qp_mpc_tpu.models import Integrator as JaxIntegrator
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.models.base import SlewAugmented as JaxSlewAugmented
from diff_qp_mpc_tpu.solvers import sqp_mpc as jax_sqp
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost, LinDx
from diff_qp_mpc_tpu_torch.models import Integrator, Pendulum
from diff_qp_mpc_tpu_torch.models.base import SlewAugmented
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

B, T = 8, 5
SLEW = 50.0


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


PREV = np.linspace(-0.5, 0.5, B)[:, None]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(npy(got) - want).max()) / max(1.0, float(
        np.abs(want).max()))


@pytest.mark.parametrize("model", ["pendulum", "integrator"])
def test_slew_augmented_step_and_jacobians_match_jax(model):
    port, ref = {"pendulum": (Pendulum(), JaxPendulum()),
                 "integrator": (Integrator(nx=2, nu=1, dt=0.1),
                                JaxIntegrator(nx=2, nu=1, dt=0.1))}[model]
    dyn, jdyn = SlewAugmented(port), JaxSlewAugmented(ref)
    assert (dyn.nx, dyn.nu, dyn.nq, dyn.dt) == (jdyn.nx, jdyn.nu, jdyn.nq,
                                                jdyn.dt)
    rng = np.random.RandomState(1)
    x, u = rng.randn(16, dyn.nx), rng.randn(16, dyn.nu)
    jx, ju = jax.vmap(jax.jacfwd(jdyn.step, argnums=(0, 1)))(
        jnp.asarray(x), jnp.asarray(u))
    x_next, (A, Bm) = dyn.jac(torch.tensor(x), torch.tensor(u))
    np.testing.assert_allclose(npy(x_next),
                               np.asarray(jdyn.step(jnp.asarray(x),
                                                    jnp.asarray(u))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(npy(A), np.asarray(jx), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(npy(Bm), np.asarray(ju), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(dyn.step(torch.tensor(x), torch.tensor(u)),
                               x_next, rtol=0, atol=0)


def test_slew_augmented_hash_and_eq():
    inner = Pendulum()
    assert SlewAugmented(inner) == SlewAugmented(inner)
    assert hash(SlewAugmented(inner)) == hash(SlewAugmented(inner))
    assert SlewAugmented(inner) != SlewAugmented(Pendulum())
    assert SlewAugmented(inner) != inner


def jax_loss_and_solve(kernel, prev_ctrl, x_goal=None):
    """The JAX solve's loss Σ x² + Σ u² and its gradient w.r.t. (c, x0),
    the solve's outputs as aux, float64."""
    x0, x_ref, u_ref, Cd, c = tracking_problem()
    bounds = (JaxBounds(u_lo=(-3.0,), u_hi=(3.0,)) if kernel == "fused"
              else JaxBounds(u_lo=jnp.array([-3.0]), u_hi=jnp.array([3.0])))
    cfg = jax_sqp.SQPConfig(qp_iter=2, qp=jax_trajqp.TrajQPConfig(
        kernel=kernel, interpret=kernel == "fused"))

    def loss(c_, x0_):
        res = jax_sqp.solve(
            JaxPendulum(), JaxDiagQuadCost(Cd=jnp.asarray(Cd), c=c_), x0_,
            bounds, jnp.asarray(u_ref), jnp.asarray(x_ref), cfg,
            differentiable=True, slew_rate_penalty=SLEW,
            prev_ctrl=None if prev_ctrl is None else jnp.asarray(prev_ctrl),
            x_goal=x_goal)
        return jnp.sum(res.x ** 2) + jnp.sum(res.u ** 2), res

    (_, res), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(jnp.asarray(c),
                                                       jnp.asarray(x0))
    return res, grads


def port_solve(kernel, prev_ctrl, dtype=torch.float64, x_goal=None,
               slew=SLEW, requires_grad=False):
    x0, x_ref, u_ref, Cd, c = (torch.tensor(a, dtype=dtype)
                               for a in tracking_problem())
    c.requires_grad_(requires_grad)
    x0.requires_grad_(requires_grad)
    bounds = (Bounds(u_lo=(-3.0,), u_hi=(3.0,)) if kernel == "fused"
              else Bounds(u_lo=torch.tensor([-3.0], dtype=dtype),
                          u_hi=torch.tensor([3.0], dtype=dtype)))
    res = sqp_mpc.solve(
        Pendulum(), DiagQuadCost(Cd=Cd, c=c), x0, bounds, u_ref, x_ref,
        sqp_mpc.SQPConfig(qp_iter=2, qp=trajqp.TrajQPConfig(kernel=kernel)),
        differentiable=True, slew_rate_penalty=slew,
        prev_ctrl=None if prev_ctrl is None else torch.tensor(
            prev_ctrl, dtype=dtype), x_goal=x_goal)
    return res, (c, x0)


@pytest.fixture(scope="module", params=["no_prev", "prev"])
def jax_scan(request):
    prev = None if request.param == "no_prev" else PREV
    return prev, jax_loss_and_solve("scan", prev)


def test_scan_value_and_gradient_match_jax(jax_scan):
    prev, (ref, grads) = jax_scan
    got, inputs = port_solve("scan", prev, requires_grad=True)
    for name in ("x", "u", "cost"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-6, name
    ((got.x ** 2).sum() + (got.u ** 2).sum()).backward()
    for name, t_, g in zip(("c", "x0"), inputs, grads):
        assert float(np.abs(np.asarray(g)).max()) > 0, name
        assert _rel(t_.grad, g) <= 1e-6, name


def test_fused_value_matches_jax(jax_scan):
    """The fused path (K4's plain version on the CPU, the augmented
    (5, 3, 1) problem) against the JAX scan solve of the same problem."""
    prev, (ref, _) = jax_scan
    got, _ = port_solve("fused", prev)
    for name in ("x", "u", "cost"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-5, name


def test_float32_matches_float64(jax_scan):
    prev, (ref, _) = jax_scan
    got, _ = port_solve("scan", prev, dtype=torch.float32)
    for name in ("x", "u"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-2, name


def test_slew_penalty_smooths_controls():
    """tests/test_sqp_mpc.py:90's criterion on the port: the penalized
    solve's slew energy Σ‖u_t − u_{t−1}‖² is below 0.2× the unpenalized
    solve's, and prev_ctrl pulls u_0 toward itself."""
    energy = lambda u: float(((u[:, 1:] - u[:, :-1]) ** 2).sum())
    plain, _ = port_solve("scan", None, slew=None)
    slew, _ = port_solve("scan", None)
    prev, _ = port_solve("scan", PREV)
    assert energy(slew.u) < 0.2 * energy(plain.u)
    gap = lambda r: float((r.u[:, 0] - torch.tensor(PREV)).abs().mean())
    assert gap(prev) < gap(slew)


def test_slew_and_goal_compose_match_jax():
    """tests/test_sqp_mpc.py:144 on both packages: the goal term is applied
    before the augmentation and survives it (x_T within 1e-4 of the goal),
    Integrator, T 20, qp_iter 5, s 5, prev_ctrl 0, goal weight 1e8."""
    x0 = np.array([[2.0, 0.0]])
    Cd = np.broadcast_to([1.0, 1.0, 0.01], (1, 20, 3)).copy()
    kw = dict(differentiable=False, slew_rate_penalty=5.0,
              goal_weight=1e8)
    ref = jax_sqp.solve(
        JaxIntegrator(nx=2, nu=1, dt=0.1),
        JaxDiagQuadCost(Cd=jnp.asarray(Cd), c=jnp.zeros((1, 20, 3))),
        jnp.asarray(x0), JaxBounds(u_lo=jnp.array([-5.0]),
                                   u_hi=jnp.array([5.0])),
        jnp.zeros((1, 20, 1)), cfg=jax_sqp.SQPConfig(qp_iter=5),
        prev_ctrl=jnp.zeros((1, 1)), x_goal=jnp.zeros(2), **kw)
    got = sqp_mpc.solve(
        Integrator(nx=2, nu=1, dt=0.1),
        DiagQuadCost(Cd=torch.tensor(Cd), c=torch.zeros(1, 20, 3,
                                                       dtype=torch.float64)),
        torch.tensor(x0), Bounds(u_lo=torch.tensor([-5.0]).double(),
                                 u_hi=torch.tensor([5.0]).double()),
        torch.zeros(1, 20, 1, dtype=torch.float64),
        cfg=sqp_mpc.SQPConfig(qp_iter=5),
        prev_ctrl=torch.zeros(1, 1, dtype=torch.float64),
        x_goal=torch.zeros(2, dtype=torch.float64), **kw)
    assert float(got.x[0, -1].abs().max()) < 1e-4
    for name in ("x", "u"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= 1e-5, name


def test_affine_dynamics_ignore_the_slew():
    """LinDx dynamics take no augmentation (as in the JAX package): the
    penalty changes nothing."""
    x0, x_ref, u_ref, Cd, c = (torch.tensor(a) for a in tracking_problem())
    rng = np.random.RandomState(3)
    F = torch.tensor(np.concatenate(
        [np.eye(2) + 0.05 * rng.randn(B, T - 1, 2, 2),
         0.1 * rng.randn(B, T - 1, 2, 1)], -1))
    dyn = LinDx(F=F, f=torch.tensor(0.05 * rng.randn(B, T - 1, 2)))
    bounds = Bounds(u_lo=torch.tensor([-3.0]).double(),
                    u_hi=torch.tensor([3.0]).double())
    cfg = sqp_mpc.SQPConfig(qp_iter=2)
    cost = DiagQuadCost(Cd=Cd, c=c)
    a = sqp_mpc.solve(dyn, cost, x0, bounds, u_ref, x_ref, cfg)
    b = sqp_mpc.solve(dyn, cost, x0, bounds, u_ref, x_ref, cfg,
                      slew_rate_penalty=SLEW)
    assert torch.equal(a.u, b.u) and torch.equal(a.x, b.x)
