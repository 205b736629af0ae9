"""The fused AL path of the PyTorch port (solvers.al_mpc.solve_fused and
solve_fused_stateful, K2's plain version in ops.al_fused_cuda) vs the JAX
package. The JAX fused path runs its Pallas kernel in interpret mode, as
tests/test_al_fused.py does.

Tolerances: float64 results agree to rounding unless a line search meets a
near-tie (candidate merits equal to within rounding, first minimum wins),
which moves a step by a power of two; the JAX Pallas kernel and the plain
version differ by up to ~1e-7 for that reason, so float64 is held to 1e-6.
In float32 the Newton systems amplify rounding (cond ~1e4 at R 0.01);
float32 alone moves a solve by ~5e-3, so float32 is held to 1e-2.

The other models (the integrator, Cartpole1L, CartpoleCosSin,
PendulumCosSin and Cartpole2L.pkg), as the JAX package's
tests/test_al_fused.py poses them
(B 8, budget al_iter 1, n_newton 2, n_ls 4): K2's plain version and
solve_fused against the JAX Pallas kernel in interpret mode, and for
Cartpole2L.pkg at T 5 (whose kernel takes minutes to trace in interpret
mode on the CPU) against the JAX scan solve, which the plain version matches
to ~3e-17 at this budget (the scan and fused paths share their line-search
rule); the port's scan solve on it too. Then the float32 breakdown
regression on Cartpole1L, the implicit gradient of solve_fused on
Cartpole1L against jax.grad, and a Cartpole1L DEQ-MPC policy forward and
training step against the JAX package's (hdim 32, T 5, float64, scan path
with its warm starts carried)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu import models as jm
from diff_qp_mpc_tpu.core import types as dq
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.ops.al_fused_pallas import fused_al_solve as jax_fused
from diff_qp_mpc_tpu.solvers import al_mpc as jax_al
from diff_qp_mpc_tpu_torch import models as tm
from diff_qp_mpc_tpu_torch.core.types import ALState, Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.models import Pendulum
from diff_qp_mpc_tpu_torch.ops import al_fused_cuda
from diff_qp_mpc_tpu_torch.solvers import al_mpc

B, T, NX, NU = 16, 5, 2, 1
N = NX + NU
TOL = {torch.float64: 1e-6, torch.float32: 1e-2}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
MAIN = dict(al_iter=2, n_newton=4, n_ls=20, rho_max=1e6, reg=1e-7)
SMALL = dict(al_iter=1, n_newton=2, n_ls=20, rho_max=1e4, reg=1e-5)


def _tracking(seed, dtype=torch.float64):
    """Tracking problems like the policy's: x0 in the env's range, a
    reference drifting from it, Cd = (Q, R), c = −Cd·τ_ref."""
    rng = np.random.RandomState(seed)
    x0 = rng.uniform([-np.pi, -1.0], [np.pi, 1.0], (B, NX))
    x_ref = x0[:, None] + np.cumsum(0.1 * rng.randn(B, T, NX), axis=1)
    xu_ref = np.concatenate([x_ref, np.zeros((B, T, NU))], -1)
    Cd = np.broadcast_to([10.0, 1.0, 0.01], (B, T, N)).copy()
    return dict(x0=x0, Cd=Cd, c=-Cd * xu_ref, x_ref=x_ref,
                u_ref=np.zeros((B, T, NU)))


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=tol, atol=tol,
                               err_msg=msg)


def _costs(p, dtype):
    return (DiagQuadCost(Cd=t(p["Cd"], dtype), c=t(p["c"], dtype)),
            dq.DiagQuadCost(Cd=j(p["Cd"], JDT[dtype]),
                            c=j(p["c"], JDT[dtype])))


def _bounds(dtype):
    return (Bounds(u_lo=t([-3.0], dtype), u_hi=t([3.0], dtype)),
            dq.Bounds(u_lo=j([-3.0], JDT[dtype]), u_hi=j([3.0], JDT[dtype])))


def _assert_state(st, jst, tol, msg):
    _close(st.x, jst.x, tol, msg)
    _close(st.u, jst.u, tol, msg)
    _close(st.rho, jst.rho, tol, msg)
    _close(st.lam.flat(), jst.lam.flat(), 10 * tol, msg)
    _close(st.hist_cost, jst.hist_cost, tol, msg)
    _close(st.hist_rho, jst.hist_rho, tol, msg)
    assert st.hist_filled == int(jst.hist_filled), msg


@pytest.mark.parametrize("budget", ["small", "main"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_fused_plain_matches_pallas_interpret(budget, dtype):
    """solve_fused on CPU tensors (K2's plain version) vs the JAX
    solve_fused with its Pallas kernel in interpret mode."""
    bud = SMALL if budget == "small" else MAIN
    p = _tracking(3)
    cost, jcost = _costs(p, dtype)
    bounds, jbounds = _bounds(dtype)
    u_init = np.zeros((B, T, NU))
    x, u, res = al_mpc.solve_fused(Pendulum(), cost, t(p["x0"], dtype),
                                   bounds, al_mpc.ALConfig(**bud),
                                   x_init=t(p["x_ref"], dtype),
                                   u_init=t(u_init, dtype))
    jx, ju, jres = jax_al.solve_fused(
        JaxPendulum(), jcost, j(p["x0"], JDT[dtype]), jbounds,
        jax_al.ALConfig(kernel="scan", interpret=True, **bud),
        x_init=j(p["x_ref"], JDT[dtype]), u_init=j(u_init, JDT[dtype]),
        differentiable=False)
    assert x.dtype == dtype
    for a, b in ((x, jx), (u, ju), (res, jres)):
        _close(a, b, TOL[dtype])


def test_fused_reference_with_warm_start_inputs():
    """fused_al_solve_reference with carried λ/ρ inputs and every output
    (xu, λ_dyn, λ_hi, λ_lo, res) vs the JAX kernel in interpret mode."""
    p = _tracking(4)
    rng = np.random.RandomState(5)
    lam = dict(lam_dyn=rng.randn(B, T - 1, NX), lam_hi=rng.rand(B, T, NU),
               lam_lo=rng.rand(B, T, NU))
    rho0 = rng.uniform(1.0, 100.0, B)
    x_init = p["x_ref"]
    u_init = rng.uniform(-4, 4, (B, T, NU))
    kw = dict(SMALL, rho_factor=10.0)
    got = al_fused_cuda.fused_al_solve(
        Pendulum(), t(p["Cd"]), t(p["c"]), t(p["x0"]), (-3.0,), (3.0,),
        t(x_init), t(u_init), rho0=t(rho0),
        **{k: t(v) for k, v in lam.items()}, **kw)
    ref = jax_fused(JaxPendulum(), j(p["Cd"]), j(p["c"]), j(p["x0"]),
                    np.array([-3.0]), np.array([3.0]), j(x_init), j(u_init),
                    interpret=True, rho0=j(rho0),
                    **{k: j(v) for k, v in lam.items()}, **kw)
    for a, b in zip(got, ref):
        _close(a, b, 1e-6)


def test_solve_fused_stateful_chain():
    """Two chained warm-started solve_fused_stateful calls (one kernel
    launch per AL iteration, history kept here) vs JAX."""
    m, jm = Pendulum(), JaxPendulum()
    bounds, jbounds = _bounds(torch.float64)
    bud = dict(SMALL, al_iter=2)
    cfg = al_mpc.ALConfig(**bud)
    jcfg = jax_al.ALConfig(kernel="scan", interpret=True, **bud)
    st = ALState.init(B, T, NX, NU, hist_len=3, dtype=torch.float64)
    jst = dq.ALState.init(B, T, NX, NU, hist_len=3, dtype=jnp.float64)
    for k in range(2):
        p = _tracking(20 + k)
        cost, jcost = _costs(p, torch.float64)
        x, u, st, stats = al_mpc.solve_fused_stateful(
            m, cost, t(p["x0"]), bounds, st, cfg)
        jx, ju, jst, jstats = jax_al.solve_fused_stateful(
            jm, jcost, j(p["x0"]), jbounds, jst, jcfg, differentiable=False)
        _close(x, jx, 1e-6, f"solve {k}")
        _close(u, ju, 1e-6, f"solve {k}")
        _close(stats.dyn_res, jstats.dyn_res, 1e-6, f"solve {k}")
        _assert_state(st, jst, 1e-6, f"solve {k}")


# ------------------------------------------------------- other models ----
# (JAX model, port model, T, the JAX reference: "kernel" the Pallas kernel
# in interpret mode, "scan" the scan solve)
MODELS = {
    "integrator": (lambda: jm.Integrator(dt=0.1),
                   lambda: tm.Integrator(dt=0.1), 3, "kernel"),
    "cartpole1l": (lambda: jm.Cartpole1L(dt=0.05, max_force=100.0),
                   lambda: tm.Cartpole1L(dt=0.05, max_force=100.0), 3,
                   "kernel"),
    "cossin": (jm.CartpoleCosSin, tm.CartpoleCosSin, 3, "kernel"),
    "pendulum_cossin": (jm.PendulumCosSin, tm.PendulumCosSin, 3, "kernel"),
    "cartpole2l_pkg": (jm.Cartpole2L.pkg, tm.Cartpole2L.pkg, 5, "scan"),
}
MODEL_B = 8
MODEL_BUDGET = dict(al_iter=1, n_newton=2, n_ls=4, rho_max=1e4, reg=1e-5)


def _model_problem(name):
    """x0 within ±0.3 of the goal (upright for the cartpoles), Cd = (10 on
    the states, 0.01 on u), c tracking the goal, box ±3, u_init 0."""
    jmod = MODELS[name][0]()
    nx, nu = jmod.nx, jmod.nu
    T = MODELS[name][2]
    goal = np.zeros(nx + nu)
    if name.startswith("cartpole"):
        goal[1] = np.pi
    rng = np.random.RandomState(0)
    x0 = goal[:nx] + rng.uniform(-0.3, 0.3, (MODEL_B, nx))
    if name.endswith("cossin"):  # (…, cos θ, sin θ, θ̇)
        th = rng.uniform(-0.3, 0.3, MODEL_B)
        x0[:, nx - 3], x0[:, nx - 2] = np.cos(th), np.sin(th)
    Cd = np.broadcast_to([10.0] * nx + [0.01] * nu,
                         (MODEL_B, T, nx + nu)).copy()
    return dict(x0=x0, Cd=Cd, c=-Cd * goal, T=T, nx=nx, nu=nu)


@functools.lru_cache(maxsize=None)
def _jax_model_solution(name, jdt):
    """(xu, res) of the JAX reference on ``_model_problem(name)``."""
    jmod = MODELS[name][0]()
    p = _model_problem(name)
    nu = p["nu"]
    x0 = j(p["x0"], jdt)
    u_init = jnp.zeros((MODEL_B, p["T"], nu), jdt)
    box = (jnp.full((nu,), -3.0, jdt), jnp.full((nu,), 3.0, jdt))
    if MODELS[name][3] == "kernel":
        w, _, _, _, res = jax_fused(
            jmod, j(p["Cd"], jdt), j(p["c"], jdt), x0, *box,
            jmod.rollout(x0, u_init), u_init, interpret=True,
            **MODEL_BUDGET)
        return np.asarray(w), np.asarray(res)
    st = dq.ALState.init(MODEL_B, p["T"], p["nx"], nu, dtype=jdt)
    # one trace: eager JAX re-traces the cartpole's dynamics at every call
    x, u, _, stats = jax.jit(lambda Cd, c, x0_: jax_al.solve(
        jmod, dq.DiagQuadCost(Cd=Cd, c=c), x0_,
        dq.Bounds(u_lo=box[0], u_hi=box[1]), st,
        jax_al.ALConfig(kernel="scan", **MODEL_BUDGET)))(
            j(p["Cd"], jdt), j(p["c"], jdt), x0)
    return (np.concatenate([np.asarray(x), np.asarray(u)], -1),
            np.asarray(stats.dyn_res))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", list(MODELS))
def test_fused_plain_matches_jax_per_model(name, dtype):
    """K2's plain version and solve_fused on each model against the JAX
    reference (on Cartpole2L.pkg also the port's scan solve)."""
    model = MODELS[name][1]()
    p = _model_problem(name)
    nx, nu = p["nx"], p["nu"]
    w_ref, res_ref = _jax_model_solution(name, JDT[dtype])
    x0, Cd, c = t(p["x0"], dtype), t(p["Cd"], dtype), t(p["c"], dtype)
    u_init = torch.zeros(MODEL_B, p["T"], nu, dtype=dtype)
    w, *_, res = al_fused_cuda.fused_al_solve_reference(
        model, Cd, c, x0, (-3.0,), (3.0,), model.rollout(x0, u_init),
        u_init, **MODEL_BUDGET)
    _close(w, w_ref, TOL[dtype], "plain version")
    _close(res, res_ref, TOL[dtype], "plain version's residual")
    box = Bounds(u_lo=(-3.0,), u_hi=(3.0,))
    x, u, res = al_mpc.solve_fused(model, DiagQuadCost(Cd=Cd, c=c), x0, box,
                                   al_mpc.ALConfig(**MODEL_BUDGET))
    _close(torch.cat([x, u], -1), w_ref, TOL[dtype], "solve_fused")
    if MODELS[name][3] == "scan":
        st = ALState.init(MODEL_B, p["T"], nx, nu, dtype=dtype)
        x, u, _, stats = al_mpc.solve(
            model, DiagQuadCost(Cd=Cd, c=c), x0,
            Bounds(u_lo=t([-3.0], dtype), u_hi=t([3.0], dtype)), st,
            al_mpc.ALConfig(**MODEL_BUDGET))
        _close(torch.cat([x, u], -1), w_ref, TOL[dtype], "scan solve")
        _close(stats.dyn_res, res_ref, TOL[dtype], "scan residual")
    assert float(np.abs(w_ref[..., nx:]).max()) > 1e-2  # a real solve


def test_cartpole1l_f32_breakdown_on_the_scan_path():
    """The JAX package's float32 regression (its tests/test_al_fused.py):
    Cartpole1L at its default dt 0.01, al_iter 8, ρ up to 1e6, reg 1e-6,
    where cond(H) passes float32's range. No NaN in the forward or the
    gradient, and the converged residual kept (dyn_res < 1e-4)."""
    B, T_ = 32, 5
    goal = np.array([0.0, np.pi, 0.0, 0.0, 0.0])
    rng = np.random.RandomState(0)
    x0 = t(goal[None, :4] + rng.uniform(-0.05, 0.05, (B, 4)), torch.float32)
    Cd = torch.tensor([1.0, 10.0, 0.1, 0.1, 1e-4]).expand(B, T_, 5)
    c = (-Cd * t(goal, torch.float32)).clone().requires_grad_()
    st = ALState.init(B, T_, 4, 1, dtype=torch.float32)
    cfg = al_mpc.ALConfig(al_iter=8, n_newton=4, n_ls=20, rho_max=1e6,
                          reg=1e-6)
    x, u, _, stats = al_mpc.solve(
        tm.Cartpole1L(), DiagQuadCost(Cd=Cd, c=c), x0,
        Bounds(u_lo=torch.tensor([-100.0]), u_hi=torch.tensor([100.0])), st,
        cfg, u_init=torch.zeros(B, T_, 1))
    (u ** 2).sum().backward()
    assert torch.isfinite(u).all(), "forward NaN"
    assert torch.isfinite(c.grad).all(), "backward NaN"
    assert float(stats.dyn_res.mean()) < 1e-4


def test_solve_fused_gradient_cartpole1l_matches_jax():
    """d(Σ W ⊙ xu)/d(Cd, c) through solve_fused on Cartpole1L against
    jax.grad through the JAX solve_fused (its kernel in interpret mode),
    float64, relative to each gradient's largest entry (1e-6, as the
    pendulum's in tests/test_torch_al_grad.py)."""
    name = "cartpole1l"
    p = _model_problem(name)
    W = np.random.RandomState(1).randn(*p["Cd"].shape)
    jmod, model = MODELS[name][0](), MODELS[name][1]()

    def jloss(Cd, c):
        x, u, _ = jax_al.solve_fused(
            jmod, dq.DiagQuadCost(Cd=Cd, c=c), j(p["x0"]),
            dq.Bounds(u_lo=j([-3.0]), u_hi=j([3.0])),
            jax_al.ALConfig(kernel="scan", interpret=True, **MODEL_BUDGET))
        return jnp.sum(j(W) * jnp.concatenate([x, u], -1))

    gCd_ref, gc_ref = jax.grad(jloss, argnums=(0, 1))(j(p["Cd"]), j(p["c"]))
    Cd, c = t(p["Cd"]).requires_grad_(), t(p["c"]).requires_grad_()
    x, u, _ = al_mpc.solve_fused(model, DiagQuadCost(Cd=Cd, c=c), t(p["x0"]),
                                 Bounds(u_lo=(-3.0,), u_hi=(3.0,)),
                                 al_mpc.ALConfig(**MODEL_BUDGET))
    (t(W) * torch.cat([x, u], -1)).sum().backward()
    for got, ref in ((Cd.grad, gCd_ref), (c.grad, gc_ref)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert float(np.abs(npy(got) - ref).max() / np.abs(ref).max()) \
            <= 1e-6


def test_cartpole1l_policy_and_train_step_match_jax():
    """A Cartpole1L DEQ-MPC policy (hdim 32, T 5, deq_iter 2, qp_iter 2,
    out_type 1, scan path with its warm starts carried, the parameters of
    one flax initialization) in float64: every iterate of the forward, the
    DEQ-MPC loss and its gradient against jax.grad, and one training step
    (clip, Adam) against optax. Held to 1e-6 relative to each quantity's
    largest entry, as tests/test_torch_train.py holds the pendulum's."""
    import optax

    from diff_qp_mpc_tpu.learning import losses as jax_losses
    from diff_qp_mpc_tpu.learning import train as jax_train
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import losses, train
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    argv = ["--env", "cartpole1link", "--deq", "--deq_iter", "2", "--bsz",
            "4", "--T", "5", "--hdim", "32", "--qp_solve", "--qp_iter", "2",
            "--deq_out_type", "1", "--policy_out_type", "1", "--grad_clip",
            "1", "--solver_carry", "on"]
    jargs = jax_train.build_parser().parse_args(argv)
    from diff_qp_mpc_tpu.envs import make_env as jax_make_env

    jpol = jax_train.make_policy(jargs, jax_make_env("cartpole1link"))
    rng = np.random.RandomState(0)
    x0 = np.array([0.0, np.pi, 0.0, 0.0]) + rng.uniform(-0.5, 0.5, (4, 4))
    gt_s = x0[:, None] + np.cumsum(0.05 * rng.randn(4, 5, 4), axis=1)
    gt_a = rng.uniform(-20.0, 20.0, (4, 5, 1))
    mask = np.ones((4, 5))
    params = jax.tree.map(lambda a: a.astype(jnp.float64), jpol.init(
        jax.random.PRNGKey(0), j(x0), qp_solve=False))

    def jloss(prm):
        its, _ = jpol.apply(prm, j(x0), qp_solve=True)
        return jax_losses.compute_loss_deqmpc(1, j(gt_s), j(gt_a), j(mask),
                                              its)[0], its

    (jl, jits), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    args = train.build_parser().parse_args(argv + ["--device", "cpu"])
    pol = train.make_policy(args, make_env("cartpole1link")).double()
    pol.load_state_dict(params_from_flax(params["params"]))
    its, _ = pol(t(x0))
    for k, (a, b) in enumerate(zip(its, jits)):
        for got, ref in ((a.states, b.states), (a.actions, b.actions)):
            ref = np.asarray(ref)
            assert float(np.abs(npy(got) - ref).max()
                         / np.abs(ref).max()) <= 1e-6, k
    loss = losses.compute_loss_deqmpc(1, t(gt_s), t(gt_a), t(mask), its)[0]
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    grads = torch.autograd.grad(loss, list(pol.parameters()))
    jgrads = params_from_flax(jg["params"])
    for (name, _), g in zip(pol.named_parameters(), grads):
        ref = jgrads[name]
        assert float((g - ref).abs().max() / ref.abs().max()) <= 1e-6, name
    # one training step on the same gradient: clip at 1, Adam at lr 1e-3
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    upd, _ = opt.update(jg, opt.init(params), params)
    jnew = params_from_flax(optax.apply_updates(params, upd)["params"])
    adam = train.Adam(dict(pol.named_parameters()), 1e-3)
    g = dict(zip(dict(pol.named_parameters()), grads))
    norm = train.global_norm(g)
    assert float(norm) > 1.0  # the clip acts
    adam.step(train.clip_by_global_norm(g, 1.0, norm))
    for name, v in pol.state_dict().items():
        ref = jnew[name]
        assert float((v - ref).abs().max() / ref.abs().max()) <= 1e-6, name


def test_kernel_table_names_the_built_models():
    """Each built model's entry, the folded constants its functor's make()
    takes (both CosSin models in one source), and the refusal of a model
    without a kernel. On the CPU any model with step and jac takes the
    plain version."""
    cp2, cp2_pkg = tm.Cartpole2L(), tm.Cartpole2L.pkg()
    assert al_fused_cuda.built_for(cp2) is al_fused_cuda.built_for(cp2_pkg)
    built = al_fused_cuda.built_for(cp2_pkg)
    assert built.symbol(torch.float32) == "al_fused_cartpole2l_f32"
    assert built.symbol(torch.float64, smem=True) == \
        "al_fused_cartpole2l_smem_f64"
    assert built.params(cp2) != built.params(cp2_pkg)
    assert len(built.params(cp2_pkg)) == len(tm.Cartpole2L.PARAMS)
    assert al_fused_cuda.BUILT[Pendulum].params(Pendulum()) == (
        0.05, 10.0, 1.0)
    with pytest.raises(NotImplementedError):
        al_fused_cuda.built_for(tm.Integrator(nx=4, nu=2))
    for model, name in ((tm.CartpoleCosSin(), "cartpole_cossin"),
                        (tm.PendulumCosSin(), "pendulum_cossin")):
        built = al_fused_cuda.built_for(model)
        assert (built.library, built.name) == ("al_fused_cossin", name)
        assert built.params(model) == model.kernel_params()
        assert len(built.params(model)) == len(type(model).PARAMS)
    assert al_fused_cuda.LIBRARIES.count("al_fused_cossin") == 1
    p = _model_problem("cossin")
    out = al_fused_cuda.fused_al_solve(
        tm.CartpoleCosSin(), t(p["Cd"]), t(p["c"]), t(p["x0"]), (-3.0,),
        (3.0,), t(np.repeat(p["x0"][:, None], p["T"], 1)),
        torch.zeros(MODEL_B, p["T"], 1, dtype=torch.float64),
        **MODEL_BUDGET)
    assert torch.isfinite(out[0]).all()
