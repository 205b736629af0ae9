"""The quadrotor (nx 12, nu 4) on the port's interior-point paths against
the JAX package, float64 on the CPU (the port's K3 and K4 run their plain
versions here):
  - K4's plain version (``fused_trajqp_solve_reference``, the fused path's
    solve) at the quadrotor's ip shape (5, 12, 4) and its slew shape
    (5, 16, 4), against the JAX package's scan IPM;
  - the ip DEQ-MPC policy (B 4, hdim 16, deq_iter 2, qp_iter 1, seeded
    weights): every iterate of the port's scan and fused paths, and one
    training step's loss and gradient through the final QP's implicit
    backward, against the JAX package's scan path;
  - the slew-rate option (``sqp_mpc.solve(slew_rate_penalty=...)``) on hover
    tracking problems: the value and the gradient on the scan path, the
    value on the fused path.

The JAX package's Pallas K4 in interpret mode runs for minutes at these
shapes on the CPU, so its scan IPM is the oracle, to which its own
tests/test_trajqp_fused.py holds its kernel. K4's corner semantics (u
clipped again inside the box, σ's floor, the best-total select) move a
solve by at most 3.4e-10 at cp2's shape; here K4's plain version reads
≤ 4.4e-16 on random box QPs at both shapes (held to 1e-9, K4's float64
tolerance). The policy and the slew solves are held as the cp2 ip and the
pendulum's slew tests hold theirs: every iterate within 1e-6 of its largest
entry, gradients within 1e-6 relative (the SQP line search's near-ties).
Each case traces its JAX side once, jitted."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, rel_err, t
from diff_qp_mpc_tpu.core.types import Bounds as JaxBounds
from diff_qp_mpc_tpu.core.types import DiagQuadCost as JaxDiagQuadCost
from diff_qp_mpc_tpu.solvers import sqp_mpc as jax_sqp
from diff_qp_mpc_tpu.solvers import trajqp as jax_trajqp
from diff_qp_mpc_tpu_torch.benchmarks import k2_models
from diff_qp_mpc_tpu_torch.core.types import Bounds, DiagQuadCost
from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda
from diff_qp_mpc_tpu_torch.solvers import sqp_mpc, trajqp

TOL = 1e-6
K4_TOL = 1e-9
BOX = 1.5
HOVER_BOX = ((0.0,) * 4, (20.0,) * 4)


def _random_qp(B, T, nx, nu, seed):
    """tests/test_trajqp_fused.py's random box QP, and a cold start: u at
    the box midpoint 0, x its rollout."""
    n = nx + nu
    rng = np.random.RandomState(seed)
    M = rng.randn(B, T, n, n)
    C, c, A, Bm, f, x0 = (0.1 * M @ M.transpose(0, 1, 3, 2) + np.eye(n),
                          0.3 * rng.randn(B, T, n),
                          np.eye(nx) + 0.1 * rng.randn(B, T - 1, nx, nx),
                          0.3 * rng.randn(B, T - 1, nx, nu),
                          0.1 * rng.randn(B, T - 1, nx),
                          0.5 * rng.randn(B, nx))
    xs = [x0]
    for k in range(T - 1):
        xs.append(np.einsum("bij,bj->bi", A[:, k], xs[-1]) + f[:, k])
    return C, c, A, Bm, f, x0, np.stack(xs, 1), np.zeros((B, T, nu))


@pytest.mark.parametrize("nx,nu", [(12, 4), (16, 4)])
def test_k4_plain_matches_jax_scan_ipm(nx, nu):
    arrays = _random_qp(8, 5, nx, nu, seed=nx)
    cfg = jax_trajqp.TrajQPConfig(max_iter=12, reg=1e-9)
    ref = jax.jit(lambda *a: jax_trajqp.solve(
        *a[:6], JaxBounds(u_lo=jnp.full((nu,), -BOX),
                          u_hi=jnp.full((nu,), BOX)), cfg, *a[6:]))(
        *(j(a) for a in arrays))
    got = trajqp_fused_cuda.fused_trajqp_solve(
        *(t(a) for a in arrays), (-BOX,) * nu, (BOX,) * nu, max_iter=12,
        reg=1e-9)
    names = ("x", "u", "lam", "z_hi", "z_lo", "s_hi", "s_lo")
    for name, g in zip(names, got):
        want = np.asarray(getattr(ref, name))
        err = float(np.abs(npy(g) - want).max()) / max(
            1.0, float(np.abs(want).max()))
        assert err <= K4_TOL, (name, err)
    assert float(got[1].abs().max()) <= BOX + 1e-9


# ------------------------------------------------ the ip policy ----
def _policy_argv(fused):
    return (["--env", "rexquadrotor", "--deq", "--deq_iter", "2", "--bsz",
             "4", "--T", "5", "--hdim", "16", "--qp_solve", "--solver_type",
             "ip", "--qp_iter", "1", "--deq_out_type", "1",
             "--policy_out_type", "1"] + (["--fused"] if fused else []))


def _window():
    """4 windows of the quadrotor's expert data, T 5."""
    from diff_qp_mpc_tpu_torch.learning import data

    batch = data.sample_window_batch(
        data.load_expert_pickle("data/expert_traj_mpc-RexQuadrotor-v0_new"
                                ".pkl"), 4, 5, np.random.RandomState(0),
        use_native=False)
    return tuple(batch[k] for k in ("state", "action", "mask"))


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The JAX package's ip policy (scan path, float64) with seeded
    weights: its parameters, its iterates from the windows' first states,
    and the DEQ-MPC loss on the windows with its gradient
    (jax.value_and_grad, the iterates as aux)."""
    from diff_qp_mpc_tpu.envs import make_env
    from diff_qp_mpc_tpu.learning import losses as jax_losses
    from diff_qp_mpc_tpu.learning import train as jax_train

    args = jax_train.build_parser().parse_args(_policy_argv(fused=False))
    jpol = jax_train.make_policy(args, make_env("rexquadrotor"))
    gt_s, gt_a, mask = _window()
    params = jax.jit(lambda: jpol.init(jax.random.PRNGKey(3),
                                       j(gt_s[:, 0]), qp_solve=False))()

    def jloss(prm):
        its, _ = jpol.apply(prm, j(gt_s[:, 0]), qp_solve=True)
        return jax_losses.compute_loss_deqmpc(
            1, j(gt_s), j(gt_a), j(mask), its)[0], its

    (jl, jits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    iterates = [(np.asarray(it.states), np.asarray(it.actions))
                for it in jits]
    return params, iterates, float(jl), jg


def _port_policy(fused):
    from diff_qp_mpc_tpu_torch.envs import make_env
    from diff_qp_mpc_tpu_torch.learning import train
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    args = train.build_parser().parse_args(_policy_argv(fused)
                                           + ["--device", "cpu"])
    pol = train.make_policy(args, make_env("rexquadrotor")).double()
    params = jax.tree.map(np.asarray, _jax_run()[0])
    pol.load_state_dict(params_from_flax(params["params"]))
    assert pol.tracking.sqp_cfg.qp.kernel == ("fused" if fused else "scan")
    return pol


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_ip_policy_forward_matches_jax(fused):
    _, jits, _, _ = _jax_run()
    with torch.no_grad():
        its, _ = _port_policy(fused)(t(_window()[0][:, 0]))
    assert len(its) == len(jits) == 2
    for k, (a, (states, actions)) in enumerate(zip(its, jits)):
        for got, ref in ((a.states, states), (a.actions, actions)):
            assert rel_err(got, ref) <= TOL, (k, rel_err(got, ref))
    u = npy(its[-1].actions)  # the box [0, 20]
    assert u.min() >= -1e-9 and u.max() <= 20.0 + 1e-9


@pytest.mark.parametrize("fused", [False, True], ids=["scan", "fused"])
def test_ip_training_gradient_matches_jax(fused):
    """One training step's DEQ-MPC loss and its gradient with respect to
    every parameter (through the final QP's implicit backward, one Riccati
    solve), against jax.value_and_grad of the JAX scan path."""
    from diff_qp_mpc_tpu_torch.learning import losses
    from diff_qp_mpc_tpu_torch.utils.checkpoint import params_from_flax

    gt_s, gt_a, mask = _window()
    _, _, jl, jg = _jax_run()
    jgrads = params_from_flax(jax.tree.map(np.asarray, jg)["params"])
    pol = _port_policy(fused)
    its, _ = pol(t(gt_s[:, 0]))
    loss = losses.compute_loss_deqmpc(1, t(gt_s), t(gt_a), t(mask), its)[0]
    assert abs(float(loss.detach()) - jl) <= TOL * abs(jl)
    grads = torch.autograd.grad(loss, list(pol.parameters()),
                                allow_unused=True)
    for (name, _), g in zip(pol.named_parameters(), grads):
        ref = jgrads[name]
        if float(ref.abs().max()) == 0:  # the cell's state-update weights
            assert g is None or float(g.abs().max()) == 0, name
            continue
        assert rel_err(g, ref) <= TOL, name


# --------------------------------------------------- the slew option ----
SLEW = 50.0


def _hover_problem():
    """k2_models' quadrotor hover problems (B 4, T 5): x0 a random pose,
    Cd = (Q, R), c tracking hover, u_init the hover thrust, x_init its
    rollout; prev_ctrl the hover thrust less 1."""
    model, Cd, c, x0, _, _, xi, ui = k2_models.problem(
        "quadrotor", 4, 5, torch.float64, seed=7, device="cpu")
    return model, Cd, c, x0, xi, ui, ui[:, 0] - 1.0


@functools.lru_cache(maxsize=None)
def _jax_slew():
    """The JAX package's slew solve on the hover problems (scan, qp_iter 1):
    the loss Σ x² + Σ u², its gradient w.r.t. (c, x0), the solution."""
    from diff_qp_mpc_tpu.envs import make_env

    jmodel = make_env("rexquadrotor").model
    _, Cd, c, x0, xi, ui, prev = _hover_problem()
    cfg = jax_sqp.SQPConfig(qp_iter=1, qp=jax_trajqp.TrajQPConfig(
        max_iter=12, reg=1e-9))
    box = JaxBounds(u_lo=jnp.array(HOVER_BOX[0]), u_hi=jnp.array(HOVER_BOX[1]))

    def loss(c_, x0_):
        res = jax_sqp.solve(jmodel, JaxDiagQuadCost(Cd=j(Cd), c=c_), x0_,
                            box, j(ui), j(xi), cfg, differentiable=True,
                            slew_rate_penalty=SLEW, prev_ctrl=j(prev))
        return jnp.sum(res.x ** 2) + jnp.sum(res.u ** 2), (res.x, res.u)

    (_, sol), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(j(c), j(x0))
    return [np.asarray(a) for a in sol], [np.asarray(g) for g in grads]


def _port_slew(kernel, requires_grad=False):
    model, Cd, c, x0, xi, ui, prev = _hover_problem()
    c.requires_grad_(requires_grad)
    x0.requires_grad_(requires_grad)
    box = (Bounds(u_lo=HOVER_BOX[0], u_hi=HOVER_BOX[1]) if kernel == "fused"
           else Bounds(u_lo=t(HOVER_BOX[0]), u_hi=t(HOVER_BOX[1])))
    res = sqp_mpc.solve(
        model, DiagQuadCost(Cd=Cd, c=c), x0, box, ui, xi,
        sqp_mpc.SQPConfig(qp_iter=1, qp=trajqp.TrajQPConfig(
            kernel=kernel, max_iter=12, reg=1e-9)),
        differentiable=True, slew_rate_penalty=SLEW, prev_ctrl=prev)
    return res, (c, x0)


def test_slew_scan_value_and_gradient_match_jax():
    (x_ref, u_ref), grads = _jax_slew()
    got, inputs = _port_slew("scan", requires_grad=True)
    assert rel_err(got.x, x_ref) <= TOL and rel_err(got.u, u_ref) <= TOL
    ((got.x ** 2).sum() + (got.u ** 2).sum()).backward()
    for name, inp, g in zip(("c", "x0"), inputs, grads):
        assert float(np.abs(g).max()) > 0, name
        assert rel_err(inp.grad, g) <= TOL, name


def test_slew_fused_value_matches_jax():
    """The fused path: the augmented (5, 16, 4) QP on K4's plain version
    (the warp layout's on the card)."""
    (x_ref, u_ref), _ = _jax_slew()
    got, _ = _port_slew("fused")
    assert rel_err(got.x, x_ref) <= TOL and rel_err(got.u, u_ref) <= TOL
