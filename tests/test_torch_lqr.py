"""The port's solvers/lqr.py and TrackingMPC's terminal cost against the JAX
package's, on the CPU in float64 (JAX with x64 on, tests/conftest.py).

``dare`` and ``lqr_gain`` at (nx, nu) = (2, 1), (4, 2), (6, 1) against the
JAX package's and scipy's ``solve_discrete_are``: within 1e-9 of P's
largest entry (the fixed point stops once no entry moves by more than
1e-9, so against scipy its small entries can sit ~1e-8 off relative to
themselves; against the JAX package's, the same iteration in float64,
they agree to rounding). ``terminal_value_cost`` for the 2-link cartpole's
stabilize goal and for the quadrotor at its hover thrust against the JAX
function, relative 1e-9; ``cost_with_terminal`` and ``make_policy``'s
terminal P from ``--terminal_lqr`` against the JAX package's."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_qp_mpc_tpu.envs import make_env as jax_make_env
from diff_qp_mpc_tpu.learning import train as jax_train
from diff_qp_mpc_tpu.learning.policies import TrackingMPC as JaxTrackingMPC
from diff_qp_mpc_tpu.solvers import lqr as jax_lqr
from diff_qp_mpc_tpu_torch.envs import make_env
from diff_qp_mpc_tpu_torch.learning import train
from diff_qp_mpc_tpu_torch.learning.policies import TrackingMPC
from diff_qp_mpc_tpu_torch.solvers import lqr

RTOL = 1e-9


def _random_stabilizable(nx, nu, seed):
    """tests/test_lqr.py's systems: a stable A with one unstable mode."""
    rng = np.random.RandomState(seed)
    A = rng.randn(nx, nx)
    A = 0.9 * A / np.max(np.abs(np.linalg.eigvals(A)))
    A[0, 0] += 0.4
    return A, rng.randn(nx, nu)


@functools.lru_cache(maxsize=None)
def _jax_cp2_P():
    """The JAX package's terminal P for cp2's stabilize goal with zero
    controls and R = tracking_r 0.01 (the cp2 ip checkpoints')."""
    jenv = jax_make_env("cartpole2link", stabilization=True)
    return np.asarray(jax_lqr.terminal_value_cost(
        jenv.model, jenv.goal, None, np.asarray(jenv.Qlqr, np.float64),
        np.full(1, 0.01)))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("nx,nu,seed", [(2, 1, 0), (4, 2, 1), (6, 1, 2)])
def test_dare_and_gain_match_jax_and_scipy(nx, nu, seed):
    from scipy.linalg import solve_discrete_are

    A, B = _random_stabilizable(nx, nu, seed)
    Q, R = np.eye(nx), 0.1 * np.eye(nu)
    P = lqr.dare(A, B, Q, R)
    assert P.dtype == torch.float64
    _close(P, jax_lqr.dare(jnp.asarray(A), jnp.asarray(B), jnp.asarray(Q),
                           jnp.asarray(R)))
    _close(P, solve_discrete_are(A, B, Q, R))
    K, P2 = lqr.lqr_gain(A, B, Q, R)
    jK, jP = jax_lqr.lqr_gain(jnp.asarray(A), jnp.asarray(B),
                              jnp.asarray(Q), jnp.asarray(R))
    _close(K, jK)
    _close(P2, jP)
    assert np.max(np.abs(np.linalg.eigvals(A - B @ K.numpy()))) < 1.0


@pytest.mark.parametrize("env_name,kw", [
    ("cartpole2link", {"stabilization": True}), ("rexquadrotor", {})],
    ids=["cp2", "quadrotor"])
def test_terminal_value_cost_matches_jax(env_name, kw):
    """cp2's stabilize goal with zero controls, R = tracking_r 0.01 (the
    cp2 ip checkpoints'); the quadrotor at the origin with its hover
    thrust as u_goal (P from the model's Jacobian there)."""
    env, jenv = make_env(env_name, **kw), jax_make_env(env_name, **kw)
    Q = np.asarray(jenv.Qlqr, np.float64)
    R = np.full(env.nu, 0.01)
    goal = np.asarray(getattr(jenv, "goal", np.zeros(env.nx)))
    hover = hasattr(env.model, "hover_thrust")
    ug = env.model.hover_thrust() if hover else None
    jug = jenv.model.hover_thrust() if hover else None
    P = lqr.terminal_value_cost(env.model, goal, ug, Q, R)
    jP = (_jax_cp2_P() if env_name == "cartpole2link" else
          jax_lqr.terminal_value_cost(jenv.model, goal, jug, Q, R))
    assert P.dtype == torch.float64 and P.shape == (env.nx, env.nx)
    _close(P, jP)
    assert torch.equal(P, P.T)
    if env_name == "cartpole2link":
        assert float(P.abs().max()) > 1e5  # the stiff tail really matters


def _tracking(solver_type="ip"):
    env, jenv = (f("cartpole2link", stabilization=True)
                 for f in (make_env, jax_make_env))
    terminal_P = tuple(tuple(float(v) for v in row) for row in _jax_cp2_P())
    kw = dict(T=5, Q=(1.0,) * 6, R=(0.01,), u_lo=(-250.0,), u_hi=(250.0,),
              solver_type=solver_type, terminal_P=terminal_P)
    return (TrackingMPC(model=env.model, **kw),
            JaxTrackingMPC(model=jenv.model, **kw))


def test_cost_with_terminal_matches_jax():
    ours, ref = _tracking()
    xu = np.random.RandomState(0).randn(3, 5, 7)
    got = ours.cost_with_terminal(torch.tensor(xu))
    want = ref.cost_with_terminal(jnp.asarray(xu))
    _close(got.C, want.C, 1e-15)
    _close(got.c, want.c, 1e-15)
    # P sits on the last stage's state block only
    assert torch.equal(got.C[:, :-1], torch.diag_embed(torch.tensor(
        (1.0,) * 6 + (0.01,), dtype=torch.float64)).expand(3, 4, 7, 7))


def test_terminal_P_requires_the_ip_path():
    ours, _ = _tracking(solver_type="al")
    x = torch.zeros(2, 6, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ip"):
        ours.solve(x, torch.zeros(2, 5, 6, dtype=torch.float64),
                   torch.zeros(2, 5, 1, dtype=torch.float64),
                   ours.init_state(2, torch.float64))


def test_make_policy_builds_terminal_P_from_terminal_lqr():
    """``--terminal_lqr`` with the cp2 ip checkpoints' flags: the port's
    tracker carries the JAX package's P (tracking_r applied to R)."""
    argv = ["--env", "cartpole2link", "--stabilization", "--deq",
            "--solver_type", "ip", "--tracking_r", "0.01", "--terminal_lqr",
            "--T", "5"]
    ours = train.make_policy(train.build_parser().parse_args(argv),
                             make_env("cartpole2link", stabilization=True))
    ref = jax_train.make_policy(jax_train.build_parser().parse_args(argv),
                                jax_make_env("cartpole2link",
                                             stabilization=True))
    assert ours.tracking.R == ref.tracking.R == (0.01,)
    _close(np.asarray(ours.tracking.terminal_P),
           np.asarray(ref.tracking.terminal_P))
    plain = train.make_policy(train.build_parser().parse_args(argv[:-3]),
                              make_env("cartpole2link", stabilization=True))
    assert plain.tracking.terminal_P is None
