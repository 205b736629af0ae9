"""Pendulum dynamics of the PyTorch port vs the JAX package: step,
step_parts, analytic and autodiff Jacobians, rollout, clips."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu.models import Pendulum as JaxPendulum
from diff_qp_mpc_tpu.models.base import angle_normalize as jax_wrap
from diff_qp_mpc_tpu_torch.models import DynamicsModel, Pendulum
from diff_qp_mpc_tpu_torch.models.base import angle_normalize

RNG = np.random.RandomState(0)
X = RNG.uniform([-4.0, -3.0], [4.0, 3.0], (16, 2))
U = RNG.uniform(-5.0, 5.0, (16, 1))


def test_step_and_step_parts():
    ref = JaxPendulum()(j(X), j(U))
    m = Pendulum()
    np.testing.assert_allclose(npy(m(t(X), t(U))), np.asarray(ref),
                               rtol=1e-14, atol=1e-14)
    parts = m.step_parts((t(X[:, 0]), t(X[:, 1])), (t(U[:, 0]),))
    np.testing.assert_allclose(npy(torch.stack(parts, -1)), np.asarray(ref),
                               rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("which", ["analytic", "jacfwd"])
def test_jacobians_match_jax(which):
    """The pendulum's analytic Jacobian (what kernel K2 evaluates) and the
    generic torch.func path of DynamicsModel, vs jax.jacfwd."""
    xn_ref, (A_ref, B_ref) = JaxPendulum().jac(j(X), j(U))
    m = Pendulum()
    fn = m.jac if which == "analytic" else \
        (lambda x, u: DynamicsModel.jac(m, x, u))
    xn, (A, B) = fn(t(X), t(U))
    for got, ref in ((xn, xn_ref), (A, A_ref), (B, B_ref)):
        np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=1e-13,
                                   atol=1e-13)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rollout(dtype):
    us = RNG.uniform(-3, 3, (8, 5, 1))
    ref = JaxPendulum().rollout(j(X[:8]), j(us))
    got = Pendulum().rollout(t(X[:8], dtype), t(us, dtype))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    np.testing.assert_allclose(npy(got), np.asarray(ref), rtol=tol, atol=tol)
    np.testing.assert_array_equal(npy(got[:, 0]), X[:8].astype(npy(got).dtype))


def test_angle_normalize_is_floored_modulo():
    """Python's % is floored, so negative angles wrap as torch.remainder
    wraps them (fmod would leave -4 at -4)."""
    a = np.array([-10.0, -4.0, -np.pi, -0.1, 0.0, 3.0, np.pi, 7.5])
    np.testing.assert_allclose(npy(angle_normalize(t(a))),
                               np.asarray(jax_wrap(j(a))), atol=1e-15)


def test_clips():
    m, jm = Pendulum(), JaxPendulum()
    np.testing.assert_array_equal(npy(m.action_clip(t(U))),
                                  np.asarray(jm.action_clip(j(U))))
    np.testing.assert_allclose(npy(m.state_clip(t(X))),
                               np.asarray(jm.state_clip(j(X))), atol=1e-15)
