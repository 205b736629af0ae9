"""The CosSin models, the legacy qpth encodings with (cos θ, sin θ) in the
state: ``PendulumCosSin`` (new in the port) and ``CartpoleCosSin``,
against the JAX package's. Their steps, and their Jacobians (one
forward-mode pass per input column through ``step_parts``, as K2's
functors in csrc/al_fused_cossin.cu run them) against jax.jacfwd of the
JAX step, float64 and float32, on states and controls drawn with numpy from
a seed, the controls on both sides of the clip and on it (where JAX's
max-then-min tangent is ½). One jitted JAX trace per case.

K2's functors themselves are held to these plain versions by
tests/test_torch_k2_host.py (the source built for the host), and K2's
plain version on them to the JAX package's interpreted Pallas kernel by
tests/test_torch_al_fused.py."""
import jax
import numpy as np
import pytest
import torch

from _torch_port_common import j, npy, t
from diff_qp_mpc_tpu import models as jm
from diff_qp_mpc_tpu_torch import models as tm
from diff_qp_mpc_tpu_torch.benchmarks import flops

# (JAX model, port model, the index of cos θ, the clip)
MODELS = {"pendulum_cossin": (jm.PendulumCosSin, tm.PendulumCosSin, 0, 2.0),
          "cartpole_cossin": (jm.CartpoleCosSin, tm.CartpoleCosSin, 2,
                              100.0)}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _states(name, B=32, seed=0):
    """x with (cos θ, sin θ) of θ drawn over the circle, the other
    coordinates N(0, 1); u drawn to twice the clip, its first rows on the
    clip and just inside it."""
    _, tmod, i, clip = MODELS[name]
    rng = np.random.RandomState(seed)
    x = rng.randn(B, tmod().nx)
    th = rng.uniform(-np.pi, np.pi, B)
    x[:, i], x[:, i + 1] = np.cos(th), np.sin(th)
    u = rng.uniform(-2 * clip, 2 * clip, (B, 1))
    u[:4, 0] = [clip, -clip, 0.5 * clip, -0.999 * clip]
    return x, u


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("name", list(MODELS))
def test_step_and_jacobians_match_jax(name, dtype):
    jmod, tmod = MODELS[name][0](), MODELS[name][1]()
    assert (tmod.nx, tmod.nu, tmod.nq, tmod.dt) == (jmod.nx, jmod.nu,
                                                    jmod.nq, jmod.dt)
    x, u = _states(name)
    step, (A, Bm) = jax.jit(lambda xx, uu: (jmod.step(xx, uu), jax.vmap(
        jax.jacfwd(jmod.step, argnums=(0, 1)))(xx, uu)))(j(x), j(u))
    x_next, (gA, gB) = tmod.jac(t(x, dtype), t(u, dtype))
    assert gA.dtype == gB.dtype == dtype
    np.testing.assert_allclose(npy(tmod.step(t(x, dtype), t(u, dtype))),
                               np.asarray(step), atol=TOL[dtype], rtol=0)
    for got, ref in ((x_next, step), (gA, A), (gB, Bm)):
        np.testing.assert_allclose(npy(got), np.asarray(ref),
                                   atol=TOL[dtype], rtol=0)


def test_pendulum_cossin_constants_fold_as_the_reference():
    """kernel_params folds −3g/(2l) and m·l² in double precision, as the
    JAX model's Python constants are; PARAMS names them in that order."""
    m = tm.PendulumCosSin(m=1.5, l=0.7, g=9.81)
    assert m.kernel_params() == (0.05, -3.0 * 9.81 / (2.0 * 0.7),
                                 1.5 * 0.7 ** 2, 2.0)
    assert len(m.PARAMS) == len(m.kernel_params())


@pytest.mark.parametrize("name", list(MODELS))
def test_functor_counts(name):
    """benchmarks.flops counts the functor's step and Jacobian by running
    step_parts on counting numbers: its atan2, cos and sin as three
    transcendental evaluations a step, the clip as none."""
    step, jac, step_sins, jac_sins = flops._k2_model_counts(name)
    n = MODELS[name][1]().nx + 1
    assert step_sins == 3 and jac_sins == n * 5
    assert step > 3 and jac > step
