"""One step of each OptNet example of the port
(diff_qp_mpc_tpu_torch.examples) against the JAX example's loss from the
same numpy parameters: the loss and its gradient. The sudoku example's
puzzles are the JAX example's own (the same numpy RandomState draw, checked
here), its QPs at the example's sizes (nz 64, nineq 128, neq 40, bsz 24,
max_iter 18); the OptNet layer demo's at bsz 64, nz 4, nineq 6, neq 0.

Tolerances: float64 1e-8 relative to the largest entry (the same IPM and
backward; read ≤ 6.3e-16); sudoku in float32, the example's dtype, 1e-3
(18 IPM iterations of a 360×360 KKT system in float32 in two
implementations; read ≤ 2.6e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import npy
from diff_qp_mpc_tpu.solvers import qp as jax_qp
from diff_qp_mpc_tpu_torch.examples import optnet_qp_layer, sudoku_optnet


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(npy(got) - want).max()) / max(
        1e-30, float(np.abs(want).max()))


def test_optnet_layer_step_matches_jax():
    qp, x_in, z_target, W0 = optnet_qp_layer.make_problem(seed=0)
    Q, G, h, A, b = (jnp.asarray(npy(a)) for a in qp)
    cfg = jax_qp.QPConfig(max_iter=15)

    def jax_loss(W):
        z = jax_qp.qp_layer(Q, jnp.asarray(npy(x_in)) @ W.T, G, h, A, b, cfg)
        return jnp.mean((z - jnp.asarray(npy(z_target))) ** 2)

    loss_ref, g_ref = jax.value_and_grad(jax_loss)(jnp.asarray(npy(W0)))
    W = W0.clone().requires_grad_(True)
    loss = optnet_qp_layer.loss_fn(W, qp, x_in, z_target)
    loss.backward()
    assert _rel(loss, loss_ref) <= 1e-8
    assert _rel(W.grad, g_ref) <= 1e-8


def test_sudoku_puzzles_are_the_jax_examples():
    from examples import sudoku_optnet as jax_sudoku

    for a, b in zip(sudoku_optnet.make_dataset(24, 8,
                                               np.random.RandomState(0)),
                    jax_sudoku.make_dataset(24, 8,
                                            np.random.RandomState(0))):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("dtype,jdt,tol", [
    (torch.float64, jnp.float64, 1e-8), (torch.float32, jnp.float32, 1e-3)],
    ids=["f64", "f32"])
def test_sudoku_step_matches_jax(dtype, jdt, tol):
    X, Z = sudoku_optnet.make_dataset(24, 8, np.random.RandomState(0))
    A_p, b_p = (npy(a) for a in sudoku_optnet.initial_params(40))
    G1, h1 = (npy(a) for a in sudoku_optnet.box_rows(torch.float64))
    nz, cfg = sudoku_optnet.NZ, jax_qp.QPConfig(max_iter=18)

    def jax_loss(params):
        A_, b_ = params
        bsz = X.shape[0]
        z = jax_qp.qp_layer(
            jnp.broadcast_to(sudoku_optnet.EPS * jnp.eye(nz, dtype=jdt),
                             (bsz, nz, nz)),
            -jnp.asarray(X, jdt),
            jnp.broadcast_to(jnp.asarray(G1, jdt), (bsz,) + G1.shape),
            jnp.broadcast_to(jnp.asarray(h1, jdt), (bsz,) + h1.shape),
            jnp.broadcast_to(A_, (bsz,) + A_.shape),
            jnp.broadcast_to(b_, (bsz,) + b_.shape), cfg)
        return jnp.mean((z - jnp.asarray(Z, jdt)) ** 2)

    loss_ref, (gA, gb) = jax.value_and_grad(jax_loss)(
        (jnp.asarray(A_p, jdt), jnp.asarray(b_p, jdt)))
    params = [torch.tensor(a, dtype=dtype, requires_grad=True)
              for a in (A_p, b_p)]
    G, h = (torch.tensor(a, dtype=dtype) for a in (G1, h1))
    loss = sudoku_optnet.loss_fn(*params, torch.tensor(X, dtype=dtype),
                                 torch.tensor(Z, dtype=dtype), G, h)
    loss.backward()
    assert _rel(loss, loss_ref) <= tol
    assert params[0].grad.shape == A_p.shape
    assert _rel(params[0].grad, gA) <= tol
    assert _rel(params[1].grad, gb) <= tol
