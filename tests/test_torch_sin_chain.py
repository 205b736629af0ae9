"""K5, the saturated sin chain (ops.sin_chain_cuda): its plain version
against the JAX kernel body benchmarks/roofline_fused.py::_sin_chain_kernel,
run through pl.pallas_call in interpret mode with the BlockSpecs of
transcendental_rate, and the wrapper's checks.

Tolerance: 1e-5 absolute on sums of up to 8 chains in (0, 1), float32, as
chip_smoke.py holds the CUDA kernel. sin is contractive on (0, 1], so the
ulp-level differences between XLA's and PyTorch's float32 sin do not grow
along the chain; the measured spread is 7.2e-7 (3 float32 ulps of a sum
near 2.9, n_streams 8, n_ops 16)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

# Importing the JAX script points JAX's persistent compilation cache at
# .jax_cache/ in the repo root, which .gitignore lists.
from benchmarks.roofline_fused import _sin_chain_kernel
from diff_qp_mpc_tpu_torch.ops import sin_chain_cuda

TOL = 1e-5


def pallas_sin_chain(x, n_ops):
    """The TPU kernel as transcendental_rate calls it, in interpret mode."""
    n_tiles, n_streams = x.shape[:2]
    kern = functools.partial(_sin_chain_kernel, n_ops, n_streams)
    return pl.pallas_call(
        kern,
        grid=(n_tiles,),
        in_specs=[pl.BlockSpec((1, n_streams, 8, 128),
                               lambda i: (i, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, 128), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n_tiles, 8, 128), jnp.float32),
        interpret=True,
    )(x)


def _inputs(n_tiles, n_streams, seed=0):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.1, 0.9, (n_tiles, n_streams, 8, 128)).astype(
        np.float32)


@pytest.mark.parametrize("n_ops", [16, 64])
@pytest.mark.parametrize("n_streams", [2, 8])
def test_plain_matches_pallas_kernel(n_streams, n_ops):
    x = _inputs(3, n_streams, seed=n_streams + n_ops)
    ref = np.asarray(pallas_sin_chain(jnp.asarray(x), n_ops))
    before = sin_chain_cuda.launches
    got = sin_chain_cuda.sin_chain(torch.from_numpy(x), n_ops)
    assert sin_chain_cuda.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (3, 8, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL)


def test_plain_sums_streams_in_order():
    """o = xs[0] + xs[1] + … in stream order, not a tree sum: with n_ops 0
    the result is that left fold of the inputs, bit for bit."""
    x = torch.from_numpy(_inputs(2, 5))
    want = x[:, 0]
    for s in range(1, 5):
        want = want + x[:, s]
    assert torch.equal(sin_chain_cuda.sin_chain_reference(x, 0), want)


@pytest.mark.parametrize("shape,dtype,n_ops,exc", [
    ((2, 2, 8, 128), torch.float64, 4, TypeError),
    ((2, 2, 8, 64), torch.float32, 4, ValueError),
    ((2, 8, 128), torch.float32, 4, ValueError),
    ((2, 9, 8, 128), torch.float32, 4, ValueError),
    ((2, 2, 8, 128), torch.float32, -1, ValueError),
], ids=["float64", "trailing-shape", "rank", "streams", "n_ops"])
def test_wrapper_rejects(shape, dtype, n_ops, exc):
    with pytest.raises(exc):
        sin_chain_cuda.sin_chain(torch.full(shape, 0.5, dtype=dtype), n_ops)


def test_wrapper_rejects_non_contiguous():
    x = torch.full((2, 8, 128, 2), 0.5).permute(0, 3, 1, 2)
    with pytest.raises(ValueError):
        sin_chain_cuda.sin_chain(x, 4)
