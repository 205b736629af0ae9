"""The port's msgpack reader and flax -> torch weight mapping
(diff_qp_mpc_tpu_torch.utils.checkpoint) against flax itself."""
import flax.linen as nn
import flax.serialization
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from _torch_port_common import CKPT, npy, t
from diff_qp_mpc_tpu.learning.deq import DEQCell as FlaxDEQCell
from diff_qp_mpc_tpu_torch.learning.deq import DEQCell
from diff_qp_mpc_tpu_torch.utils import checkpoint


def _assert_same_tree(a, b, path="/"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}{k}/")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}{i}/")
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b), path
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def test_committed_checkpoint_decodes_exactly_as_flax():
    """Every leaf of the committed checkpoint (params and opt_state), with
    its dtype and shape, as flax.serialization.msgpack_restore gives it."""
    data = open(CKPT, "rb").read()
    _assert_same_tree(checkpoint.loads(data),
                      flax.serialization.msgpack_restore(data))


_PAYLOADS = {
    "ints": {"pos": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                     2 ** 63], "neg": [-1, -32, -33, -128, -129, -32768,
                                       -32769, -2 ** 31 - 1, -2 ** 63]},
    "floats_nil_bool": {"f": [0.5, -1e300, float("inf")], "n": None,
                        "b": [True, False]},
    "str_bin": {"s": "x" * 31, "s8": "y" * 200, "s16": "z" * 70000,
                "b8": b"\x00" * 10, "b16": b"\x01" * 300},
    "long_array_map": {"a16": list(range(20)),
                       "m16": {str(i): i for i in range(20)}},
    "ndarrays": {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
                 "i32": np.array([[1, -2]], np.int32),
                 "scalar": np.float32(2.5), "i_scalar": np.int32(7),
                 "empty": np.zeros((0, 4), np.float64)},
}


@pytest.mark.parametrize("name", sorted(_PAYLOADS))
def test_msgpack_types_match_flax(name):
    """Each msgpack type and flax extension the reader covers."""
    data = flax.serialization.msgpack_serialize(_PAYLOADS[name])
    _assert_same_tree(checkpoint.loads(data),
                      flax.serialization.msgpack_restore(data))


def test_float32_scalar_and_truncated_input():
    data = msgpack.packb({"f": 1.5}, use_single_float=True)
    assert checkpoint.loads(data) == {"f": 1.5}
    with pytest.raises(ValueError):
        checkpoint.loads(data[:-1])
    with pytest.raises(ValueError):
        checkpoint.loads(data + b"\x00")


def test_deq_cell_layernorm_mapping():
    """flax names DEQCell's outer LayerNorm LayerNorm_1 and the inner one
    (on x + fc2(z1)) LayerNorm_2; with distinct random LayerNorm parameters
    the mapped torch cell must reproduce the flax cell."""
    hdim = 16
    rng = np.random.RandomState(0)
    x = rng.randn(4, hdim)
    z = rng.randn(4, hdim)
    cell = FlaxDEQCell(hdim)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(z))
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float64), params)
    ref = cell.apply(params, jnp.asarray(x), jnp.asarray(z))

    dense = {"kernel": np.zeros((2, 2)), "bias": np.zeros(2)}
    tree = {"DEQLayer_0": {"DEQCell_0": params["params"], "Dense_0": dense,
                           "Dense_1": dense,
                           "LayerNorm_0": {"scale": np.zeros(2),
                                           "bias": np.zeros(2)}}}
    prefix = "layer.cell."
    state = {k[len(prefix):]: v.double()
             for k, v in checkpoint.params_from_flax(tree).items()
             if k.startswith(prefix)}
    port = DEQCell(hdim).double()
    port.load_state_dict(state)
    with torch.no_grad():
        out = port(t(x), t(z))
    np.testing.assert_allclose(npy(out), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_params_from_flax_covers_the_policy():
    """The mapped checkpoint fills every parameter of the port's policy
    (load_state_dict is strict), with [out, in] Linear weights."""
    from _torch_port_common import policy_argv, torch_policy

    pol, _ = torch_policy(policy_argv())
    sd = checkpoint.load_policy_params(CKPT)
    assert set(sd) == set(pol.state_dict())
    raw = checkpoint.load_msgpack(CKPT)["params"]["params"]["DEQLayer_0"]
    np.testing.assert_array_equal(npy(sd["layer.inp.weight"]),
                                  raw["Dense_0"]["kernel"].T)
    assert tuple(sd["layer.out.weight"].shape) == (10, 128)
