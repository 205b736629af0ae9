"""The port's msgpack reader and writer and its flax <-> torch weight
mapping (diff_qp_mpc_tpu_torch.utils.checkpoint) against flax itself, the
checkpoint and meta.json the port's trainer writes against the JAX
trainer's, and the flax initial distributions of the port's DEQ layer."""
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


@pytest.mark.parametrize("name", sorted(_PAYLOADS))
def test_msgpack_writer_matches_flax_bytes(name):
    """dumps gives flax.serialization.msgpack_serialize's bytes."""
    assert checkpoint.dumps(_PAYLOADS[name]) == \
        flax.serialization.msgpack_serialize(_PAYLOADS[name])


def _written(tmp_path):
    """The committed checkpoint's parameters and a port optimizer state,
    written by the port."""
    from diff_qp_mpc_tpu_torch.learning.train import Adam

    params = checkpoint.load_policy_params(CKPT)
    adam = Adam({k: v.clone() for k, v in params.items()}, 1e-3)
    adam.step({k: torch.full_like(v, 0.5) for k, v in params.items()})
    path = str(tmp_path / "ckpt.msgpack")
    checkpoint.save_checkpoint(path, params, adam.state_dict(),
                               meta={"fused": True})
    return path, params, adam.state_dict()


def test_port_write_read_round_trip_is_exact(tmp_path):
    path, params, opt_state = _written(tmp_path)
    state, opt = checkpoint.load_checkpoint(path)
    assert set(state) == set(params)
    for k, v in params.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k
    assert opt["count"] == opt_state["count"] == 1
    for moment in ("mu", "nu"):
        for k, v in opt_state[moment].items():
            np.testing.assert_array_equal(opt[moment][k], v)


def test_flax_reads_a_port_checkpoint(tmp_path):
    """flax's msgpack_restore of a port-written file has the committed
    checkpoint's params tree: keys, shapes, dtypes and values."""
    path, _, _ = _written(tmp_path)
    got = flax.serialization.msgpack_restore(open(path, "rb").read())
    ref = flax.serialization.msgpack_restore(open(CKPT, "rb").read())
    _assert_same_tree(got["params"], ref["params"])


def test_meta_json_matches_the_jax_trainer(tmp_path):
    """meta.json of the same flags, as each trainer writes it: equal, key
    order included, but for the device flag each package names its own way
    (--platform in JAX, --device in the port)."""
    from diff_qp_mpc_tpu.learning.train import build_parser as jax_parser
    from diff_qp_mpc_tpu.utils.checkpoint import save_checkpoint
    from diff_qp_mpc_tpu_torch.learning.train import build_parser

    argv = ["--env", "pendulum", "--deq", "--bsz", "256", "--qp_solve",
            "--fused", "--pretrain", "--grad_clip", "10", "--iters", "8000",
            "--deq_out_type", "2", "--policy_out_type", "2",
            "--expert_type", "sac", "--save", "--lr_decay"]
    jargs = vars(jax_parser().parse_args(argv))
    args = vars(build_parser().parse_args(argv))
    save_checkpoint(str(tmp_path / "jax.msgpack"), {"a": np.zeros(2)},
                    meta=jargs)
    checkpoint.save_checkpoint(str(tmp_path / "port.msgpack"),
                               checkpoint.load_policy_params(CKPT),
                               meta=args)
    jtext = (tmp_path / "jax.msgpack.meta.json").read_text()
    text = (tmp_path / "port.msgpack.meta.json").read_text()
    import json

    jmeta, meta = json.loads(jtext), json.loads(text)
    assert jmeta.pop("platform") is None and meta.pop("device") is None
    assert list(meta.items()) == list(jmeta.items())
    assert text.replace('"device": null', '"platform": null') == jtext


def test_deq_layer_starts_from_flax_distributions():
    """Dense kernels: truncated normal of variance 1/fan_in (std within 5%
    of 1/sqrt(fan_in), nothing beyond two standard deviations of the
    untruncated normal), zero biases; LayerNorm scale 1 and bias 0."""
    from diff_qp_mpc_tpu_torch.learning.deq import _TRUNC_STD, DEQLayer

    torch.manual_seed(0)
    layer = DEQLayer(nx=2, nu=1, nq=1, T=5, hdim=128, dt=0.05)
    n_linear = n_ln = 0
    for m in layer.requires_grad_(False).modules():
        if isinstance(m, torch.nn.Linear):
            n_linear += 1
            target = 1.0 / np.sqrt(m.in_features)
            assert abs(float(m.weight.std()) / target - 1.0) < 0.05
            assert float(m.weight.abs().max()) <= 2 * target / _TRUNC_STD
            assert float(m.bias.abs().max()) == 0.0
        elif isinstance(m, torch.nn.LayerNorm):
            n_ln += 1
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert float(m.bias.abs().max()) == 0.0
    assert (n_linear, n_ln) == (4, 4)
