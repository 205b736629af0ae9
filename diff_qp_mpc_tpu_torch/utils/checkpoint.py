"""Read the JAX package's flax msgpack checkpoints without flax or msgpack.

``load_msgpack`` decodes the subset of msgpack that flax's serializer
writes: maps, arrays, str, bin, ints, floats, nil and bool, plus flax's
extension types 1 (ndarray: msgpack of (shape, dtype name, C-order bytes))
and 3 (numpy scalar, the same encoding). It returns nested dicts and lists
with numpy leaves, as ``flax.serialization.msgpack_restore`` does.
``params_from_flax`` maps a DEQ-MPC policy's flax parameter tree onto the
port's ``state_dict``.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode(r: _Reader, raw: bool) -> Any:
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    fixed = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in fixed:
        return fixed[b]
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin
    if b in lengths:
        return bytes(r.take(r.unpack(lengths[b])))
    ext_len = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
    if b in ext_len:
        n = r.unpack(ext_len[b])
        return _ext(r.unpack(">b"), bytes(r.take(n)))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(fixext[b])))
    scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
               0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in scalars:
        return r.unpack(scalars[b])
    strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in strs:
        return _str(r, r.unpack(strs[b]), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    data = bytes(r.take(n))
    return data if raw else data.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> Dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        out[k] = _decode(r, raw)
    return out


def _ndarray(data: bytes) -> np.ndarray:
    # flax packs (shape, dtype name, bytes) and reads it back with raw=True
    shape, dtype_name, buf = loads(data, raw=True)
    dtype = np.dtype(dtype_name.decode() if isinstance(dtype_name, bytes)
                     else dtype_name)
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def loads(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object from ``data``."""
    r = _Reader(data)
    out = _decode(r, raw)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack "
                         "object")
    return out


def load_msgpack(path: str) -> Any:
    """The checkpoint at ``path`` as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        tree = loads(f.read())
    if isinstance(tree, dict) and any(
            isinstance(v, dict) and "__msgpack_chunked_array__" in v
            for v in tree.values()):
        raise ValueError("chunked (>1 GiB) arrays are not supported")
    return tree


# flax module path in a DEQ-MPC policy's tree -> port module path. In flax's
# DEQCell the outer LayerNorm is constructed before the inner one (on
# x + fc2(z₁)), so it is LayerNorm_1 and the inner one LayerNorm_2.
_DEQ_MODULES: Tuple[Tuple[str, str], ...] = (
    ("DEQLayer_0/Dense_0", "layer.inp"),
    ("DEQLayer_0/LayerNorm_0", "layer.inp_ln"),
    ("DEQLayer_0/DEQCell_0/Dense_0", "layer.cell.fc1"),
    ("DEQLayer_0/DEQCell_0/LayerNorm_0", "layer.cell.ln_z1"),
    ("DEQLayer_0/DEQCell_0/Dense_1", "layer.cell.fc2"),
    ("DEQLayer_0/DEQCell_0/LayerNorm_1", "layer.cell.ln_out"),
    ("DEQLayer_0/DEQCell_0/LayerNorm_2", "layer.cell.ln_inner"),
    ("DEQLayer_0/Dense_1", "layer.out"),
)


def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """DEQ-MPC policy parameters: flax tree (the dict holding
    ``DEQLayer_0``) -> the port policy's ``state_dict``. Dense kernels are
    [in, out] and are transposed; LayerNorm scale becomes weight."""
    state = {}
    for flax_path, name in _DEQ_MODULES:
        node = tree
        for key in flax_path.split("/"):
            node = node[key]
        if "kernel" in node:
            weight = np.asarray(node["kernel"]).T
        else:
            weight = np.asarray(node["scale"])
        state[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(weight))
        state[f"{name}.bias"] = torch.tensor(np.asarray(node["bias"]))
    return state


def load_policy_params(path: str) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a DEQ-MPC policy checkpoint written by the JAX
    trainer ({"params": {"params": {...}}, "opt_state": ...})."""
    return params_from_flax(load_msgpack(path)["params"]["params"])
