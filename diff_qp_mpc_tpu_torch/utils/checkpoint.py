"""Read and write the JAX package's flax msgpack checkpoints without flax
or msgpack.

``load_msgpack`` decodes the subset of msgpack that flax's serializer
writes: maps, arrays, str, bin, ints, floats, nil and bool, plus flax's
extension types 1 (ndarray: msgpack of (shape, dtype name, C-order bytes))
and 3 (numpy scalar, the same encoding). It returns nested dicts and lists
with numpy leaves, as ``flax.serialization.msgpack_restore`` does.
``dumps`` encodes such a tree as ``flax.serialization.msgpack_serialize``
does, byte for byte. ``params_from_flax`` maps a flax parameter tree (by
default a DEQ-MPC policy's, else by a network's ``flax_modules()``) onto
the port's ``state_dict`` and ``params_to_flax`` back;
``save_checkpoint`` writes the trainer's checkpoint and its meta.json.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from diff_qp_mpc_tpu_torch.learning.deq import MLP_LAYER_MODULES, prefixed

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


def _pack_len(out: bytearray, n: int, small: Optional[Tuple[int, int]],
              codes: Tuple[int, int, int]) -> None:
    """A length header: the fix form ``small`` = (base, limit) below its
    limit, else the 8-, 16- or 32-bit form of ``codes`` (None where the
    type has no 8-bit form)."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _encode_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                               (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if v < 1 << top:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit in 64 bits")
    else:
        for code, fmt, top in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if v >= -(1 << top):
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit in 64 bits")


def _encode_ext(out: bytearray, code: int, data: bytes) -> None:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixext:
        out.append(fixext[len(data)])
    else:
        _pack_len(out, len(data), None, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    return dumps((list(a.shape), a.dtype.name, a.tobytes("C")))


def _encode(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, np.ndarray):
        _encode_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _encode_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    elif isinstance(v, int):
        _encode_int(out, v)
    elif isinstance(v, float):
        out += struct.pack(">Bd", 0xCB, v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _pack_len(out, len(data), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), (0x90, 16), (None, 0xDC, 0xDD))
        for item in v:
            _encode(out, item)
    elif isinstance(v, dict):
        _pack_len(out, len(v), (0x80, 16), (None, 0xDE, 0xDF))
        # flax flattens the tree first, which sorts each map's keys
        for k, item in sorted(v.items()):
            _encode(out, k)
            _encode(out, item)
    else:
        raise TypeError(f"cannot encode {type(v).__name__} as msgpack")


def dumps(tree: Any) -> bytes:
    """Encode nested dicts, lists and tuples of str, bytes, int, float,
    bool, None, numpy arrays and numpy scalars (flax's extension types 1
    and 3) as one msgpack object, map keys sorted. Arrays of 1 GiB or more (which flax
    splits into chunks) are refused."""
    out = bytearray()
    _encode(out, tree)
    return bytes(out)


def _check_size(tree: Any) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _check_size(v)
    elif isinstance(tree, np.ndarray) and tree.nbytes >= 1 << 30:
        raise ValueError("arrays of 1 GiB or more are not supported")


def load_msgpack(path: str) -> Any:
    """The checkpoint at ``path`` as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        tree = loads(f.read())
    if isinstance(tree, dict) and any(
            isinstance(v, dict) and "__msgpack_chunked_array__" in v
            for v in tree.values()):
        raise ValueError("chunked (>1 GiB) arrays are not supported")
    return tree


# a DEQ-MPC policy's tree with the mlp cell (the dict holding DEQLayer_0)
_DEQ_MODULES = prefixed(("DEQLayer_0", "layer"), MLP_LAYER_MODULES)


def params_from_flax(tree: Dict,
                     modules: Tuple[Tuple[str, str], ...] = _DEQ_MODULES
                     ) -> Dict[str, torch.Tensor]:
    """Parameters of a flax tree -> the port module's ``state_dict``, by
    ``modules``' (flax path, port path) pairs; by default a DEQ-MPC
    policy's with the mlp cell (the tree is the dict holding
    ``DEQLayer_0``; each network's ``flax_modules()`` gives its own). Dense
    kernels [in, out] are transposed to Linear weights [out, in], Conv
    kernels [width, in, out] to Conv1d weights [out, in, width]; LayerNorm
    and GroupNorm scales become weights; a path that names a parameter
    itself (the conv layer's ``time_emb``) is copied as it is."""
    state = {}
    for flax_path, name in modules:
        node = tree
        for key in flax_path.split("/"):
            node = node[key]
        if not isinstance(node, dict):
            state[name] = torch.tensor(np.asarray(node))
            continue
        if "kernel" in node:
            k = np.asarray(node["kernel"])
            weight = k.T if k.ndim == 2 else k.transpose(2, 1, 0)
        else:
            weight = np.asarray(node["scale"])
        state[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(weight))
        state[f"{name}.bias"] = torch.tensor(np.asarray(node["bias"]))
    return state


def params_to_flax(state: Dict[str, torch.Tensor],
                   modules: Tuple[Tuple[str, str], ...] = _DEQ_MODULES
                   ) -> Dict:
    """The inverse of ``params_from_flax``: the port module's
    ``state_dict`` -> the flax tree (by default the one holding
    ``DEQLayer_0``), numpy leaves of the state's dtype."""
    tree: Dict = {}
    for flax_path, name in modules:
        *parents, last = flax_path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        if name in state:  # a parameter itself
            node[last] = state[name].detach().cpu().numpy()
            continue
        node = node.setdefault(last, {})
        weight = state[f"{name}.weight"].detach().cpu().numpy()
        if last.startswith("Dense"):
            node["kernel"] = np.ascontiguousarray(weight.T)
        elif last.startswith("Conv"):
            node["kernel"] = np.ascontiguousarray(weight.transpose(2, 1, 0))
        else:
            node["scale"] = weight
        node["bias"] = state[f"{name}.bias"].detach().cpu().numpy()
    return tree


def save_checkpoint(path: str, state: Dict[str, torch.Tensor],
                    opt_state: Optional[Dict] = None,
                    meta: Optional[Dict] = None,
                    modules: Tuple[Tuple[str, str], ...] = _DEQ_MODULES
                    ) -> None:
    """Write a policy checkpoint as the JAX trainer lays it out:
    {"params": {"params": <flax tree>}, "opt_state": ...}, so that
    ``load_policy_params`` and flax's ``msgpack_restore`` both read it;
    ``modules`` is the policy's ``flax_modules()`` (default: the mlp
    DEQ-MPC policy's). The optimizer state is the port's own
    (``learning.optim.Adam``). ``meta`` goes to ``<path>.meta.json`` as the
    JAX trainer writes it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": {"params": params_to_flax(state, modules)}}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    _check_size(payload)
    with open(path, "wb") as f:
        f.write(dumps(payload))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str,
                    modules: Tuple[Tuple[str, str], ...] = _DEQ_MODULES
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """(policy ``state_dict``, the port's optimizer state or None) of a
    checkpoint written by ``save_checkpoint`` with the same ``modules``."""
    tree = load_msgpack(path)
    return (params_from_flax(tree["params"]["params"], modules),
            tree.get("opt_state"))


def load_policy_params(path: str,
                       modules: Tuple[Tuple[str, str], ...] = _DEQ_MODULES
                       ) -> Dict[str, torch.Tensor]:
    """``state_dict`` of a policy checkpoint written by the JAX trainer
    ({"params": {"params": {...}}, "opt_state": ...}); ``modules`` as in
    ``save_checkpoint``."""
    return params_from_flax(load_msgpack(path)["params"]["params"], modules)
