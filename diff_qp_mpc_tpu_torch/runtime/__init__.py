"""The port's native host runtime: the expert-data window sampler
(``src/window_sampler.cpp``), built with g++ at first use and loaded with
ctypes.

The library goes to ``build/runtime/`` at the root of the checkout, named
by a hash of the sources, the flags and the host (``-march=native`` code
runs only on the machine that built it). A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library lives for the current sources, flags and host."""
    u = os.uname()
    h = hashlib.sha256(" ".join(CXX_FLAGS + [u.nodename, u.machine])
                       .encode())
    for src in sorted(SRC.glob("*.cpp")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwindow_sampler-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises with g++'s output if
    the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp),
         *(str(p) for p in sorted(SRC.glob("*.cpp")))],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for the window sampler:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fp = ctypes.POINTER(ctypes.c_float)
        lib.sample_window_batch.argtypes = [fp, fp, fp] \
            + [ctypes.c_int64] * 5 + [ctypes.c_uint64, fp, fp, fp]
        lib.sample_window_batch.restype = None
        _lib = lib
    return _lib


def sample_window_batch_native(data: Dict[str, np.ndarray], bsz: int,
                               T: int, seed: int) -> Dict[str, np.ndarray]:
    """``bsz`` random T-windows of ``data`` (state [N, nx], action [N, nu],
    mask [N]) with the cumulative mask, float32, deterministic in
    ``seed``."""
    lib = load()
    states = np.ascontiguousarray(data["state"], np.float32)
    actions = np.ascontiguousarray(data["action"], np.float32)
    mask = np.ascontiguousarray(data["mask"], np.float32)
    N, nx = states.shape
    nu = actions.shape[1]
    out_s = np.empty((bsz, T, nx), np.float32)
    out_a = np.empty((bsz, T, nu), np.float32)
    out_m = np.empty((bsz, T), np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.sample_window_batch(fp(states), fp(actions), fp(mask), N, nx, nu, T,
                            bsz, seed, fp(out_s), fp(out_a), fp(out_m))
    return {"state": out_s, "action": out_a, "mask": out_m}
