"""Build the CUDA kernels in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, and are built at first use; ``build`` compiles several
sources in parallel, one nvcc process each. ``load_from`` builds and loads
another checkout's source with the same flags, for timing a kernel beside
that checkout's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_loaded: Dict[str, ctypes.CDLL] = {}
#: seconds from the start of the last ``build`` that compiled ``name`` to
#: the end of its nvcc process
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current sources."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources that have no current library, all nvcc
    processes at once (each one's time in ``build_seconds``). Returns each
    name's compiler log (ptxas register and spill report); raises with the
    log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        with open(log, "w") as f:  # the compiler writes its report there
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=f, stderr=subprocess.STDOUT), tmp, out, log)
    failed = []
    while procs:
        for name, (proc, tmp, out, log) in list(procs.items()):
            if proc.poll() is None:
                continue
            build_seconds[name] = time.perf_counter() - t0
            del procs[name]
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n"
                              f"{log.read_text()}")
                log.unlink()
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("\n".join(failed))
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def load_from(tree: Path, name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` of the checkout at ``tree``, built
    with this tree's flags into ``build/against/`` and loaded."""
    src = Path(tree) / "diff_qp_mpc_tpu_torch" / "csrc" / f"{name}.cu"
    out = BUILD_DIR.parent / "against" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
