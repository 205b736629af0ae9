"""Kernel K2's CUDA source built for the host with g++, one thread per
element (G 1), to run the kernel's own arithmetic on the CPU.

    python -m diff_qp_mpc_tpu_torch.utils.k2_host --ckpt CKPT [--fused]
        [--contract [--exempt NAME,...]] [--merit contracted]
        [--episodes 64] [--max_steps 200]

evaluates a checkpoint through the evaluate entry point on the CPU with
every K2 launch going to the host build of its model's source (the CUDA
names stubbed: ``__device__`` and ``__global__`` empty, the ``<<<...>>>``
launch a loop over blocks and threads, ``__fmul_rn``/``__dmul_rn`` a
product g++ cannot contract). ``--contract`` lets g++ contract
multiply-adds into FMAs, as nvcc does by default; without it each operation
rounds as the plain PyTorch version's do. ``--exempt`` builds the named
device functions (e.g. ``merit_constraints``, ``rk4_value``,
``rk4_column``, ``chol``) apart and without contraction, to bisect which
function's contraction moves a result; ``--merit contracted`` builds the
models' merit as the pendulum's is (``kRoundedMerit`` false). The card's
own sin and cos and its contraction choices differ from g++'s, so this
shows how the kernel's arithmetic, not the card, moves a result. Needs g++;
each build lives under ``build/k2_host/`` while it loads.

The build defines ``K2_HOST``: the quadrotor's and the cartpoles' sources,
whose card kernel runs one warp per element with its blocks in shared
memory (``al_fused_warp.cuh``), then instantiate ``al_fused_common.cuh``'s
one-lane kernel with the same functor instead, so their functors' and
their merit's arithmetic run here too (not the warp layout's sums and
solves; ``utils/warp_emu.py`` runs those).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

import torch

from diff_qp_mpc_tpu_torch.ops import al_fused_cuda
from diff_qp_mpc_tpu_torch.utils.cuda_build import CSRC

BUILD = Path(__file__).resolve().parents[2] / "build" / "k2_host"
_STUB = """#pragma once
#include <cfloat>
#include <cmath>
#include <cstddef>
using std::atan2;
using std::cos;
using std::sin;
using std::sqrt;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline __attribute__((always_inline))
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct host_dim3 { unsigned x, y, z; };
static host_dim3 blockIdx, threadIdx, blockDim;
inline cudaError_t cudaGetLastError() { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int,
                                                          int) {
  *b = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return 0;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }
template <class T> inline T rounded_product(T a, T b) {
  T r = a * b;
  asm volatile("" : "+x"(r));  // no multiply-add across this
  return r;
}
inline float __fmul_rn(float a, float b) { return rounded_product(a, b); }
inline double __dmul_rn(double a, double b) {
  return rounded_product(a, b);
}
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
template <class K, class... A>
void host_launch(int blocks, int threads, K k, A... a) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      k(a...);
    }
}
"""
_LAUNCH = "al_fused_kernel<M, T, F, LOG2G><<<blocks, kThreads, 0, s>>>("
_loaded: Dict[tuple, ctypes.CDLL] = {}


_EXEMPT = ('__attribute__((noinline, optimize("fp-contract=off"))) ')


def build(library: str, contract: bool = False, exempt=(),
          rounded_merit: bool = True) -> Path:
    """The host build of ``csrc/<library>.cu`` (G 1 only: its shuffles are
    stubbed), with or without multiply-add contraction but in the device
    functions ``exempt``, in a new directory under ``build/k2_host/`` that
    the caller removes."""
    texts, found = {}, set()
    for f in list(CSRC.glob("*.cuh")) + [CSRC / f"{library}.cu"]:
        text = f.read_text()
        if f.name == "al_fused_common.cuh":
            if _LAUNCH not in text:
                raise RuntimeError("K2's launch line changed; update _LAUNCH")
            text = text.replace(_LAUNCH, "host_launch(blocks, kThreads, "
                                "al_fused_kernel<M, T, F, LOG2G>, ")
        if not rounded_merit:
            text = text.replace("kRoundedMerit = true",
                                "kRoundedMerit = false")
        for name in exempt:
            text, n = re.subn(r"__device__ __(?:force|no)inline__ ([^(;]*\b"
                              + name + r")\(", r"__device__ " + _EXEMPT
                              + r"\1(", text)
            found.update([name] * bool(n))
        texts[f.name] = text
    if set(exempt) - found:
        raise ValueError(f"no device function {set(exempt) - found}")
    BUILD.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix=f"{library}-", dir=BUILD))
    src = out / "src"
    (src / "inc").mkdir(parents=True)
    (src / "inc" / "cuda_runtime.h").write_text("")
    (src / "stub.h").write_text(_STUB)
    for name, text in texts.items():
        (src / name).write_text(text)
    so = out / f"lib{library}.so"
    fp = ["-ffp-contract=fast", "-mfma"] if contract else \
        ["-ffp-contract=off"]
    subprocess.run(["g++", "-std=c++17", "-O2", *fp, "-fPIC", "-shared",
                    "-DK2_HOST", "-x", "c++", "-I", str(src / "inc"), "-include",
                    str(src / "stub.h"), "-o", str(so),
                    str(src / f"{library}.cu")], check=True,
                   capture_output=True)
    return so


def launch(model, Cd, c, x0, u_lo, u_hi, x_init, u_init, al_iter=2,
           n_newton=4, n_ls=20, rho_factor=10.0, rho_max=1e4, reg=1e-5,
           lam_dyn=None, lam_hi=None, lam_lo=None, rho0=None, group=None,
           contract=False, exempt=(), rounded_merit=True):
    """``al_fused_cuda.fused_al_solve`` on CPU tensors through the host
    build of the model's kernel (``group`` is ignored: G 1)."""
    built = al_fused_cuda.built_for(model)
    B, T, n = Cd.shape
    library = built.library
    key = (library, contract, tuple(exempt), rounded_merit)
    if key not in _loaded:
        so = build(library, contract, exempt, rounded_merit)
        _loaded[key] = ctypes.CDLL(str(so))
        shutil.rmtree(so.parent)  # loaded; the mapping stays
    lam_dyn, lam_hi, lam_lo, rho0 = al_fused_cuda._fill_warm_start(
        B, T, model.nx, model.nu, Cd, lam_dyn, lam_hi, lam_lo, rho0)
    ins = [a.contiguous() for a in (Cd, c, x0, x_init, u_init, lam_dyn,
                                    lam_hi, lam_lo, rho0)]
    outs = [torch.empty_like(a) for a in (Cd, lam_dyn, lam_hi, lam_lo,
                                          rho0)]
    err = al_fused_cuda.call_entry(
        getattr(_loaded[key], built.symbol(Cd.dtype)), ins + outs, B, 0, T,
        al_iter, n_newton, n_ls, rho_factor, rho_max, reg,
        built.params(model), u_lo, u_hi, None)
    if err:
        raise RuntimeError(f"host build of {library}: error {err}")
    return tuple(outs)


@contextlib.contextmanager
def kernel_on_host(**build_kw):
    """Within it, every ``al_fused_cuda.fused_al_solve`` runs the host
    build (``launch``'s contract, exempt, rounded_merit); yields a dict
    counting the launches."""
    count = {"launches": 0}
    original = al_fused_cuda.fused_al_solve

    def host(*args, **kwargs):
        count["launches"] += 1
        return launch(*args, **kwargs, **build_kw)

    al_fused_cuda.fused_al_solve = host
    try:
        yield count
    finally:
        al_fused_cuda.fused_al_solve = original


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--contract", action="store_true",
                    help="let g++ contract multiply-adds (nvcc's default)")
    ap.add_argument("--exempt", default="",
                    help="comma-separated device functions built apart "
                         "without contraction")
    ap.add_argument("--merit", choices=("rounded", "contracted"),
                    default="rounded",
                    help="the models' merit as built (kRoundedMerit) or "
                         "as the pendulum's")
    args, rest = ap.parse_known_args(argv)
    from diff_qp_mpc_tpu_torch.learning import evaluate

    build_kw = dict(contract=args.contract,
                    exempt=tuple(filter(None, args.exempt.split(","))),
                    rounded_merit=args.merit == "rounded")
    with kernel_on_host(**build_kw) as count:
        metrics = evaluate.main(rest + ["--device", "cpu"])
    print(json.dumps(dict(build_kw, **count)))
    return 0 if metrics else 1


if __name__ == "__main__":
    raise SystemExit(main())
