"""The warp-layout kernels of ``csrc/`` run on the CPU: a CUDA source built
with g++, one POSIX thread per CUDA thread.

    python -m diff_qp_mpc_tpu_torch.utils.warp_emu [--tsan]

holds K1's warp layout (``csrc/btsolve.cu``, n 16, T 5, float64), K2's
warp layout on Cartpole1L (``csrc/al_fused_cartpole1l.cu``, T 5,
float64) and on the quadrotor (``csrc/al_fused_quadrotor.cu``, T 5,
float64) at its warps per element and at W 1, K3's warp-layout horizon
kernel (``csrc/riccati_horizon_warp.cu`` at the quadrotor expert's
(20, 12, 4), float64) and K4's warp layout (``csrc/trajqp_fused_warp.cu``
at cp2's (5, 6, 1), float64) against their plain versions on a few
elements and prints the errors. ``--tsan`` builds with ThreadSanitizer
and reruns itself with its runtime preloaded, so that a missing ``__syncwarp`` between lanes that
share memory is reported as a data race.

The build stubs the CUDA names (``stub.h`` below) and rewrites two
constructs with a regular expression: ``extern __shared__`` arrays become
a pointer to the block's shared memory, and a ``kernel<<<config>>>(args)``
launch becomes ``emu::launch``, which runs the grid's blocks one after
another, each block's threads as ``std::thread``s. With ``with_w1`` it
also instantiates K2's warp layout at one warp per element (W 1) beside
each W its source names (``AL_WARP_CASE`` and ``AL_WARP_SMEM_CASE``), so
that the source's W can be held to W 1's bits. ``__syncwarp`` and
``__syncthreads`` are barriers of the warp's and the block's threads; a
shuffle is a rendezvous of the warp's 32 lanes (each writes its value to a
slot, a barrier, each reads its source lane's slot, a barrier). A shuffle
must name the whole warp, and a warp's lanes must meet at every barrier:
the kernels here keep their warps' control flow uniform. Shared memory
starts filled with NaN bytes, so a read of a word that no lane wrote
shows in the result. g++ does not contract multiply-adds here, and its
sin and cos are the host's, so the emulation runs the kernel's arithmetic
and its order, not the card's rounding. Needs g++; each build lives under
``build/warp_emu/`` while it loads.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

from diff_qp_mpc_tpu_torch.utils.cuda_build import CSRC

BUILD = Path(__file__).resolve().parents[2] / "build" / "warp_emu"
_STUB = r"""#pragma once
#include <pthread.h>

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
using std::atan2;
using std::cos;
using std::min;
using std::sin;
using std::sqrt;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline __attribute__((always_inline))
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __align__(n) __attribute__((aligned(n)))
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16,
                      cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct emu_dim3 { unsigned x, y, z; };
static thread_local emu_dim3 blockIdx, threadIdx;
static emu_dim3 blockDim;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// an H100's: 132 SMs, 232,448 bytes of shared memory a block may ask for
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 132;
  return 0;
}
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* b, K, int,
                                                          int) {
  *b = 1;
  return 0;
}
template <class T> inline T emu_rounded_product(T a, T b) {
  T r = a * b;
  asm volatile("" : "+x"(r));  // no multiply-add across this
  return r;
}
inline float __fmul_rn(float a, float b) {
  return emu_rounded_product(a, b);
}
inline double __dmul_rn(double a, double b) {
  return emu_rounded_product(a, b);
}
namespace emu {
struct Warp {
  pthread_barrier_t bar;
  unsigned long long slot[32];
};
struct Block {
  std::vector<Warp> warps;
  pthread_barrier_t bar;
  unsigned char* shared;
};
static thread_local Block* block;
inline unsigned char* shared() { return block->shared; }
inline Warp& warp() { return block->warps[threadIdx.x / 32]; }
inline void syncwarp() { pthread_barrier_wait(&warp().bar); }
template <class T>
T shfl(unsigned mask, T v, int src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "a slot a lane");
  if (mask != 0xffffffffu) std::abort();  // whole warps only
  Warp& w = warp();
  std::memcpy(&w.slot[threadIdx.x & 31], &v, sizeof(T));
  pthread_barrier_wait(&w.bar);
  T r;
  std::memcpy(&r, &w.slot[src & 31], sizeof(T));
  pthread_barrier_wait(&w.bar);
  return r;
}
struct Config {
  Config(long long b, long long t, long long s = 0, void* = nullptr)
      : blocks(b), threads(t), shared(s) {}
  long long blocks, threads, shared;
};
template <class K, class... A>
void launch(K kernel, Config c, A... a) {
  if (c.threads % 32) std::abort();  // whole warps only
  blockDim.x = static_cast<unsigned>(c.threads);
  std::vector<double> shared(c.shared / sizeof(double) + 2);
  for (long long bi = 0; bi < c.blocks; ++bi) {
    Block blk;
    blk.warps.resize(c.threads / 32);
    for (Warp& w : blk.warps) pthread_barrier_init(&w.bar, nullptr, 32);
    pthread_barrier_init(&blk.bar, nullptr,
                         static_cast<unsigned>(c.threads));
    std::memset(shared.data(), 0xff, shared.size() * sizeof(double));
    blk.shared = reinterpret_cast<unsigned char*>(shared.data());
    std::vector<std::thread> ts;
    for (long long t = 0; t < c.threads; ++t)
      ts.emplace_back([&, t] {
        block = &blk;
        blockIdx.x = static_cast<unsigned>(bi);
        threadIdx.x = static_cast<unsigned>(t);
        kernel(a...);
      });
    for (std::thread& t : ts) t.join();
    for (Warp& w : blk.warps) pthread_barrier_destroy(&w.bar);
    pthread_barrier_destroy(&blk.bar);
  }
}
}  // namespace emu
#define __syncwarp(...) emu::syncwarp()
inline void __syncthreads() { pthread_barrier_wait(&emu::block->bar); }
template <class T>
T __shfl_sync(unsigned mask, T v, int src) {
  return emu::shfl(mask, v, src);
}
template <class T>
T __shfl_xor_sync(unsigned mask, T v, int s) {
  return emu::shfl(mask, v, static_cast<int>(threadIdx.x & 31) ^ s);
}
"""
_SHARED = re.compile(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?"
                     r"unsigned\s+char\s+(\w+)\[\];")
_LAUNCH = re.compile(r"(\w+(?:<[^;<>]*>)?)<<<([^;]*?)>>>\(")
_AL_CASE = re.compile(r"(AL_WARP(?:_SMEM)?_CASE)\((\d+), ([\w:]+), (\w+), "
                      r"(\d)\)")
_loaded: Dict[tuple, ctypes.CDLL] = {}
_MODULE = "diff_qp_mpc_tpu_torch.utils.warp_emu"


def rewrite(text: str) -> str:
    """``text`` with its ``extern __shared__`` arrays and its ``<<<>>>``
    launches rewritten for the emulation."""
    text = _SHARED.sub(r"unsigned char* \1 = emu::shared();", text)
    return _LAUNCH.sub(r"emu::launch(\1, emu::Config(\2), ", text)


def with_w1(text: str) -> str:
    """``text`` with each K2 warp-layout case at W also a case at W 1."""
    return _AL_CASE.sub(lambda m: " ".join(
        f"{m.group(1)}({m.group(2)}, {m.group(3)}, {m.group(4)}, {W})"
        for W in sorted({1, int(m.group(5))})), text)


def build(library: str, sanitize: bool = False,
          w1: bool = False) -> Path:
    """The emulation's build of ``csrc/<library>.cu`` (with ThreadSanitizer
    if ``sanitize``; K2 also at W 1 if ``w1``) in a new directory under
    ``build/warp_emu/`` that the caller removes."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found: the emulation builds with it")
    BUILD.mkdir(parents=True, exist_ok=True)
    out = Path(tempfile.mkdtemp(prefix=f"{library}-", dir=BUILD))
    src = out / "src"
    (src / "inc").mkdir(parents=True)
    (src / "inc" / "cuda_runtime.h").write_text("")
    (src / "stub.h").write_text(_STUB)
    for f in list(CSRC.glob("*.cuh")) + [CSRC / f"{library}.cu"]:
        text = rewrite(f.read_text())
        (src / f.name).write_text(with_w1(text) if w1 else text)
    so = out / f"lib{library}.so"
    flags = ["-fsanitize=thread", "-O1", "-g"] if sanitize else ["-O1"]
    proc = subprocess.run(
        ["g++", "-std=c++17", *flags, "-ffp-contract=off", "-pthread",
         "-fPIC", "-shared", "-x", "c++", "-I", str(src / "inc"), "-include",
         str(src / "stub.h"), "-o", str(so), str(src / f"{library}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        shutil.rmtree(out, ignore_errors=True)
        raise RuntimeError(f"g++ failed for {library}.cu:\n{proc.stderr}")
    return so


def load(library: str, sanitize: bool = False,
         w1: bool = False) -> ctypes.CDLL:
    """The loaded emulation build of ``csrc/<library>.cu``, built once per
    process."""
    key = (library, sanitize, w1)
    if key not in _loaded:
        so = build(library, sanitize, w1)
        _loaded[key] = ctypes.CDLL(str(so))
        shutil.rmtree(so.parent)  # loaded; the mapping stays
    return _loaded[key]


def btsolve_warp(D, O, b, reg: float = 0.0,
                 compute: Optional[torch.dtype] = None,
                 sanitize: bool = False) -> torch.Tensor:
    """K1's warp layout (``btsolve_warp_f32``/``_f64``) on CPU tensors;
    ``compute`` as ``btsolve_cuda.batched_factor_solve`` takes it."""
    from diff_qp_mpc_tpu_torch.ops import btsolve_cuda

    B, T, n, _ = D.shape
    compute = btsolve_cuda.WARP_COMPUTE[D.dtype] if compute is None \
        else compute
    D, O, b = (a.contiguous() for a in (D, O, b))
    x = torch.empty_like(b)
    lib = load("btsolve", sanitize)
    fn = getattr(lib, btsolve_cuda._WARP_SYMBOLS[D.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_double, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(D.data_ptr(), O.data_ptr(), b.data_ptr(), x.data_ptr(), B, T, n,
             float(reg), btsolve_cuda._BITS[compute], None)
    if err:
        raise RuntimeError(f"emulated btsolve warp kernel: error {err}")
    return x


def fused_al_solve_warp(model, Cd, c, x0, u_lo, u_hi, x_init, u_init,
                        al_iter=2, n_newton=4, n_ls=20, rho_factor=10.0,
                        rho_max=1e4, reg=1e-5, lam_dyn=None, lam_hi=None,
                        lam_lo=None, rho0=None, warps=None,
                        sanitize: bool = False):
    """K2's warp layout for ``model`` (a model on that layout) on CPU
    tensors, with ``al_fused_cuda.fused_al_solve``'s arguments and
    outputs, at its table's warps per element or at ``warps``, the
    table's or 1 (where given, from the build that has both)."""
    from diff_qp_mpc_tpu_torch.ops import al_fused_cuda

    built = al_fused_cuda.built_for(model)
    if built.layout != "warp":
        raise ValueError(f"the {built.name} kernel is not on the warp layout")
    B, T, _ = Cd.shape
    lam_dyn, lam_hi, lam_lo, rho0 = al_fused_cuda._fill_warm_start(
        B, T, model.nx, model.nu, Cd, lam_dyn, lam_hi, lam_lo, rho0)
    ins = [a.contiguous() for a in (Cd, c, x0, x_init, u_init, lam_dyn,
                                    lam_hi, lam_lo, rho0)]
    outs = [torch.empty_like(a) for a in (Cd, lam_dyn, lam_hi, lam_lo,
                                          rho0)]
    W = built.warps if warps is None else warps
    if W not in (1, built.warps):
        raise ValueError(f"the {built.name} kernel is built at W "
                         f"{built.warps} (and W 1 here), not {W}")
    lib = load(built.library, sanitize, w1=warps is not None)
    err = al_fused_cuda.call_entry(
        getattr(lib, built.symbol(Cd.dtype)), ins + outs, B,
        5 + W.bit_length() - 1, T, al_iter, n_newton, n_ls, rho_factor,
        rho_max, reg,
        built.params(model), u_lo, u_hi, None)
    if err:
        raise RuntimeError(f"emulated al_fused warp kernel: error {err}")
    return tuple(outs)


def riccati_horizon_warp(args, reg: float = 0.0, sanitize: bool = False):
    """K3's warp-layout horizon kernel (``riccati_horizon_warp_f32``/
    ``_f64``) on CPU tensors: ``args`` and the outputs (dx, du, lam) as
    ``riccati_cuda.batched_lqr_kkt_solve`` takes and gives them."""
    from diff_qp_mpc_tpu_torch.ops import riccati_cuda

    args = [a.contiguous() for a in args]
    gx, gu = args[3], args[4]
    Bsz, T, nx, nu = args[1].shape
    if (nx, nu) not in riccati_cuda.HORIZON_WARP_BUILT:
        raise ValueError(f"the warp layout is not built for nx={nx}, "
                         f"nu={nu}")
    lib = load("riccati_horizon_warp", sanitize)
    lib.riccati_horizon_warp_workspace.restype = ctypes.c_int
    ws = gx.new_empty(T * lib.riccati_horizon_warp_workspace(nx, nu) * Bsz)
    outs = [torch.empty_like(gx), torch.empty_like(gu), torch.empty_like(gx)]
    fn = getattr(lib, "riccati_horizon_warp_" + riccati_cuda._BITS[gx.dtype])
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 \
        + [ctypes.c_double, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
             ws.data_ptr(), Bsz, T, nx, nu, float(reg), None)
    if err:
        raise RuntimeError(f"emulated riccati_horizon_warp kernel: error "
                           f"{err}")
    return tuple(outs)


def fused_trajqp_solve_warp(C, c, A, B, f, x0, x_init, u_init, u_lo, u_hi,
                            max_iter: int = 12, reg: float = 1e-9,
                            min_slack: float = 1e-8,
                            sanitize: bool = False):
    """K4's warp layout (``trajqp_fused_warp_f32``/``_f64``) on CPU
    tensors, with ``trajqp_fused_cuda.fused_trajqp_solve``'s arguments and
    outputs."""
    from diff_qp_mpc_tpu_torch.ops import trajqp_fused_cuda

    ins = [a.contiguous() for a in (C, c, A, B, f, x0, x_init, u_init)]
    Bsz, Tm1, nx, nu = B.shape
    if (Tm1 + 1, nx, nu) not in trajqp_fused_cuda.WARP_BUILT:
        raise ValueError(f"the warp layout is not built for T={Tm1 + 1}, "
                         f"nx={nx}, nu={nu}")
    outs = [torch.empty_like(x_init), torch.empty_like(u_init),
            torch.empty_like(x_init)] + [torch.empty_like(u_init)
                                         for _ in range(4)] \
        + [x0.new_empty(Bsz)]
    lib = load("trajqp_fused_warp", sanitize)
    fn = getattr(lib, trajqp_fused_cuda._SYMBOLS["warp"][C.dtype])
    dblu = ctypes.c_double * nu
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 \
        + [ctypes.c_double] * 2 + [ctypes.POINTER(ctypes.c_double)] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*(a.data_ptr() for a in ins), *(o.data_ptr() for o in outs),
             Bsz, Tm1 + 1, nx, nu, int(max_iter), float(reg),
             float(min_slack), dblu(*u_lo), dblu(*u_hi), None)
    if err:
        raise RuntimeError(f"emulated trajqp_fused warp kernel: error {err}")
    return tuple(outs)


def self_check(sanitize: bool = False) -> dict:
    """K1's warp layout at n 16, T 5, B 3, K2's on Cartpole1L at T 5, B 2
    and on the quadrotor at T 5, B 2 at its W and at W 1 (the bits of
    one against the other's), K3's at (20, 12, 4), B 3, and K4's at
    (5, 6, 1), B 3, all
    float64, against their plain versions: the largest errors (K1's and
    K3's relative to the solution's largest entry, K4's over max(1, each
    output's largest entry))."""
    from diff_qp_mpc_tpu_torch.benchmarks import k2_models
    from diff_qp_mpc_tpu_torch.benchmarks import prof_trajqp_fused as prof
    from diff_qp_mpc_tpu_torch.benchmarks.kernel_layouts import (
        lqr_problem,
        random_bt_spd,
    )
    from diff_qp_mpc_tpu_torch.ops import (
        al_fused_cuda,
        btsolve,
        riccati,
        trajqp_fused_cuda,
    )

    D, O, b = random_bt_spd(3, 5, 16, torch.float64, seed=3, device="cpu")
    x = btsolve_warp(D, O, b, 1e-7, sanitize=sanitize)
    ref = btsolve.batched_factor_solve(D, O, b, 1e-7)
    k1 = float((x - ref).abs().max() / ref.abs().max())
    args = k2_models.problem("cartpole1l", 2, 5, torch.float64, seed=2,
                             device="cpu")
    out = fused_al_solve_warp(*args, **k2_models.BUDGET, sanitize=sanitize)
    plain = al_fused_cuda.fused_al_solve_reference(*args, **k2_models.BUDGET)
    k2 = float(k2_models.element_errors(out, plain).max())
    args = k2_models.problem("quadrotor", 2, 5, torch.float64, seed=2,
                             device="cpu")
    bud = k2_models.budget("quadrotor")
    quad = {W: fused_al_solve_warp(*args, **bud, warps=W, sanitize=sanitize)
            for W in {1, al_fused_cuda.built_for(args[0]).warps}}
    k2q = float(k2_models.element_errors(
        quad[1], al_fused_cuda.fused_al_solve_reference(*args, **bud)).max())
    lqr = lqr_problem(3, 20, 12, 4, torch.float64, seed=3, device="cpu")
    k3_out = riccati_horizon_warp(lqr, 1e-9, sanitize=sanitize)
    sol = riccati.batched_lqr_kkt_solve(*lqr, 1e-9)
    k3 = max(float((g - w).abs().max() / w.abs().max())
             for g, w in zip(k3_out, (sol.dx, sol.du, sol.lam)))
    arrays, box = prof.problem(3, 5, 6, 1, torch.float64, device="cpu")
    qp = (*arrays, *prof.cold_start(*arrays), box.u_lo, box.u_hi)
    k4_out = fused_trajqp_solve_warp(*qp, sanitize=sanitize)
    k4 = max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
             for g, w in zip(k4_out, trajqp_fused_cuda.
                             fused_trajqp_solve_reference(*qp)))
    return dict(k1_n16_T5_B3_float64_max_rel_err=k1,
                k2_cartpole1l_T5_B2_float64_max_abs_err_xu=k2,
                k2_quadrotor_T5_B2_float64_max_abs_err_xu=k2q,
                k2_quadrotor_table_w_bits_of_w1=all(
                    k2_models._same(o, quad[1]) for o in quad.values()),
                k3_warp_T20_12_4_B3_float64_max_rel_err=k3,
                k4_warp_T5_6_1_B3_float64_max_scaled_err=k4,
                finite=all(bool(torch.isfinite(o).all())
                           for o in (x, *out, *quad[1], *k3_out, *k4_out)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tsan", action="store_true",
                    help="build with ThreadSanitizer (reruns this module "
                         "with its runtime preloaded)")
    args = ap.parse_args(argv)
    if args.tsan and "libtsan" not in os.environ.get("LD_PRELOAD", ""):
        lib = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             capture_output=True, text=True).stdout.strip()
        env = dict(os.environ, LD_PRELOAD=lib,
                   TSAN_OPTIONS="halt_on_error=1 report_signal_unsafe=0")
        return subprocess.run([sys.executable, "-m", _MODULE, "--tsan"],
                              env=env).returncode
    print(json.dumps(self_check(sanitize=args.tsan)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
