"""The shared timing protocol of the port's benchmarks (port of
benchmarks/timing.py).

A measurement is n_outer independent pipelined windows; the headline is
the median window, with the spread (max/min) and the load average recorded
so that a run on a loaded host shows in its artifact.

  - pipelined window: n_rep back-to-back calls, then one
    ``torch.cuda.synchronize()`` (the counterpart of JAX's
    ``block_until_ready``). It measures steady-state device throughput;
    the host's enqueue overlaps the device's work.
  - per call: a synchronize after every call. It includes one launch
    latency and is reported as latency, never as throughput.

Times are read from the host clock (``time.perf_counter``) after the
synchronize, with the device idle when a window starts. ``run`` must
return a CUDA tensor: there is no CPU timing, and without a card every
function here raises.
"""
from __future__ import annotations

import os
import statistics
import time

import torch


def _sync_result(r) -> None:
    if not (isinstance(r, torch.Tensor) and r.device.type == "cuda"):
        got = r.device if isinstance(r, torch.Tensor) else type(r).__name__
        raise TypeError(f"run must return a CUDA tensor, got {got}")
    torch.cuda.synchronize(r.device)


def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the timing protocol measures "
                           "the card only")


def steady_state(run, n_rep: int = 10, n_outer: int = 5) -> dict:
    """Median-of-windows pipelined timing.

    run: zero-argument callable returning a CUDA tensor, already warm (the
    caller has run it once). Returns per-call seconds (median/min/max over
    the windows) and the max/min window spread."""
    _require_card()
    torch.cuda.synchronize()
    windows = []
    for _ in range(n_outer):
        t0 = time.perf_counter()
        r = None
        for _ in range(n_rep):
            r = run()
        _sync_result(r)
        windows.append((time.perf_counter() - t0) / n_rep)
    return {
        "per_call_s_median": statistics.median(windows),
        "per_call_s_min": min(windows),
        "per_call_s_max": max(windows),
        "spread_max_over_min": max(windows) / min(windows),
        "n_rep": n_rep,
        "n_outer": n_outer,
        "loadavg1": os.getloadavg()[0],
    }


def per_call_latency(run, n_rep: int = 7) -> float:
    """Median seconds of a call with a synchronize after it (includes one
    launch latency)."""
    _require_card()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n_rep):
        t0 = time.perf_counter()
        _sync_result(run())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
