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

A kernel's own time per launch is read on the device: ``events_ms`` from
CUDA events around back-to-back calls (host gaps between short kernels
included), ``device_kernel_ms`` from the kernels' durations in a
torch.profiler trace (no gaps).
"""
from __future__ import annotations

import os
import statistics
import time

import torch

# Profiled windows ``device_kernel_ms`` takes before it gives up on a kernel.
PROFILE_ATTEMPTS = 3


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


def events_ms(fn, reps: int, warmup: int = 2) -> float:
    """Milliseconds per call: CUDA events around ``reps`` calls."""
    _require_card()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_events_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` without the profiler: CUDA
    events recorded around each call while a spin kernel
    (``torch.cuda._sleep``, ~0.5 ms) holds the stream, so the start event,
    the call's work and the end event are all queued before the device
    reaches them and the host's launch time falls outside the bracket. For
    a call that launches one kernel this is that kernel's device time
    (plus the events' own ~µs)."""
    _require_card()
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_kernel_ms(fn, reps: int, name: str) -> float:
    """Device time per launch of the CUDA kernel whose name contains
    ``name``, from torch.profiler. A profiled window in which the profiler
    saw no such kernel time is taken again, up to ``PROFILE_ATTEMPTS``
    windows in all; then it raises, so a missing time is never recorded."""
    from torch.profiler import ProfilerActivity, profile

    _require_card()
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += ev.device_time_total
                count += ev.count
        if count > 0 and total > 0:
            return total / count / 1e3
    raise RuntimeError(f"the profiler saw no device time of a kernel named "
                       f"{name!r} in {PROFILE_ATTEMPTS} windows of {reps} "
                       f"calls")
