"""Device traces and throughput from the iteration-count slope.

The counterpart of `falcon_r1cs_tpu/utils/profiling.py`: a
`torch.profiler` trace in place of `jax.profiler`'s, and throughput from
the SLOPE of total time against the number of back-to-back calls, so
that a fixed per-group cost (the first launch, the final synchronise)
falls into the intercept.  On a CUDA device each group of calls is timed
with CUDA events; on the CPU with the host clock.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from .device import entry_device


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the block with torch.profiler (the CPU, and the card for a
    CUDA device) and write a Chrome trace, `log_dir`/trace.json.  Yields
    the profiler, whose key_averages() hold the per-kernel times."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if entry_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _timer(args):
    """seconds(fn, calls): the time of `calls` back-to-back fn() calls, on
    the device of the first tensor argument."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    if dev.type == "cuda":
        def seconds(fn, calls):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def seconds(fn, calls):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            return time.perf_counter() - t0
    return seconds


def throughput(fn, args, items_per_call: int, iters=(4, 32), trials: int = 2):
    """items/s of fn(*args) from the iteration-count slope; returns
    (best_rate, {"rates": [...]}), the rate 0.0 if no trial had a positive
    slope."""
    seconds = _timer(args)

    def call():
        fn(*args)

    seconds(call, 1)  # warm-up: library load, allocator
    rates = []
    for _ in range(trials):
        (i1, t1), (i2, t2) = ((it, seconds(call, it)) for it in (iters[0], iters[-1]))
        per_call = (t2 - t1) / (i2 - i1)
        if per_call > 0:
            rates.append(items_per_call / per_call)
    return (max(rates) if rates else 0.0), {"rates": rates}
