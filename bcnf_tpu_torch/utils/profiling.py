"""Profiling and timing helpers (port of `bcnf_tpu/utils/profiling.py`):
`trace` captures a `torch.profiler` trace (Chrome trace JSON, for Perfetto
or TensorBoard), `StepTimer` keeps wall-clock step times with percentiles,
`benchmark` times a function with the device synchronised and the warm-up
excluded, and `device_memory_stats` reads `torch.cuda.memory_stats` of
every visible card."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Profile the block (the CPU, and CUDA where a card is visible) and
    write its Chrome trace to `logdir/trace.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accumulates per-step wall times; `summary()` gives mean/percentiles.
    The caller synchronises the device inside the block where it times
    device work."""

    def __init__(self) -> None:
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self) -> "StepTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._t0 is None:
            raise RuntimeError("StepTimer exited without entering")
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "p99_s": float(np.percentile(arr, 99)),
            "total_s": float(arr.sum()),
            "steps": len(arr),
        }


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    iters: int = 20,
) -> dict[str, float]:
    """Mean seconds a call of `fn(*args)` takes, and calls a second: the
    warm-up calls excluded, the device synchronised before the clock starts
    and after the last call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_sec": 1.0 / dt}


def device_memory_stats() -> dict[str, Any]:
    """`torch.cuda.memory_stats` of each visible card, by device name (an
    empty dict without a card)."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
