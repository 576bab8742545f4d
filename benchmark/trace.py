"""The traced run's reduction: `torch.profiler`'s events to device busy
time, idle gaps, time by kernel, and device time under the harness's spans.

A traced run profiles its window for the device alone, which costs the
host little: the busy time, the idle share and the time by kernel come
from there. It then profiles a few more calls with the host's events, in
one `WINDOW` span, with the spans that the cell's per-layer metrics name
(`Spans`) opened around calls into the program: a kernel belongs to a span
when the host call that launched it (its runtime event, matched by
correlation id) started inside that span. Nothing is written to disk: the
events are read from the profiler in memory.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Iterator

WINDOW = "bench.window"
TOP = 10  # entries in each list of the breakdown


class Spans:
    """`record_function` spans around program calls named as
    ``"module:attr"`` or ``"module:Class.method"``, installed for the life
    of the context and then put back. A module-level function's wrapper
    shares its attributes (`__dict__`), so counters the function keeps on
    itself keep counting."""

    def __init__(self, targets: dict[str, str]) -> None:
        self.targets = targets

    @contextlib.contextmanager
    def installed(self) -> Iterator[None]:
        from torch.profiler import record_function

        undo = []
        try:
            for name, target in self.targets.items():
                module_name, _, path = target.partition(":")
                owner: Any = importlib.import_module(module_name)
                *parents, attr = path.split(".")
                for p in parents:
                    owner = getattr(owner, p)
                orig = owner.__dict__[attr]

                def wrapper(*args: Any, _orig: Any = orig, _name: str = name, **kwargs: Any) -> Any:
                    with record_function(_name):
                        return _orig(*args, **kwargs)

                functools.update_wrapper(wrapper, orig)
                if not isinstance(owner, type):
                    wrapper.__dict__ = orig.__dict__
                setattr(owner, attr, wrapper)
                undo.append((owner, attr, orig))
            yield
        finally:
            for owner, attr, orig in reversed(undo):
                setattr(owner, attr, orig)


@dataclass
class Trace:
    """What a traced run shows. Times in seconds. The window is profiled
    for the device alone (`device_summary`), so that the profiler adds
    little to the host's work; a few more calls are then profiled with the
    host's events too (`span_summary`) for the spans and the idle gaps'
    names."""

    window_s: float  # the window's length on the host clock
    busy_s: float  # time in the window with an operation on the device
    device_ops: list = field(default_factory=list)  # [[kernel name, seconds], ...], most first
    n_kernels: int = 0
    idle_gaps: list = field(default_factory=list)  # [[host activity, seconds], ...], most first (span phase)
    span_device_s: dict = field(default_factory=dict)  # span name: device seconds of its kernels (span phase)
    span_calls: dict = field(default_factory=dict)  # span name: calls in the span phase

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)


@contextlib.contextmanager
def profiled(device: Any, host: bool) -> Iterator[dict]:
    """`torch.profiler` over the body: the device's operations, and with
    `host` the host's too, the body inside one `WINDOW` span. Yields a
    holder that gets the profile (`holder["prof"]`) once the body is done."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if host or not activities:
        activities = [ProfilerActivity.CPU] + activities
    holder: dict = {}
    with profile(activities=activities) as prof:
        if host:
            with record_function(WINDOW):
                yield holder
        else:
            yield holder
    holder["prof"] = prof


def _merged(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _device_events(events: list, exclude: set[str]) -> list:
    import torch

    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in exclude]


def device_summary(prof: Any, exclude: set[str] = frozenset()) -> tuple[float, list, int]:
    """(busy seconds, time by kernel name, operations) of every device
    operation in a profile that spans the window alone."""
    device = _device_events(list(prof.events()), set(exclude) | {WINDOW})
    busy = _merged([(e.time_range.start, e.time_range.end) for e in device])
    by_name: dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) * 1e-6
    ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:TOP]
    return sum(b - a for a, b in busy) * 1e-6, ops, len(device)


def span_summary(prof: Any, span_names: list[str]) -> tuple[dict, dict, list]:
    """From a profile with the host's events, the body in one `WINDOW`
    span: the device seconds of the kernels launched inside each span and
    its calls, and the body's idle gaps by what the host was doing."""
    import torch

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    windows = [e for e in cpu if e.name == WINDOW]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0].time_range.start, windows[0].time_range.end
    device = [e for e in _device_events(events, set(span_names) | {WINDOW}) if w0 <= e.time_range.start <= w1]
    busy = _merged([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device])

    # host activity during each idle gap: the innermost host event covering
    # the gap's middle (the one that started last)
    host = sorted((e for e in cpu if e.name != WINDOW and e.time_range.end > e.time_range.start
                   and not e.name.startswith("Activity Buffer")),  # the profiler's own
                  key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name = 0.5 * (a + b), "no host event"
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(-1, j - 5000), -1):
            if host[k].time_range.end >= mid:
                name = host[k].name
                break
        gaps[name] += (b - a) * 1e-6
    idle_gaps = sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:TOP]

    # device time of the kernels each span launched: runtime calls (matched
    # to their kernels by correlation id) that started inside the span
    span_device_s, span_calls = {}, {}
    launch_start = {e.id: e.time_range.start for e in cpu if e.name.startswith(("cuda", "cu"))}
    for name in span_names:
        spans = sorted((e.time_range.start, e.time_range.end) for e in cpu
                       if e.name == name and w0 <= e.time_range.start <= w1)
        span_calls[name] = len(spans)
        lo = [s for s, _ in spans]
        total = 0.0
        for e in device:
            t = launch_start.get(e.id)
            if t is None:
                continue
            j = bisect.bisect_right(lo, t) - 1
            if j >= 0 and t <= spans[j][1]:
                total += (e.time_range.end - e.time_range.start) * 1e-6
        span_device_s[name] = total
    return span_device_s, span_calls, idle_gaps
