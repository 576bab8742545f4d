"""The benchmark's harness: one cell of `BENCHMARK.json`, from its files to
its result line.

Everything particular to a cell is found by name, so that a new
configuration, traffic mix, loop or per-layer metric is new files and
entries, and no file here changes:

- `BENCHMARK.json` names the cell's configuration and traffic mix and the
  metrics it reports;
- the configuration's file (``configs/<config>.json``) holds the run
  configuration as it is run, its precision and the precision of its
  control; the reference finds each of its feature networks by type
  (``reference/encoders/<type>.py``: the plain encoder and its operations);
- the mix (``mixes/<traffic>.json``) is data: the loop it drives
  (``"entry"``) and that loop's sizes;
- the loop (``loops/<entry>.py``, `run(...)` and the `SPANS` it times)
  drives one entry of the program over the window and checks what it
  returned against the reference;
- the limits of the output check (``limits/<cell>.json``) and the readings
  they were set from;
- each per-layer metric is a reader (``metrics/<metric>.py``, `read(ctx)` and
  the `SPANS` it reads) over the traced window.

The program under test is `bcnf_tpu_torch`; the weights and inputs are made
here from the seed, and `reference/` judges what the timed path returned.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from benchmark import work
from benchmark.trace import Spans, Trace, device_summary, profiled, span_summary

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# streams drawn from a run's seed
WEIGHTS, INPUTS, REQUESTS, DROPOUT, CHECKED, WARMUP = 1, 2, 3, 4, 5, 6


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of a run's seed (any whole number >= 0)."""
    return int(np.random.SeedSequence([int(seed), *stream]).generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    chips: int = 1

    @property
    def run_config(self) -> dict:
        return self.config["run_config"]


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(workload: str) -> Cell:
    """The cell named `workload` as `BENCHMARK.json` defines it."""
    spec = _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name=workload, config=_json(ROOT / conf["file"]), mix=_json(BENCH / "mixes" / f"{w['traffic']}.json"),
                limits=_json(BENCH / "limits" / f"{workload}.json"), end_to_end=e2e, per_layer=per,
                chips=int(w["chips"]))


def load_module(folder: str, name: str) -> Any:
    """The module ``<folder>/<name>.py`` of the benchmark: a loop
    (``loops``) or a per-layer metric's reader (``metrics``), whose names
    may hold dots."""
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark has no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.{folder}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quantity(metric: str) -> str:
    """What a metric measures: its name up to the first dot. Metrics of one
    quantity split by the cells they hold (``device_idle.sample``,
    ``device_idle.train``) share its loop value and its reader."""
    return metric.split(".")[0]


def load_reader(metric: str) -> Any:
    """A per-layer metric's reader: ``metrics/<metric>.py``, or else its
    quantity's, ``metrics/<quantity>.py``."""
    own = BENCH / "metrics" / f"{metric}.py"
    return load_module("metrics", metric if own.is_file() else quantity(metric))


# -- the model, its weights and its inputs -----------------------------------


def build_model(cell: Cell, control: bool = False) -> Any:
    from bcnf_tpu_torch.models import CondRealNVP

    model = CondRealNVP.from_config(cell.run_config)
    model.precision = cell.config["control_precision" if control else "precision"]
    return model


def parameter_shapes(model: Any) -> dict:
    """The shapes (`torch.Size` leaves) of the tree `CondRealNVP.init`
    returns, read from one draw of it on the host; its values are dropped
    (the port's `init` draws on the host, leaf by leaf, and on the meta
    device its first `torch.stack` imports seconds of torch's compiler
    stack)."""
    import torch

    from bcnf_tpu_torch.bridge import map_tree

    return map_tree(lambda t: t.shape, model.init(torch.Generator(), device="cpu"))


def make_weights(model: Any, seed: int, device: Any) -> dict:
    """Random weights for `model`'s parameter tree on `device`, from the
    seed: one uniform draw into one buffer, each leaf a view of it scaled
    as torch's default initialisation scales it (U(-k, k), k = 1/sqrt(fan
    in); an LSTM's k = 1/sqrt(hidden)); ActNorm and LayerNorm start at
    scale 1 and bias 0, the fixed mixes are the Q of a QR of normal draws."""
    import torch

    shapes = parameter_shapes(model)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    total = [0]

    def count(t: Any) -> None:
        if isinstance(t, torch.Size):
            total[0] += t.numel()
        elif isinstance(t, dict):
            for v in t.values():
                count(v)
        else:
            for v in t:
                count(v)

    count(shapes)
    flat = torch.empty(total[0], device=device).uniform_(-1.0, 1.0, generator=gen)
    offset = [0]

    def view(t: Any) -> Any:
        v = flat[offset[0]: offset[0] + t.numel()].view(t)
        offset[0] += t.numel()
        return v

    def fill(t: Any, key: str = "") -> Any:
        if isinstance(t, list):
            return [fill(v) for v in t]
        if isinstance(t, torch.Size):
            if key == "ortho":  # (K, size, size): a few KB, made on the host without a solver library on the card
                rng = np.random.default_rng(derive(seed, WEIGHTS, 1))
                q = np.linalg.qr(rng.standard_normal(tuple(t)))[0].astype(np.float32)
                return view(t).copy_(torch.from_numpy(q))
            raise ValueError(f"no initialisation known for the leaf {key!r} of shape {tuple(t)}")
        if "w" in t and "b" in t and not isinstance(t["w"], dict):
            k = 1.0 / math.sqrt(t["w"][-2])
            return {n: view(v).mul_(k) for n, v in t.items()}
        if "w_hh" in t:
            k = 1.0 / math.sqrt(t["w_hh"][-2])
            return {n: view(v).mul_(k) for n, v in t.items()}
        if set(t) == {"scale", "bias"}:
            return {"scale": view(t["scale"]).fill_(1.0), "bias": view(t["bias"]).zero_()}
        return {n: fill(v, n) for n, v in t.items()}

    return fill(shapes)


def input_features(run_config: dict) -> int:
    """The trajectories' features: the first feature network's that states
    its input size."""
    for fn in run_config["feature_networks"]:
        if (fn.get("kwargs") or {}).get("input_size") is not None:
            return int(fn["kwargs"]["input_size"])
    raise ValueError("no feature network states its input size")


def trajectories(cell: Cell, seed: int, device: Any, *lead: int) -> Any:
    """Seeded standard-normal trajectories (*lead, frames, features)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(derive(seed, INPUTS))
    shape = (*lead, work.frames(cell.run_config), input_features(cell.run_config))
    return torch.randn(shape, generator=gen, device=device)


# -- one run -------------------------------------------------------------------


@dataclass
class Run:
    """What a loop hands back: the end-to-end values it measured, the work
    the traced window completed, and the output check's numbers."""

    values: dict
    attempted: int
    done: dict
    checks: dict = field(default_factory=dict)
    trace: Trace | None = None
    memory_peak_bytes: int = 0
    launches: dict = field(default_factory=dict)


def synchroniser(device: Any) -> Callable[[], None]:
    import torch

    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def window_profile(device: Any, traced: bool) -> Any:
    """The window's profile (the device's operations alone) when traced."""
    return profiled(device, host=False) if traced else contextlib.nullcontext({})


def read_trace(device: Any, holder: dict, window: float, spans: list[str], unit: Callable[[int], Any], start: int,
               calls: int, sync: Callable[[], None]) -> Trace:
    """The traced run's reading: the window's device profile, then `calls`
    more units of work profiled with the host's events for the spans."""
    busy, ops, n = device_summary(holder["prof"])
    with profiled(device, host=True) as h:
        for k in range(calls):
            unit(start + k)
        sync()
    span_device_s, span_calls, gaps = span_summary(h["prof"], spans)
    return Trace(window_s=window, busy_s=busy, device_ops=ops, n_kernels=n, idle_gaps=gaps,
                 span_device_s=span_device_s, span_calls=span_calls)


def memory_peak(device: Any) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def checked_requests(seed: int, count: int, among: int) -> set[int]:
    rng = np.random.default_rng(derive(seed, CHECKED))
    return set(int(i) for i in rng.choice(among, size=min(count, among), replace=False))




class Context:
    """What a per-layer metric's reader gets: the traced window, the cell's
    configuration and mix, the work the window completed, and the card's
    peaks."""

    def __init__(self, cell: Cell, run: Run, peaks: tuple[float, float, float]) -> None:
        self.cell, self.run_config, self.mix = cell, cell.run_config, cell.mix
        self.trace, self.done, self.peaks = run.trace, run.done, peaks


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device: Any, control: bool = False,
             t_start: float | None = None, card: str = "") -> dict:
    """One run of `cell`: set-up, the window, the output check and, when
    traced, the per-layer metrics. Returns the result line's fields
    (without `device`), with `setup_s` counted from `t_start`."""
    t_start = time.perf_counter() if t_start is None else t_start
    if traced:
        seconds = min(seconds, float(cell.mix["trace_seconds"]))
    marks: dict[str, float] = {}
    model = build_model(cell, control)
    marks["model"] = time.perf_counter()
    loop = load_module("loops", cell.mix["entry"])
    readers = {m["name"]: load_reader(m["name"]) for m in cell.per_layer} if traced else {}
    spans = dict(getattr(loop, "SPANS", {}))
    for r in readers.values():
        spans.update(getattr(r, "SPANS", {}))
    with Spans(spans if traced else {}).installed():
        run = loop.run(cell, model, seed, seconds, device, traced,
                       lambda label: marks.setdefault(label, time.perf_counter()), list(spans))
    metrics: dict[str, dict] = {}
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            value = marks["window"] - t_start
        elif quantity(m["name"]) in run.values:
            value = run.values[quantity(m["name"])]
        else:
            raise KeyError(f"the {cell.mix['entry']} loop measures no {m['name']}")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced:
        peaks = work.peaks_for(card) or work.PEAKS["H100"]
        ctx = Context(cell, run, peaks)
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell.limits["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in run.checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": run.attempted, "failed": 0, "metrics": metrics,
           "memory_peak_bytes": run.memory_peak_bytes, "launches": run.launches,
           "setup_marks": {k: v - t_start for k, v in marks.items()}}
    if run.trace is not None:
        out["trace"] = run.trace
    out["checks"] = checks
    return out

