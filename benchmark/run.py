"""Run one cell of the benchmark of bcnf_tpu_torch on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), `device`, with ``--trace 1`` `breakdown`, and last
`checks`, each number the output check compared beside its limit (also the
last lines on standard error). Exits non-zero, printing no result, where
the program cannot be imported, where there is no CUDA card (or fewer than
the cell asks for), or where JAX or the JAX package is loaded once the
window has closed.

Two options are for the output check's readings, not for measured runs:
``--control`` runs the configuration's lower precision in the program's
place, and ``--seeds a,b,...`` runs the cell once a seed in one process,
printing each run's checks and end-to-end values.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that prints
# the result: JAX, its libraries, and the JAX package beside the port
FORBIDDEN = ("jax", "jaxlib", "flax", "bcnf_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def refuse_forbidden() -> bool:
    """Whether JAX or the JAX package is loaded, named on standard error."""
    found = forbidden_modules()
    if found:
        print(f"benchmark: {', '.join(found)} loaded in the process that prints the result", file=sys.stderr)
    return bool(found)


def clear_stale_build(build_dir: Path) -> None:
    """Remove what a killed build left in the program's build directory: a
    `lock` file and half-written libraries. One run uses the card at a time,
    so nothing else is building there."""
    for path in [build_dir / "lock", *build_dir.glob("*.tmp")]:
        path.unlink(missing_ok=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in checks.items()]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true", help="the configuration's lower precision (readings only)")
    ap.add_argument("--seeds", default="", help="comma-separated seeds, one run each in this process (readings only)")
    args = ap.parse_args(argv)

    marks = {}
    try:
        import torch

        marks["torch imported"] = time.perf_counter() - T0
        from benchmark import harness, work
        from bcnf_tpu_torch.ops import _build

        marks["program imported"] = time.perf_counter() - T0
    except ImportError as e:
        print(f"benchmark: cannot import the program under test: {e}", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); this machine has {have}", file=sys.stderr)
        return 2
    clear_stale_build(_build.BUILD_DIR)
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(0)
    torch.zeros(1, device=device)
    marks["card ready"] = time.perf_counter() - T0

    if args.seeds:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(cell, seed, args.seconds, False, device, args.control, card=card)
            if refuse_forbidden():
                return 3
            line = {"seed": seed, "control": args.control, "correct": out["correct"], "attempted": out["attempted"],
                    "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                    "memory_peak_bytes": out["memory_peak_bytes"], "checks": out["checks"]}
            print(json.dumps(line), flush=True)
        return 0

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, args.control, t_start=T0,
                           card=card)
    peaks = work.peaks_for(card)
    print(f"card: {power_limit()}; published peaks: "
          + (f"TF32 {peaks[1] / 1e12} TFLOP/s, {peaks[2] / 1e12} TB/s" if peaks else "none known (H100 SXM's used)"),
          file=sys.stderr)
    if _build.build_seconds:
        print(f"built this run: {json.dumps(_build.build_seconds)}", file=sys.stderr)
    print(f"K1 launches by route in the window: {json.dumps(out['launches'])}", file=sys.stderr)
    marks.update(out["setup_marks"])
    print("set-up, seconds from the start: " + ", ".join(f"{k} {v:.3f}" for k, v in marks.items()), file=sys.stderr)

    if refuse_forbidden():
        return 3
    dev = {"platform": "gpu", "kind": card, "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": out["metrics"], "device": dev}
    trace = out.get("trace")
    if trace is not None:
        dev["busy_s"], dev["window_s"] = trace.busy_s, trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops, "idle_gaps": trace.idle_gaps}
        print(f"traced: {trace.n_kernels} device operations; spans {json.dumps(trace.span_device_s)} "
              f"over calls {json.dumps(trace.span_calls)}", file=sys.stderr)
    if _build.build_seconds:
        result["build_s"] = dict(_build.build_seconds)
    result["checks"] = out["checks"]
    for line in check_lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
