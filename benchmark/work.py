"""Operations and bytes from a configuration's shapes, and the card's peaks.

The yardstick of every share the benchmark reports: a roofline share is the
least time the work could take on the card (the larger of its operations
over the peak rate and its bytes over the memory rate) over the time it
took; an `mfu` share is the operations over the window's seconds over the
peak rate. Operations are those the mathematics needs at the unpadded
widths, each input read once and each output written once, whatever a
kernel pads, splits or reads again.

Every float32 configuration is held to the TF32 dense rate (494.7 TFLOP/s on
an H100 SXM): no float32-accurate route is faster, so no share can pass 100%
whichever route (3xTF32, FMA, one pass) a later change takes, and the same
work keeps the same bound.

`flow_work` is a copy of `chip_smoke.py`'s, taking the shapes from the run
configuration instead of stacked kernel arguments.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# Published dense peaks (NVIDIA data sheets) by card name fragment, most
# specific first: float32 outside the tensor cores, TF32 on the tensor
# cores, and device-memory bandwidth (`chip_smoke.py::PEAKS`).
PEAKS = {
    "H100 PCIe": (51.2e12, 378e12, 2.0e12),
    "H100 NVL": (60.0e12, 417.5e12, 3.9e12),
    "H100": (66.9e12, 494.7e12, 3.35e12),  # SXM5
    "H200": (66.9e12, 494.7e12, 4.8e12),
}


def peaks_for(card: str) -> tuple[float, float, float] | None:
    """(float32, TF32, bytes/s) peaks of the card named `card`, or None."""
    for fragment, peaks in PEAKS.items():
        if fragment in card:
            return peaks
    return None


@dataclass(frozen=True)
class FlowShapes:
    """The whole-flow shapes of one configuration: S steps (the inner blocks
    and the final coupling), the parameter size, the conditioned half d_a,
    nh hidden-to-hidden products a step at width H, the conditioner's
    n_out outputs, and n_cond condition features."""

    S: int
    size: int
    d_a: int
    nh: int
    H: int
    n_out: int
    n_cond: int


def flow_shapes(run_config: dict) -> FlowShapes:
    kw = run_config["model"]["kwargs"]
    size, nested = int(kw["size"]), [int(n) for n in kw["nested_sizes"]]
    if len(set(nested)) != 1:
        raise ValueError(f"the flow's hidden widths {nested} are not one width")
    d_a = math.ceil(size / 2)
    return FlowShapes(S=int(kw["n_blocks"]), size=size, d_a=d_a, nh=len(nested) - 1, H=nested[0],
                      n_out=2 * (size - d_a), n_cond=int(kw["n_conditions"]))


def _mlp_flops(sh: FlowShapes) -> int:
    """One row through one step's conditioner, the condition's part of the
    first layer left out (`cond_proj_flops`)."""
    return 2 * (sh.d_a * sh.H + sh.nh * sh.H * sh.H + sh.H * sh.n_out)


def flow_work(sh: FlowShapes, rows: int, n_cond_rows: int) -> tuple[float, float]:
    """Operations and bytes of one K1 call (either direction) over `rows`
    rows conditioned on `n_cond_rows` condition rows: every step's
    conditioner and every mix; the weights, the condition projections and
    the rows read once, the rows (and a log-det each) written once."""
    flops = rows * (sh.S * _mlp_flops(sh) + (sh.S - 1) * 2 * sh.size * sh.size)
    weights = sh.S * (2 * sh.size + sh.size * sh.size + sh.d_a * sh.H + sh.H
                      + sh.nh * (sh.H * sh.H + sh.H) + sh.H * sh.n_out + sh.n_out)
    nbytes = 4 * (weights + sh.S * n_cond_rows * sh.H + 2 * rows * sh.size + rows)
    return float(flops), float(nbytes)


def cond_proj_flops(sh: FlowShapes, n_cond_rows: int) -> float:
    """The condition's part of every step's first layer, h @ W1_h, computed
    once a condition row."""
    return float(2 * n_cond_rows * sh.n_cond * sh.H * sh.S)


def frames(run_config: dict) -> int:
    """Frames of the configuration's trajectories, T / dt."""
    return int(round(float(run_config["data"]["T"]) / float(run_config["data"]["dt"])))


def lstm_flops(F: int, H: int, layers: int, dirs: int, T: int, rows: int) -> float:
    """Forward products of a (bidirectional) multi-layer LSTM over `rows`
    sequences of T steps: each direction's input projection and step
    products."""
    total, width = 0, F
    for _ in range(layers):
        total += dirs * 2 * T * (width * 4 * H + H * 4 * H)
        width = dirs * H
    return float(rows * total)


def encoder_flops(run_config: dict, rows: int) -> float:
    """Forward products of the configuration's feature networks over `rows`
    condition rows, each counted by its plain encoder's file
    (`reference/encoders/<type>.py`)."""
    from benchmark.reference import encoders

    T = frames(run_config)
    return float(sum(encoders.find(fn["type"]).flops(fn.get("kwargs") or {}, T, rows)
                     for fn in run_config["feature_networks"]))


def sample_flops(run_config: dict, draws: int, n_cond_rows: int) -> float:
    """One `CondRealNVP.sample` of `draws` draws for each of `n_cond_rows`
    condition rows: the encoder and the condition projections once a
    condition row, the flow's inverse once a draw."""
    sh = flow_shapes(run_config)
    return (encoder_flops(run_config, n_cond_rows) + cond_proj_flops(sh, n_cond_rows)
            + flow_work(sh, draws * n_cond_rows, n_cond_rows)[0])


def train_flops(run_config: dict, rows: int) -> float:
    """One training step over `rows` rows: forward and backward of every
    product. A product with a trained weight costs three times its forward
    (the forward, the input's and the weight's gradients); the fixed mixes
    twice (no weight gradient)."""
    sh = flow_shapes(run_config)
    trained = (encoder_flops(run_config, rows) + cond_proj_flops(sh, rows) + rows * sh.S * _mlp_flops(sh))
    mixes = rows * (sh.S - 1) * 2 * sh.size * sh.size
    return 3.0 * trained + 2.0 * mixes


def bound_seconds(work: tuple[float, float], peaks: tuple[float, float, float]) -> float:
    """The least time for (operations, bytes) on a card of `peaks`: the
    larger of the operations over the TF32 dense rate and the bytes over the
    memory rate."""
    return max(work[0] / peaks[1], work[1] / peaks[2])
