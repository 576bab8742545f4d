"""The yardstick reproduces the operation counts and bounds the kernel
table (PERF.md) was built on."""

import json
from pathlib import Path

import pytest

from benchmark import work

ROOT = Path(__file__).resolve().parents[2]


def run_config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())["run_config"]


def test_flagship_k1_is_58_3_mflop_a_row():
    sh = work.flow_shapes(run_config("lstm_large"))
    assert (sh.S, sh.size, sh.d_a, sh.nh, sh.H, sh.n_out) == (26, 19, 10, 4, 526, 18)
    assert work.flow_work(sh, 1, 1)[0] / 1e6 == pytest.approx(58.33, abs=0.01)


def test_wide_inverse_bound_at_80000_rows():
    sh = work.flow_shapes(run_config("lstm_wide_dual"))
    ops, _ = work.flow_work(sh, 80_000, 8)
    assert 1e3 * ops / (494.7e12 / 3) == pytest.approx(131.13, abs=0.01)


def test_lstm_counts_match_k3a_per_direction():
    # K3a's step products: 8 H^2 a row and step, 19.3 GFLOP at B 4096, T 30, H 140 (PERF.md)
    assert 2 * 4096 * 30 * 140 * 4 * 140 / 1e9 == pytest.approx(19.27, abs=0.01)
    one_dir_recurrence = work.lstm_flops(0, 140, 1, 1, 30, 4096)
    assert one_dir_recurrence / 1e9 == pytest.approx(19.27, abs=0.01)


def test_shares_use_the_tf32_rate_and_the_memory_rate():
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks == (66.9e12, 494.7e12, 3.35e12)
    assert work.peaks_for("NVIDIA H100 PCIe")[1] == 378e12 and work.peaks_for("some other card") is None
    assert work.bound_seconds((494.7e12, 1.0), peaks) == pytest.approx(1.0)
    assert work.bound_seconds((1.0, 3.35e12), peaks) == pytest.approx(1.0)


def test_sample_and_train_flops_add_their_parts():
    rc = run_config("lstm_large")
    sh = work.flow_shapes(rc)
    one = work.sample_flops(rc, 1000, 100)
    assert one == pytest.approx(work.encoder_flops(rc, 100) + work.cond_proj_flops(sh, 100)
                                + work.flow_work(sh, 100_000, 100)[0])
    assert work.train_flops(rc, 4096) > 3 * work.flow_work(sh, 4096, 4096)[0]
    wide = run_config("lstm_wide_dual")
    assert work.encoder_flops(wide, 1) > 0 and work.frames(wide) == 30
