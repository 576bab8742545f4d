"""`BENCHMARK.json` against the benchmark's contract, and every file it
names found by name."""

import json
import re
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_command():
    assert set(SPEC) == KEYS
    assert 1 <= len(SPEC["paths"]) <= 16 and SPEC["paths"] == ["benchmark"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(one_line(w) for w in SPEC["command"])
    assert all(not w.startswith("/") and ".." not in w for w in SPEC["command"])
    assert (ROOT / SPEC["command"][1]).is_file() and SPEC["command"][1].startswith("benchmark/")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        assert one_line(e.get("why", "x")) and one_line(e.get("layer", "x")) and one_line(e.get("source", "x"))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_entries_have_just_their_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def reported(cell: str) -> set[str]:
    return {m["name"] for m in SPEC["end_to_end"] if "workloads" not in m or cell in m["workloads"]}


def test_every_cell_reports_enough_and_each_moves_is_reported():
    cells = {w["name"] for w in SPEC["workloads"]}
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    for cell in cells:
        assert "setup_s" in reported(cell) and len(reported(cell)) >= 2, cell
        per = [m for m in SPEC["per_layer"] if cell in m.get("workloads", [])]
        assert per, cell
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        for cell in m["workloads"]:
            assert m["moves"] in reported(cell), (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files(workload):
    from benchmark.harness import BENCH, load_cell

    from benchmark.harness import load_module, load_reader, quantity
    from benchmark.reference import encoders

    cell = load_cell(workload)
    loop = load_module("loops", cell.mix["entry"])
    assert callable(loop.run)
    assert cell.limits["limits"]
    for m in cell.per_layer:
        assert callable(load_reader(m["name"]).read)
    for fn in cell.run_config["feature_networks"]:
        assert callable(encoders.find(fn["type"]).encode)
    assert all(quantity(m["name"]) in loop.MEASURES for m in cell.end_to_end if m["name"] != "setup_s")


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_is_the_published_one(conf):
    """The configuration's file holds the run configuration of the repo's
    published file unchanged (nothing is reduced), and builds a model of
    the published parameter count."""
    import torch

    from bcnf_tpu_torch.models import CondRealNVP, count_params

    data = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("benchmark/configs/")
    assert data["reduced"] == conf["reduced"] == []
    assert data["run_config"] == yaml.safe_load((ROOT / data["run_config_file"]).read_text())
    model = CondRealNVP.from_config(data["run_config"])
    with torch.device("meta"):
        params = model.init(torch.Generator(), device="meta")
    assert count_params(params) == data["params"]
    assert data["precision"] == "highest" and data["control_precision"] == "default"
