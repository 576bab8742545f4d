"""A configuration of the flagship's kind at sizes a CPU test holds, and
cells over it for each loop."""

import copy

from benchmark.harness import Cell

RUN_CONFIG = {
    "global": {"parameter_selection": ["a", "b", "c", "d", "e"], "dtype": "float32"},
    "data": {"T": 0.4, "dt": 0.067},
    "model": {"kwargs": {"size": 5, "nested_sizes": [16, 16, 16], "n_blocks": 3, "n_conditions": 12,
                         "act_norm": True, "dropout": 0.2}},
    "feature_networks": [
        {"type": "ConcatenateCondition", "kwargs": {"input_size": None, "output_size": 3}},
        {"type": "LSTM", "kwargs": {"input_size": 3, "hidden_size": 8, "output_size": 12, "num_layers": 2,
                                    "dropout": 0.1, "bidirectional": True, "pooling": "mean"}},
    ],
    "optimizer": {"type": "Adam", "kwargs": {"lr": 0.0002}},
    "lr_scheduler": {"kwargs": {}},
    "training": {"val_loss_window_size": 4, "val_loss_patience": 10, "val_loss_tolerance_mode": "abs",
                 "val_loss_tolerance": 0.1, "batch_size": 32},
}
DUAL_ENCODER = {"type": "DualDomainLSTM", "kwargs": {"input_size": 3, "hidden_size": 4, "num_layers": 1,
                                                      "dropout": 0.5, "bidirectional": True, "fc_sizes": [12],
                                                      "fc_dropout": 0.5, "pooling": "mean"}}
SAMPLE = {"entry": "sample", "draws": 50, "conditions": 4, "pool": 2, "warmup": 1, "check": 2, "check_among": 3,
          "check_rows": 64, "trace_seconds": 1, "span_calls": 2, "warmup_seconds": 0.05}
TRAIN = {"entry": "train", "batch": 32, "pool": 4, "trace_seconds": 1, "span_calls": 2, "warmup_seconds": 0.05}
LIMITS = {"rel_err": 1e-5, "row_gap": 1e-4, "nonfinite": 0, "loss_gap": 1e-5, "grad_gap": 1e-3, "change_gap": 1e-2}


def cell(entry: str, encoder: dict | None = None) -> Cell:
    rc = copy.deepcopy(RUN_CONFIG)
    if encoder is not None:
        rc["feature_networks"][1] = copy.deepcopy(encoder)
    mix = SAMPLE if entry == "sample" else TRAIN
    keys = ("rel_err", "row_gap", "nonfinite") if entry == "sample" else ("loss_gap", "grad_gap", "change_gap")
    e2e = ([{"name": "posterior_samples_per_s", "unit": "samples/s"}, {"name": "posterior_ms_p95", "unit": "ms"}]
           if entry == "sample" else [{"name": "train_samples_per_s", "unit": "samples/s"}])
    e2e.append({"name": "setup_s", "unit": "s"})
    return Cell(name=f"tiny.{entry}", config={"precision": "highest", "control_precision": "default",
                                              "run_config": rc},
                mix=dict(mix), limits={"limits": {k: LIMITS[k] for k in keys}}, end_to_end=e2e)
