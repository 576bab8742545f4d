"""Port parity, the last modules (ROADMAP.md §1 item 12): the dataset figures
(`plots/{base,data_plots}.py`, built under Agg as tests/test_eval.py:98
builds the JAX package's), `utils/summary.py` against JAX's counts on the
same tree, `utils/profiling.py` and `utils/prng.py` on the CPU, the package
exports the JAX package has, `training.remat` (loss and grads within 1e-6
of no remat, dropout included) and `data.dtype: bfloat16` (JAX's values)."""

import pickle

import jax
import numpy as np
import pytest
import torch

import bcnf_tpu.models
import bcnf_tpu.plots
import bcnf_tpu.utils
from bcnf_tpu.config import ParameterIndexMapping as JaxMapping
from bcnf_tpu.plots import data_to_df as jax_data_to_df
from bcnf_tpu.train.data import TrainerDataHandler as JaxDataHandler
from bcnf_tpu.utils.summary import param_tree_summary as jax_param_tree_summary
import bcnf_tpu_torch
import bcnf_tpu_torch.models
import bcnf_tpu_torch.plots
import bcnf_tpu_torch.utils
from bcnf_tpu_torch.bridge import map_tree, params_to_numpy, tree_leaves
from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.factories import OptimizerFactory, SchedulerFactory
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork
from bcnf_tpu_torch.plots import DataConvariancePlot, DataCovariancePlot, DataDistributionPlot, corr_coeff, data_to_df
from bcnf_tpu_torch.train import Trainer
from bcnf_tpu_torch.train.data import TrainerDataHandler
from bcnf_tpu_torch.train.optim import ReduceLROnPlateau
from bcnf_tpu_torch.utils import (
    fold_in_step,
    key_from_seed,
    key_stream,
    model_summary,
    param_tree_summary,
    split_like,
)
from bcnf_tpu_torch.utils.misc import get_data_type, inn_nll_loss
from bcnf_tpu_torch.utils.prng import fold_in
from bcnf_tpu_torch.utils.profiling import StepTimer, benchmark, device_memory_stats, trace


def _model(dropout: float = 0.0) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(None, 3), LSTMFeatureNetwork(3, 6, 8, 2, dropout=0.2)])
    return CondRealNVP(size=5, nested_sizes=[16, 16], n_blocks=4, n_conditions=8, feature_network_stack=stack,
                       act_norm=True, random_state=0, dropout=dropout)


def _plot_data() -> dict:
    return {
        "m": list(np.random.default_rng(0).random(50)),
        "b": list(np.random.default_rng(1).random(50)),
        "cam_angles": [np.array([1.0, 2.0])] * 50,
        "trajectories": [np.zeros((5, 3))] * 50,
    }


def test_data_plots_create():
    df = data_to_df(_plot_data())
    assert set(df.columns) == {"m", "b", "cam_angles_0", "cam_angles_1"}
    assert df.equals(jax_data_to_df(_plot_data()))
    cov = DataCovariancePlot(df)
    cov.create_plots(bins=10)
    assert len(cov.figs) >= 2 and DataConvariancePlot is DataCovariancePlot
    dist = DataDistributionPlot(df)
    dist.create_plots(bins=10)
    assert len(dist.figs) == 1
    a = np.zeros(5)
    assert corr_coeff(a, a) == 1.0 and corr_coeff(a, np.arange(5.0)) == 0.0
    assert corr_coeff(np.arange(5.0), 2 * np.arange(5.0)) == pytest.approx(1.0)


def test_save_plots(tmp_path):
    dist = DataDistributionPlot(data_to_df(_plot_data()))
    dist.create_plots(bins=5)
    dist.save_plots(str(tmp_path / "figs"), "dist")
    assert (tmp_path / "figs" / "dist_0.png").exists()


def test_param_tree_summary_matches_jax():
    model = _model()
    params = params_to_numpy(model.init(torch.Generator().manual_seed(0), device="cpu"))
    for depth in (1, 2, 3):
        assert param_tree_summary(params, max_depth=depth) == jax_param_tree_summary(params, max_depth=depth)
    ours = model_summary(model)
    assert ours.splitlines()[-1].split()[-1] == f"{sum(a.size for a in tree_leaves(params)):,}"
    assert ours == param_tree_summary(model.init(torch.Generator().manual_seed(0), device="cpu"))


def test_step_timer_benchmark_and_trace(tmp_path):
    timer = StepTimer()
    assert timer.summary() == {}
    for _ in range(3):
        with timer:
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = timer.summary()
    assert s["steps"] == 3 and s["total_s"] >= s["mean_s"] > 0 and s["p99_s"] >= s["p50_s"]
    calls = []
    out = benchmark(lambda x: calls.append(x) or x * 2, torch.ones(4), warmup=2, iters=5)
    assert len(calls) == 7 and out["mean_s"] > 0 and out["per_sec"] == pytest.approx(1 / out["mean_s"])
    with trace(str(tmp_path / "prof")):
        torch.ones(8) + 1
    assert (tmp_path / "prof" / "trace.json").exists()
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}


def test_prng_helpers_are_deterministic_per_seed():
    assert fold_in(3, 1) == fold_in(3, 1) != fold_in(3, 2) != fold_in(4, 1)
    assert fold_in_step(7, 5) == fold_in(7, 5)

    def draw(g):
        return torch.rand(4, generator=g)

    assert torch.equal(draw(key_from_seed(11)), draw(key_from_seed(11)))
    assert not torch.equal(draw(key_from_seed(11)), draw(key_from_seed(12)))
    assert draw(key_from_seed(None)).shape == (4,)
    a, b = split_like(5, ("data", "dropout")), split_like(5, ("data", "dropout"))
    assert torch.equal(draw(a["data"]), draw(b["data"])) and not torch.equal(draw(a["dropout"]), draw(a["data"]))
    s1, s2 = key_stream(9), key_stream(9)
    first = [draw(next(s1)) for _ in range(3)]
    assert all(torch.equal(x, draw(next(s2))) for x in first) and not torch.equal(first[0], first[1])


def test_exports_match_the_jax_package():
    assert sorted(bcnf_tpu_torch.utils.__all__) == sorted(bcnf_tpu.utils.__all__)
    assert all(hasattr(bcnf_tpu_torch.utils, n) for n in bcnf_tpu.utils.__all__)
    assert sorted(bcnf_tpu_torch.plots.__all__) == sorted(bcnf_tpu.plots.__all__)
    assert bcnf_tpu_torch.plots is bcnf_tpu_torch.__dict__["plots"] and "plots" in bcnf_tpu_torch.__all__
    assert sorted(bcnf_tpu_torch.models.__all__) == sorted(bcnf_tpu.models.__all__)
    assert callable(bcnf_tpu_torch.models.load_pretrained_features)  # bcnf_tpu/models/__init__.py:60
    opt = OptimizerFactory.get_optimizer("Adam", {"lr": 1e-3}).init({"w": torch.zeros(2, requires_grad=True)})
    assert opt.torch_optimizer.param_groups[0]["lr"] == 1e-3
    assert isinstance(SchedulerFactory.get_scheduler("ReduceLROnPlateau", {"patience": 3}), ReduceLROnPlateau)
    with pytest.raises(NotImplementedError):
        SchedulerFactory.get_scheduler("StepLR", {})


@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["no_dropout", "dropout"])
def test_remat_leaves_loss_and_grads(dropout):
    """`remat` checkpoints each block of the plain path; the recomputation
    replays the block's dropout draws, so loss and grads stay those of no
    remat (JAX's `jax.checkpoint` of its block scan)."""
    model = _model(dropout)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(size=(12, 5)).astype(np.float32))
    traj = torch.from_numpy(rng.normal(size=(12, 7, 3)).astype(np.float32))
    out = []
    for remat in (False, True):
        model.remat = remat
        p = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
        gen = torch.Generator().manual_seed(3)
        z, ld = model.forward(p, y, traj, generator=gen, train=True)
        loss = inn_nll_loss(z, ld)
        loss.backward()
        out.append((float(loss), [t.grad for t in tree_leaves(p)], gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = out
    assert abs(l0 - l1) <= 1e-6 and torch.equal(s0, s1)  # the generator ends where it would without remat
    for a, b in zip(g0, g1):
        if a is None:
            assert b is None
        else:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0)


def test_trainer_takes_training_remat():
    model = _model()
    rng = np.random.default_rng(1)
    y, traj = rng.normal(size=(24, 5)).astype(np.float32), rng.normal(size=(24, 7, 3)).astype(np.float32)
    cfg = {"global": {"dtype": "float32"}, "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
           "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {}},
           "training": {"validation_split": 0.25, "val_loss_window_size": 1, "val_loss_patience": 50,
                        "val_loss_tolerance_mode": "rel", "val_loss_tolerance": 1e-3, "batch_size": 6, "n_epochs": 2,
                        "random_state": 0}}
    hists = []
    for remat in (False, True):
        t = Trainer(dict(cfg, training=dict(cfg["training"], remat=remat)), data=(y, [traj]), device="cpu")
        t.train(model, model.init(torch.Generator().manual_seed(0), device="cpu"))
        assert model.remat is remat
        hists.append([v for _, v in t.meta_scheduler.parameter_history["val_loss"]])
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-6)


def test_bfloat16_dataset_loads_to_jax_values(tmp_path):
    names = ["x0_x", "v0_z", "m"]
    rng = np.random.default_rng(2)
    data = {"trajectories": rng.normal(size=(10, 6, 3)) * 37.3, "cam_angles": rng.normal(size=(10, 2))}
    data.update({n: rng.normal(size=10) * 3.1 for n in names})
    path = tmp_path / "d.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    cfg = {"data": {"path": str(path), "output_type": "trajectories"},
           "global": {"conditions": [["trajectories"], ["cam_angles"]]}}
    assert get_data_type("bfloat16") == torch.bfloat16
    y, conds = TrainerDataHandler().get_data_for_training(cfg, ParameterIndexMapping(names), dtype=torch.bfloat16)
    jy, jconds = JaxDataHandler().get_data_for_training(cfg, JaxMapping(names), dtype=jax.numpy.bfloat16)
    np.testing.assert_array_equal(y, np.asarray(jy, dtype=np.float32))
    for a, b in zip(conds, jconds):
        np.testing.assert_array_equal(a, np.asarray(b, dtype=np.float32))
    assert not np.array_equal(y, np.asarray(data["x0_x"], np.float32))  # the values were rounded
    with pytest.raises(ValueError, match="not one of"):
        TrainerDataHandler().get_data_for_training(cfg, ParameterIndexMapping(names), dtype=torch.int32)
