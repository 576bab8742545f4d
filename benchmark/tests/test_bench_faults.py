"""A run with the timed path broken underneath comes out not correct: the
rest of a run (set-up, window, the output check against the reference) on
the CPU at a tiny size, the look for a card skipped. Sampling: an answer
altered where it is produced, half of the draws left out, a row not
finite. Training: a step that leaves the state unchanged, half of the
batch left out."""

import pytest
import torch

import tiny
from benchmark import harness

CPU = torch.device("cpu")
BIG_SEED = 2**31 + 12345


def run(entry, seed=BIG_SEED):
    return harness.run_cell(tiny.cell(entry), seed, 0.2, False, CPU)


@pytest.mark.parametrize("entry", ["sample", "train"])
def test_sound_runs_are_correct_and_report_their_metrics(entry):
    out = run(entry)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and set(out["metrics"]) >= {"setup_s"}
    assert list(out)[-1] == "checks"


def test_the_same_seed_gives_the_same_inputs_and_weights():
    cell = tiny.cell("sample")
    model = harness.build_model(cell)
    a, b = (harness.make_weights(model, BIG_SEED, CPU) for _ in range(2))
    assert torch.equal(a["blocks"]["coupling"]["a"]["layers"][1]["w"], b["blocks"]["coupling"]["a"]["layers"][1]["w"])
    ortho = a["blocks"]["ortho"]
    assert torch.allclose(ortho @ ortho.transpose(-1, -2), torch.eye(5).expand_as(ortho), atol=1e-5)
    assert torch.equal(harness.trajectories(cell, BIG_SEED, CPU, 2), harness.trajectories(cell, BIG_SEED, CPU, 2))
    assert harness.derive(2**40 + 3, 1) != harness.derive(2**40 + 3, 2) < 2**63


def broken_sample(monkeypatch, how):
    from bcnf_tpu_torch.models.cnf import CondRealNVP

    orig = CondRealNVP.sample_from_z

    def sample_from_z(self, params, z, *conditions, outer=True):
        if how == "half":
            half = orig(self, params, z[: z.shape[0] // 2], *conditions, outer=outer)
            return torch.cat([half, half], dim=0)
        out = orig(self, params, z, *conditions, outer=outer).clone()
        out[3, 1, 2] = float("nan") if how == "nonfinite" else out[3, 1, 2] + 0.5
        return out

    monkeypatch.setattr(CondRealNVP, "sample_from_z", sample_from_z)


@pytest.mark.parametrize("how,caught", [("altered", "row_gap"), ("half", "rel_err"), ("nonfinite", "nonfinite")])
def test_a_broken_sample_is_not_correct(monkeypatch, how, caught):
    broken_sample(monkeypatch, how)
    out = run("sample")
    assert not out["correct"]
    assert out["checks"][caught]["value"] > out["checks"][caught]["limit"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from bcnf_tpu_torch.train.optim import ClippedOptimizer

    monkeypatch.setattr(ClippedOptimizer, "step", lambda self: None)
    out = run("train")
    assert not out["correct"] and out["checks"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from bcnf_tpu_torch.train.trainer import Trainer

    orig = Trainer.shard_grads

    def shard_grads(self, model, replicas, y, conditions, generators):
        half = y.shape[0] // 2
        return orig(self, model, replicas, y[:half], [c[:half] for c in conditions], generators)

    monkeypatch.setattr(Trainer, "shard_grads", shard_grads)
    out = run("train")
    assert not out["correct"] and out["checks"]["loss_gap"]["value"] > out["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("name", ["lstm_large", "lstm_wide_dual", "tiny"])
def test_parameter_shapes_are_the_models_tree(name):
    """The harness's shape tree has `CondRealNVP.init`'s structure, shapes
    and leaf order, so the weights it makes fill the tree the program
    expects."""
    import json

    from bcnf_tpu_torch.bridge import tree_leaves
    from bcnf_tpu_torch.models import CondRealNVP

    if name == "tiny":
        rc = tiny.cell("sample").run_config
    else:
        rc = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())["run_config"]
    model = CondRealNVP.from_config(rc)
    with torch.device("meta"):
        ref = model.init(torch.Generator(), device="meta")

    def structure(tree):
        if isinstance(tree, (torch.Tensor, torch.Size)):
            return tuple(tree.shape) if isinstance(tree, torch.Tensor) else tuple(tree)
        if isinstance(tree, dict):
            return {k: structure(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [structure(v) for v in tree]
        raise TypeError(type(tree))

    got = harness.parameter_shapes(model)
    assert structure(got) == structure(ref)
    got_leaves = [tuple(s) for s in _size_leaves(got)]
    assert got_leaves == [tuple(t.shape) for t in tree_leaves(ref)]


def _size_leaves(tree):
    if isinstance(tree, torch.Size):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _size_leaves(v)]
    return [s for v in tree for s in _size_leaves(v)]
