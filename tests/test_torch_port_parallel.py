"""Port parity, data parallelism (`bcnf_tpu_torch/parallel/mesh.py`): the
mirror of tests/test_parallel.py on a 4-shard CPU mesh (`make_mesh(4,
device="cpu")`) at its widths (size 3, nested_sizes [16], 3 blocks, dropout
0). Sharded loss and grads against one device's (rtol 1e-5, atol 1e-5, the
JAX test's bars) and the loss against the JAX package's single-device loss
on the same params; ranks equal exactly and resimulation within 1e-6, as
the JAX test holds its mesh. JAX is compared on one device only: a JAX mesh
in tier-1's shared workers would depend on which module set the CPU device
count first."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import ConcatenateCondition as JaxConcat
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu.models import FeatureNetworkStack as JaxStack
from bcnf_tpu.models import FullyConnectedFeatureNetwork as JaxFC
from bcnf_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from bcnf_tpu.utils.misc import inn_nll_loss as jax_nll
from bcnf_tpu_torch.bridge import map_tree, params_to_numpy, tree_leaves
from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.eval.calibration import compute_y_hat_ranks
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, FullyConnectedFeatureNetwork
from bcnf_tpu_torch.parallel import (
    Mesh,
    batch_sharding,
    ensure_cpu_devices,
    even_batch,
    gather,
    is_host_zero,
    make_2d_mesh,
    make_mesh,
    pad_to_multiple,
    pmean,
    pmean_grads,
    replicate,
    replicate_trainable,
    replicated,
    sample_sharded,
    shard_batch,
)
from bcnf_tpu_torch.simulation.resimulation import resimulate
from bcnf_tpu_torch.train import Trainer, make_optimizer
from bcnf_tpu_torch.utils.misc import inn_nll_loss

MODEL_KW = dict(size=3, nested_sizes=[16], n_blocks=3, n_conditions=8, act_norm=True, random_state=0)


def _model() -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(None, 4), FullyConnectedFeatureNetwork(sizes=[4, 16, 8])])
    return CondRealNVP(feature_network_stack=stack, **MODEL_KW)


@pytest.fixture(scope="module")
def model_and_params():
    model = _model()
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def _batch(seed: int, n: int = 16) -> tuple[torch.Tensor, torch.Tensor]:
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)))


def _config(n_epochs: int = 3, batch_size: int = 16) -> dict:
    return {
        "global": {"dtype": "float32"},
        "optimizer": {"type": "Adam", "kwargs": {"lr": 2e-3}},
        "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {}},
        "training": {"validation_split": 0.25, "val_loss_window_size": 2, "val_loss_patience": 50,
                     "val_loss_tolerance_mode": "rel", "val_loss_tolerance": 1e-3, "batch_size": batch_size,
                     "n_epochs": n_epochs, "timeout": None, "random_state": 0},
    }


def _data(n: int = 80) -> tuple[np.ndarray, list[np.ndarray]]:
    rng = np.random.default_rng(7)
    return rng.normal(size=(n, 3)).astype(np.float32), [rng.normal(size=(n, 4)).astype(np.float32)]


def test_four_cpu_shards_available():
    mesh = make_mesh(4, device="cpu")
    assert mesh.size == 4 and mesh.devices == [torch.device("cpu")] * 4
    assert mesh.local_shards == [0, 1, 2, 3] and mesh.group is None and mesh.process_count == 1
    assert make_mesh(device="cpu").size == 1  # default: every visible device, one CPU
    ensure_cpu_devices(8)  # kept for the name; nothing to set in torch


def test_sharded_loss_matches_single_device_and_jax(model_and_params):
    model, params = model_and_params
    mesh = make_mesh(4, device="cpu")
    y, cond = _batch(0)
    z, ld = model.forward(params, y, cond)
    expected = float(inn_nll_loss(z, ld))
    per_shard = []
    for p, (ys, cs) in zip(replicate(mesh, params), shard_batch(mesh, (y, cond))):
        zs, lds = model.forward(p, ys, cs)
        per_shard.append([inn_nll_loss(zs, lds)])
    got = float(pmean(mesh, per_shard)[0])
    np.testing.assert_allclose(got, expected, rtol=1e-5)
    # the JAX package's single-device loss on the same params
    jm = JaxCondRealNVP(feature_network_stack=JaxStack([JaxConcat(None, 4), JaxFC(sizes=[4, 16, 8])]), **MODEL_KW)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(params))
    jz, jld = jm.forward(jp, jnp.asarray(y.numpy()), jnp.asarray(cond.numpy()))
    np.testing.assert_allclose(got, float(jax_nll(jz, jld)), rtol=1e-5)


def test_sharded_gradients_match(model_and_params):
    model, params = model_and_params
    mesh = make_mesh(4, device="cpu")
    y, cond = _batch(1)
    p1 = map_tree(lambda t: t.detach().clone().requires_grad_(True), params)
    z, ld = model.forward(p1, y, cond)
    inn_nll_loss(z, ld).backward()
    trainer = Trainer(_config(), data=_data(), mesh=mesh)
    replicas = replicate_trainable(trainer.mesh, map_tree(lambda t: t.detach().clone().requires_grad_(True), params))
    metrics = trainer.shard_grads(model, replicas, y, [cond], trainer.shard_generators(0))
    np.testing.assert_allclose(float(metrics[1]), float(inn_nll_loss(z, ld)), rtol=1e-5)
    for a, b in zip(tree_leaves(replicas[0]), tree_leaves(p1)):
        ref = torch.zeros_like(b) if b.grad is None else b.grad
        np.testing.assert_allclose(a.grad.numpy(), ref.numpy(), atol=1e-5)


def test_sharded_train_step_runs(model_and_params):
    model, params = model_and_params
    mesh = make_mesh(4, device="cpu")
    trainer = Trainer(_config(), data=_data(), mesh=mesh)
    replicas = replicate_trainable(trainer.mesh, map_tree(lambda t: t.detach().clone().requires_grad_(True), params))
    assert len(replicas) == 4 and all(a is not b for a, b in zip(tree_leaves(replicas[0]), tree_leaves(replicas[1])))
    opt = make_optimizer("Adam", lr=1e-3).init(replicas[0])
    y, cond = _batch(2, n=32)
    losses = [float(trainer.train_step(model, replicas, opt, y, [cond], trainer.shard_generators(0))[0])
              for _ in range(5)]
    assert losses[-1] < losses[0]
    for r in replicas[1:]:  # the first replica's update is copied into the others
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(r), tree_leaves(replicas[0])))


def test_one_shard_mesh_is_the_single_device_step(model_and_params):
    """Without a mesh the Trainer steps on one shard: its reduce is the
    identity (the tensors themselves, no copy), and its grads are a plain
    backward's bit for bit."""
    model, params = model_and_params
    one = Mesh(["cpu"])
    t = torch.arange(6.0)
    assert pmean(one, [[t]])[0] is t
    trainer = Trainer(_config(), data=_data(), device="cpu")
    assert trainer.mesh.size == 1 and trainer.mesh.devices == [torch.device("cpu")]
    y, cond = _batch(3)
    p1 = map_tree(lambda x: x.detach().clone().requires_grad_(True), params)
    z, ld = model.forward(p1, y, cond)
    inn_nll_loss(z, ld).backward()
    replicas = replicate_trainable(trainer.mesh, map_tree(lambda x: x.detach().clone().requires_grad_(True), params))
    metrics = trainer.shard_grads(model, replicas, y, [cond], trainer.shard_generators(0))
    kept = [p.grad for p in tree_leaves(replicas[0])]
    pmean_grads(one, replicas)  # the one replica's grads are the mean already
    assert all(a is p.grad for a, p in zip(kept, tree_leaves(replicas[0])))
    assert float(metrics[1]) == float(inn_nll_loss(z, ld))
    for a, b in zip(tree_leaves(replicas[0]), tree_leaves(p1)):
        assert (a.grad is None) == (b.grad is None) and (a.grad is None or torch.equal(a.grad, b.grad))


def test_even_batch_rounds_down_and_refuses_an_empty_shard():
    mesh = make_mesh(4, device="cpu")
    assert even_batch(mesh, 30) == 28 and even_batch(mesh, 4) == 4 and even_batch(Mesh(["cpu"]), 3) == 3
    with pytest.raises(ValueError, match="gives no row to each of 4 shards"):
        even_batch(mesh, 3)


def test_batch_sharding_layout():
    mesh = make_mesh(4, device="cpu")
    assert batch_sharding(mesh, 16) == [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    assert replicated(mesh) == [slice(None)] * 4
    x = np.arange(16 * 5 * 2, dtype=np.float32).reshape(16, 5, 2)
    shards = shard_batch(mesh, (x, [x[:, 0]]))
    for i, (a, (b,)) in enumerate(shards):  # shard i holds rows 4i..4i+3 of every leaf, in shard order
        np.testing.assert_array_equal(a.numpy(), x[4 * i:4 * i + 4])
        np.testing.assert_array_equal(b.numpy(), x[4 * i:4 * i + 4, 0])
    np.testing.assert_array_equal(gather(mesh, [a for a, _ in shards]).numpy(), x)
    with pytest.raises(ValueError, match="does not shard evenly"):
        shard_batch(mesh, (x[:10],))
    assert make_2d_mesh(2, 3, device="cpu") == [[torch.device("cpu")] * 3] * 2
    one = Mesh(["cpu"])  # the single-device paths' mesh: the whole batch and the params themselves
    t = torch.from_numpy(x)
    (whole,) = shard_batch(one, t)
    assert whole.data_ptr() == t.data_ptr() and whole.shape == t.shape and replicate(one, t)[0] is t
    assert is_host_zero()


def test_sharded_ranks_match_single_device(model_and_params):
    """`eval --dp-devices`: each batch of draws is drawn once for all rows,
    so the sharded ranks are the single-device ranks exactly."""
    model, params = model_and_params
    y, cond = _batch(0, n=32)
    kw = dict(M_samples=64, sample_batch_size=32, batch_size=16, device="cpu")
    ranks_1 = compute_y_hat_ranks(model, params, y, cond, generator=torch.Generator().manual_seed(3), **kw)
    ranks_4 = compute_y_hat_ranks(model, params, y, cond, generator=torch.Generator().manual_seed(3),
                                  mesh=make_mesh(4, device="cpu"), **kw)
    np.testing.assert_array_equal(ranks_1, ranks_4)
    # and the sharded samples are one device's
    mesh = make_mesh(4, device="cpu")
    s1 = model.sample(params, torch.Generator().manual_seed(5), 6, cond, device="cpu")
    s4 = sample_sharded(mesh, model, replicate(mesh, params), torch.Generator().manual_seed(5), 6, cond)
    np.testing.assert_array_equal(s1.numpy(), s4.numpy())


class TinyPosterior:
    """A stand-in whose samples are a fixed map of the draws, so the mesh
    against single-device comparison isolates the resimulation path."""

    parameter_index_mapping = ParameterIndexMapping(["x0_z", "v0_z", "m"])
    size = 3

    def draw_z(self, generator, n_samples, n_rows):
        return torch.rand((n_samples, n_rows, 3), generator=generator, device=generator.device)

    def sample_from_z(self, params, z, *conditions):
        return z + 0.5 + torch.tensor([5.0, 0.0, 0.0])

    def sample(self, params, generator, m, *conditions, device=None):
        return self.sample_from_z(params, self.draw_z(generator, m, conditions[0].shape[0]))


def test_sharded_resimulate_matches_single_device():
    tiny = TinyPosterior()
    cond = torch.from_numpy(np.random.default_rng(1).normal(size=(16, 4)).astype(np.float32))
    data = {"b": np.full(16, 0.1), "rho": np.full(16, 1.2), "r": np.full(16, 0.1)}
    kw = dict(m_samples=8, sample_batch_size=8, device="cpu")
    X1 = resimulate(tiny, None, 1.0, 1 / 15, data, None, cond, generator=torch.Generator().manual_seed(5), **kw)
    X4 = resimulate(tiny, None, 1.0, 1 / 15, data, None, cond, generator=torch.Generator().manual_seed(5),
                    mesh=make_mesh(4, device="cpu"), **kw)
    assert X1.shape == (16, 8, 15, 3) and np.isfinite(X1).all()
    np.testing.assert_allclose(X1, X4, rtol=0, atol=1e-6)


def test_sharded_resimulate_of_the_model_matches_single_device(model_and_params):
    model, params = model_and_params
    model = copy.copy(model)
    model.parameter_index_mapping = ParameterIndexMapping(["x0_z", "v0_z", "w_x"])
    _, cond = _batch(3, n=8)
    data = {"m": np.full(8, 0.2), "b": np.full(8, 0.1), "rho": np.full(8, 1.2), "r": np.full(8, 0.1),
            "g_z": np.full(8, -9.81)}
    kw = dict(m_samples=12, sample_batch_size=5, device="cpu")
    X1 = resimulate(model, params, 1.0, 1 / 15, data, None, cond, generator=torch.Generator().manual_seed(2), **kw)
    X4 = resimulate(model, params, 1.0, 1 / 15, data, None, cond, generator=torch.Generator().manual_seed(2),
                    mesh=make_mesh(4, device="cpu"), **kw)
    np.testing.assert_allclose(X1, X4, rtol=0, atol=1e-6)


def test_pad_to_multiple_matches_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(10, 3)), rng.normal(size=(10,)), rng.normal(size=(10, 2, 2))]
    for multiple in (1, 4, 5, 8):
        ours, pad = pad_to_multiple(arrays, multiple)
        ref, ref_pad = jax_pad_to_multiple(arrays, multiple)
        assert pad == ref_pad
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)


def test_make_mesh_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    if torch.cuda.is_available():
        pytest.skip("checks the device rule of a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, device="cuda")


def test_trainer_on_a_mesh_matches_one_device():
    """`Trainer.train` on 4 CPU shards gives one device's losses: the same
    shuffles, a mean of equal-shard means, exact validation sums."""
    model = _model()
    p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
    hists = []
    for mesh in (None, make_mesh(4, device="cpu")):
        t = Trainer(copy.deepcopy(_config()), data=_data(), device="cpu", mesh=mesh)
        t.train(model, p0)
        h = t.meta_scheduler.parameter_history
        hists.append([v for k in ("train_loss", "val_loss", "z_std_mean") for _, v in h[k]])
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-5)


def test_trainer_rounds_the_batch_to_the_mesh():
    model = _model()
    p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
    t = Trainer(_config(n_epochs=1, batch_size=18), data=_data(), mesh=make_mesh(4, device="cpu"))
    t.train(model, p0)  # 60 training rows at 16 a step (18 rounded down): 3 steps
    assert len(t.meta_scheduler.parameter_history["train_loss"]) == 1
    with pytest.raises(ValueError, match="no row"):
        Trainer(_config(n_epochs=1), data=_data(n=4), mesh=make_mesh(4, device="cpu")).train(model, p0)


def test_checkpoint_resume_across_topology(tmp_path):
    """A checkpoint written under a 4-shard mesh resumes on a 2-shard mesh,
    and that one's on one device: checkpoints hold one replica."""
    model = _model()
    ckpt = str(tmp_path / "ckpts")
    Trainer(_config(n_epochs=4), data=_data(), checkpoint_dir=ckpt, checkpoint_every=2,
            mesh=make_mesh(4, device="cpu")).train(model)
    assert (tmp_path / "ckpts" / "ckpt_3.pkl").exists()
    t2 = Trainer(_config(n_epochs=6), data=_data(), checkpoint_dir=ckpt, checkpoint_every=2,
                 mesh=make_mesh(2, device="cpu"))
    params = t2.train(model)
    assert min(e for e, _ in t2.meta_scheduler.parameter_history["val_loss"]) == 5  # resumed after epoch 4
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
    t3 = Trainer(_config(n_epochs=8), data=_data(), checkpoint_dir=ckpt, checkpoint_every=2, device="cpu")
    params = t3.train(model)
    assert min(e for e, _ in t3.meta_scheduler.parameter_history["val_loss"]) == 7
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))
