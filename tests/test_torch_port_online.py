"""Port parity, online training: `bcnf_tpu_torch.train.online` against
`bcnf_tpu.train.online` on the CPU.

JAX's PRNG cannot be reproduced in torch, so `OnlineSimulator` is held
through its two stages: JAX's own draws for a key (`sample_batch`'s split
into the prior's key and the noise key, `bcnf_tpu/train/online.py:99-100`)
go to the port's `assemble`, and the batch must be JAX's: `y` and the
camera metadata exactly, trajectories at the simulator tests' bar
(`tests/test_torch_port_simulation.py`: |d| <= 1e-5 (1 + max|row|)), and
the analytic videos against JAX's render stage on the port's own rows at
its renderer bar (1e-5, plus the one-ulp bin-edge term that bar was set
from). The cosine schedule is held against optax's, and
`train_online` by what it must do: improve, resume bit for bit, refuse a
mesh.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bcnf_tpu.train.online as jax_online
from bcnf_tpu.config import ParameterIndexMapping as JaxMapping
from bcnf_tpu.simulation import camera as jax_camera
from bcnf_tpu.simulation.priors import sample_ballistic_parameters as jax_prior_draws
from bcnf_tpu.simulation.sampling import _stage_render as jax_stage_render
from bcnf_tpu.train.online import OnlineSimulator as JaxOnlineSimulator
from bcnf_tpu_torch.bridge import tree_leaves
from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.models import (
    CNN,
    ConcatenateCondition,
    CondRealNVP,
    FeatureNetworkStack,
    FullyConnectedFeatureNetwork,
    LSTMFeatureNetwork,
)
from bcnf_tpu_torch.parallel import make_mesh
from bcnf_tpu_torch.train.online import OnlineSimulator, train_online
from bcnf_tpu_torch.train.optim import cosine_decay_schedule
from tests.test_sampling import PRIOR

PARAMS = ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g",
          "w_x", "w_y", "w_z", "b", "m", "a_x", "a_y", "a_z", "r", "A", "Cd", "rho"]
CAMERA = ["cam_radian", "cam_radius", "cam_angles", "cam_heights"]
TRAJ_REL = 1e-5  # the simulator tests' trajectory bar
FRAME_TOL = 1e-5  # the simulator tests' analytic-renderer bar
EDGE_ULP = 2 * 6e-8  # two float32 ulps of a bin edge (|edge| <= 35 deg)


def _jax_draws(sim: JaxOnlineSimulator, key: jax.Array, batch: int, n_steps: int, noise: bool) -> dict:
    """The draws JAX's `sample_batch(key, batch)` makes, as the port's `draw` returns them."""
    key, _, k_noise = jax.random.split(key, 3)
    p = jax_online.sample_ballistic_parameters(key, math.ceil(batch * sim.oversample), sim.prior.data, sim.num_cams)
    draws = {"params": {k: torch.from_numpy(np.array(v)) for k, v in p.items()}}
    if noise:
        draws["noise"] = torch.from_numpy(np.array(jax.random.normal(k_noise, (batch, n_steps, 3))))
    return draws


def _assert_trajectories_close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape and np.isfinite(ours).all() and np.isfinite(ref).all()
    scale = 1.0 + np.abs(ref).max(axis=(-2, -1))
    assert (np.abs(ours - ref).max(axis=(-2, -1)) <= TRAJ_REL * scale).all()


def _sims(groups, **kw):
    return (JaxOnlineSimulator(PRIOR, JaxMapping(PARAMS), condition_groups=groups, **kw),
            OnlineSimulator(PRIOR, ParameterIndexMapping(PARAMS), condition_groups=groups, **kw))


@pytest.mark.parametrize("groups,noise", [
    ([["videos"], CAMERA, ["trajectories"]], 0.0),
    ([["trajectories"]], 1.5),
    ([["trajectories"], ["x0_x", "v0_z"], ["cam_radian"]], 0.1),
], ids=["videos", "noisy_trajectories", "mixed_groups"])
def test_online_simulator_on_jax_draws_gives_jax_batch(groups, noise):
    batch, key = 24, jax.random.key(0)
    jsim, sim = _sims(groups, dt=0.067, T=0.6, observation_noise=noise)
    y_ref, c_ref = jsim.sample_batch(key, batch)
    y, conds = sim.assemble(_jax_draws(jsim, key, batch, sim.n_steps, noise > 0), batch)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    assert len(conds) == len(c_ref)
    for group, ours, ref in zip(groups, conds, c_ref):
        ours, ref = ours.numpy(), np.asarray(ref)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        if group == ["trajectories"]:
            _assert_trajectories_close(ours, ref)
        elif group != ["videos"]:
            np.testing.assert_array_equal(ours, ref)
    if ["videos"] in groups:
        _assert_videos_are_the_rows_rendered(y.numpy(), conds[0].numpy(), conds[1].numpy(), conds[2].numpy())


def _assert_videos_are_the_rows_rendered(y: np.ndarray, videos: np.ndarray, cam: np.ndarray, traj: np.ndarray) -> None:
    """The port's videos against JAX's render stage on the port's own rows
    (trajectories, cameras, radii). Where the ball's image lies inside the
    frame (its border rows and columns hold <= 1e-4 of the mass), within
    the renderer's bar, 1e-5, plus what one float32 ulp between the
    packages' bin edges (6e-8 rad, `linspace`) moves: up to
    ulp * pdf_max = ulp / (sqrt(2 pi) sigma) a axis, at the ball's angular
    std sigma, two ulps each way. A frame whose ball is cut by its edge is
    normalized over the in-view mass, which both packages take as float32
    differences of normal CDFs near 0 or 1: those frames are held to be
    zero together, to sum alike (1 or 0) and within 0.05 in total variation."""
    n_cams, n_steps = videos.shape[1], videos.shape[2]
    p = {"cam_radius": cam[:, 2], "cam_angles": cam[:, 3:5], "cam_heights": cam[:, 5:7], "r": y[:, PARAMS.index("r")]}
    ref, _ = jax_stage_render.__wrapped__(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(traj), jnp.asarray(cam[:, :2]),
        n_cams, (16, 9), 70.0, "analytic", False)
    ref = np.asarray(ref)
    assert videos.shape == ref.shape == (len(y), n_cams, n_steps, 90, 160)
    cams = np.asarray(jax_camera.get_cams_position(jnp.asarray(cam[:, :2]), jnp.asarray(cam[:, 2]),
                                                   jnp.asarray(cam[:, 5:7]), False))  # (B, cams, 3)
    dist = np.linalg.norm(traj[:, None] - cams[:, :, None], axis=-1)  # (B, cams, T)
    sigma = np.arctan(p["r"][:, None, None] * jax_camera.RADIUS_TO_STD / dist)
    bar = FRAME_TOL + 2 * EDGE_ULP / (np.sqrt(2 * np.pi) * sigma)
    border = (ref[..., 0, :].sum(-1) + ref[..., -1, :].sum(-1) + ref[..., 1:-1, 0].sum(-1)
              + ref[..., 1:-1, -1].sum(-1))
    inner = border <= 1e-4
    d = np.abs(videos - ref)
    assert (d.max(axis=(-2, -1))[inner] <= bar[inner]).all()
    assert np.array_equal(videos.any(axis=(-2, -1)), ref.any(axis=(-2, -1)))
    np.testing.assert_allclose(videos.sum(axis=(-2, -1)), ref.sum(axis=(-2, -1)), atol=FRAME_TOL, rtol=0)
    assert (0.5 * d.sum(axis=(-2, -1)) <= 0.05).all()


def test_online_simulator_takes_rejected_rows_when_acceptance_undershoots(monkeypatch):
    """With fewer accepted candidates than `batch`, both packages fill the
    batch with the rejected rows that follow them in the stable order (JAX's
    docstring says accepted rows repeat; the code does not, ROADMAP.md §3)."""
    batch = 16

    def mostly_underground(key, n, prior, num_cams=2):
        p = jax_prior_draws(key, n, prior, num_cams)
        return dict(p, x0_z=p["x0_z"].at[: n - 4].set(-1.0))  # 4 accepted rows of 20

    monkeypatch.setattr(jax_online, "sample_ballistic_parameters", mostly_underground)
    jsim, sim = _sims([["trajectories"]], dt=0.1, T=0.4)  # a shape no other test traces
    key = jax.random.key(11)
    y_ref, (t_ref,) = jsim.sample_batch(key, batch)
    y, (traj,) = sim.assemble(_jax_draws(jsim, key, batch, sim.n_steps, False), batch)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_ref))
    underground = y[:, PARAMS.index("x0_z")].numpy() < 0
    assert underground.sum() == batch - 4 and not underground[:4].any()
    assert np.array_equal(np.isfinite(traj.numpy()), np.isfinite(np.asarray(t_ref)))
    fin = np.isfinite(np.asarray(t_ref)).all(axis=(1, 2))
    _assert_trajectories_close(traj.numpy()[fin], np.asarray(t_ref)[fin])


def test_sample_batch_draws_then_assembles_and_is_deterministic_per_seed():
    sim = OnlineSimulator(PRIOR, ParameterIndexMapping(PARAMS), dt=0.1, T=0.5, observation_noise=0.1)
    y1, (t1,) = sim.sample_batch(torch.Generator().manual_seed(7), 16)
    y2, (t2,) = sim.sample_batch(torch.Generator().manual_seed(7), 16)
    assert y1.shape == (16, 19) and t1.shape == (16, 5, 3) and torch.isfinite(t1).all()
    assert torch.equal(y1, y2) and torch.equal(t1, t2)
    g = torch.Generator().manual_seed(7)
    y3, (t3,) = sim.assemble(sim.draw(g, 16), 16)
    assert torch.equal(y1, y3) and torch.equal(t1, t3)
    assert not torch.equal(y1, sim.sample_batch(torch.Generator().manual_seed(8), 16)[0])
    assert (y1[:, PARAMS.index("g")] < 0).all()  # `g` resolves through the g_z alias


@pytest.mark.parametrize("steps,alpha", [(100, 0.02), (7, 0.0), (1, 0.5)])
def test_cosine_schedule_matches_optax(steps, alpha):
    ours = cosine_decay_schedule(2e-4, steps, alpha=alpha)
    ref = optax.cosine_decay_schedule(2e-4, steps, alpha=alpha)
    counts = list(range(steps + 3))
    # optax evaluates the schedule in float32 (a few roundings of 6e-8 each)
    np.testing.assert_allclose([ours(c) for c in counts], [float(ref(c)) for c in counts], rtol=4e-6, atol=0)
    with pytest.raises(ValueError):
        cosine_decay_schedule(1e-3, 0)


def _toy_online_model(n_cond: int = 24) -> CondRealNVP:
    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=3),
                                 FullyConnectedFeatureNetwork(sizes=[15, 32, n_cond])])
    return CondRealNVP(size=19, nested_sizes=[32], n_blocks=3, n_conditions=n_cond, feature_network_stack=stack,
                       act_norm=True, random_state=0)


def _toy_sim() -> OnlineSimulator:
    return OnlineSimulator(PRIOR, ParameterIndexMapping(PARAMS), dt=0.1, T=0.5)


def test_train_online_improves_its_eval_nll():
    model = _toy_online_model()
    params = model.init(device="cpu")
    trained, history = train_online(model, params, _toy_sim(), n_steps=60, batch_size=64, lr=2e-3, eval_every=20,
                                    lr_decay=True, device="cpu")
    evals = [v for _, v in history["eval_nll"]]
    assert [s for s, _ in history["eval_nll"]] == [20, 40, 60] and len(history["train_loss"]) == 3
    assert evals[-1] < evals[0], f"online training did not improve: {evals}"
    assert history["stop_reason"] == "max_steps"
    assert all(torch.isfinite(t).all() and not t.requires_grad for t in tree_leaves(trained))
    # the data-dependent ActNorm init ran, and the caller's tree is untouched
    assert not torch.all(trained["blocks"]["actnorm"]["scale"] == 1.0)
    assert torch.all(params["blocks"]["actnorm"]["scale"] == 1.0)


def test_train_online_checkpoint_resume_is_bit_exact(tmp_path):
    """40 steps + resume to 60 reproduces an unbroken 60-step run: the
    checkpoint restores params, optimizer state and step, and each step's
    batch comes from its own seed."""
    model, sim = _toy_online_model(), _toy_sim()
    p0 = model.init(device="cpu")
    kw = dict(batch_size=32, lr=2e-3, eval_every=1000, device="cpu")
    straight, _ = train_online(model, p0, sim, n_steps=60, **kw)
    ckpt = tmp_path / "online_ckpts"
    train_online(model, p0, sim, n_steps=40, checkpoint_dir=str(ckpt), checkpoint_every=20, **kw)
    assert sorted(f.name for f in ckpt.glob("*.pkl")) == ["online_20.pkl", "online_40.pkl"]
    resumed, hist = train_online(model, p0, sim, n_steps=60, checkpoint_dir=str(ckpt), checkpoint_every=20,
                                 resume=True, **kw)
    for a, b in zip(tree_leaves(straight), tree_leaves(resumed)):
        assert torch.equal(a, b)
    # the history continues the checkpoint's: the 40-step run's last-step eval, then this one's
    assert [s for s, _ in hist["eval_nll"]] == [40, 60] and (ckpt / "online_60.pkl").exists()


def test_train_online_mesh_dp_improves():
    """Online training on a 4-shard CPU mesh (tests/test_online.py:89): each
    shard simulates its rows from its own stream, the grads are mean-reduced."""
    model = _toy_online_model()
    params, history = train_online(model, model.init(device="cpu"), _toy_sim(), n_steps=40, batch_size=64, lr=2e-3,
                                   eval_every=20, mesh=make_mesh(4, device="cpu"))
    evals = [v for _, v in history["eval_nll"]]
    assert np.isfinite(evals).all() and evals[-1] < evals[0], f"mesh online training did not improve: {evals}"
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))


def test_train_online_checkpoint_resume_onto_mesh(tmp_path):
    """A single-device online checkpoint resumes onto a mesh
    (tests/test_online.py:137): the checkpoint holds one replica."""
    model, sim = _toy_online_model(), _toy_sim()
    ckpt = str(tmp_path / "online_ckpts")
    train_online(model, model.init(device="cpu"), sim, n_steps=20, batch_size=32, lr=2e-3, eval_every=10,
                 checkpoint_dir=ckpt, checkpoint_every=10, device="cpu")
    params, hist = train_online(model, model.init(torch.Generator().manual_seed(1), device="cpu"), sim, n_steps=30,
                                batch_size=32, lr=2e-3, eval_every=10, checkpoint_dir=ckpt, checkpoint_every=10,
                                resume=True, mesh=make_mesh(4, device="cpu"))
    steps = [s for s, _ in hist["eval_nll"]]
    assert steps == [10, 20, 30]  # the restored history carried on to the new budget
    assert all(torch.isfinite(t).all() for t in tree_leaves(params))


def test_train_online_refuses_a_mesh_and_stops_at_its_timeout():
    """A mesh trains (a batch that is a multiple of its size; JAX's
    ValueError otherwise); the timeout stops the loop."""
    model, sim = _toy_online_model(), _toy_sim()
    with pytest.raises(ValueError, match="must divide the mesh size 4"):
        train_online(model, model.init(device="cpu"), sim, n_steps=1, batch_size=6, mesh=make_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="gives no row to each of 4 shards"):
        train_online(model, model.init(device="cpu"), sim, n_steps=1, batch_size=0, mesh=make_mesh(4, device="cpu"))
    params, history = train_online(model, model.init(device="cpu"), sim, n_steps=1, batch_size=8,
                                   mesh=make_mesh(2, device="cpu"))
    assert history["stop_reason"] == "max_steps" and all(torch.isfinite(t).all() for t in tree_leaves(params))
    _, history = train_online(model, model.init(device="cpu"), sim, n_steps=50, batch_size=8, timeout=0.0,
                              device="cpu")
    assert history["stop_reason"] == "timeout" and history["eval_nll"] == []


def test_train_online_video_model_runs():
    """Online video training on the CPU: render -> CNN (two towers) -> LSTM
    -> metadata concat -> flow, with the hybrid loss; losses finite."""
    n_meta, lstm_out = 7, 24
    stack = FeatureNetworkStack([
        ConcatenateCondition(input_size=None, output_size=(20, 30)),
        CNN(hidden_channels=[4, 8], kernel_sizes=[3, 3], strides=[1, 1], output_size_lin=16, output_size=16,
            image_input_size=(20, 30), dropout_prob=0.2, num_CNN=2),
        LSTMFeatureNetwork(input_size=16, hidden_size=8, output_size=lstm_out, num_layers=1),
        ConcatenateCondition(input_size=lstm_out, output_size=lstm_out + n_meta, dim=-1),
    ])
    model = CondRealNVP(size=19, nested_sizes=[16], n_blocks=2, n_conditions=lstm_out + n_meta,
                        feature_network_stack=stack, act_norm=True, random_state=0, hybrid=True, dropout=0.1)
    sim = OnlineSimulator(PRIOR, ParameterIndexMapping(PARAMS), condition_groups=[["videos"], CAMERA],
                          dt=0.1, T=0.5, ratio=(3, 2))
    params, history = train_online(model, model.init(device="cpu"), sim, n_steps=3, batch_size=4, eval_every=3,
                                   eval_batches=1, hybrid_weight=0.5, device="cpu")
    assert np.isfinite(history["train_loss"][-1][1]) and np.isfinite(history["eval_nll"][-1][1])
