"""Port parity, the video path: `bcnf_tpu_torch.models.cnn`, the toy video
model of `tests/test_video_model.py`, `simulation/video_processing.py`,
`plots/debug_plotting.py` and `utils/misc.py`'s kernel helpers against the
JAX package on the CPU.

The port's CNN has one conv path (`F.conv2d`); JAX's has two, XLA's conv
(`train=False`) and an im2col product for a layer with c_in·k·k <= 128 in
training (`bcnf_tpu/models/cnn.py:63-84`): the port is held against both.
Bars: features and flow outputs atol 1e-4 (`tests/test_flow_kernel.py`),
grads atol 5e-4, rtol 1e-3 (`tests/test_flow_kernel.py:313`). The NumPy
modules are copies and agree exactly.
"""

import glob
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import bcnf_tpu.simulation.video_processing as jax_vp
from bcnf_tpu.factories import FeatureNetworkFactory as JaxFactory
from bcnf_tpu.models.cnn import CNN as JaxCNN
from bcnf_tpu.utils.misc import get_gaussian_kernel as jax_gaussian_kernel
from bcnf_tpu.utils.misc import partconv1d as jax_partconv1d
from bcnf_tpu_torch.bridge import params_from_numpy, params_to_numpy, tree_leaves
from bcnf_tpu_torch.config import sub_root_path
from bcnf_tpu_torch.factories import FeatureNetworkFactory
from bcnf_tpu_torch.models import (
    CNN,
    ConcatenateCondition,
    CondRealNVP,
    FeatureNetworkStack,
    LSTMFeatureNetwork,
)
from bcnf_tpu_torch.simulation import video_processing
from bcnf_tpu_torch.utils.misc import get_gaussian_kernel, partconv1d
from tests.test_video_model import _video_model as jax_video_model

ROOT = sub_root_path("{{BCNF_ROOT}}")
VIDEO_CONFIGS = sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "configs/runs/**/*.yaml"), recursive=True)
    if any(fn.get("type") == "CNN" for fn in (yaml.safe_load(open(p)).get("feature_networks") or []))
)


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _cnn_kwargs(run_config: str) -> dict:
    with open(os.path.join(ROOT, run_config)) as f:
        cfg = yaml.safe_load(f)
    return dict(next(fn["kwargs"] for fn in cfg["feature_networks"] if fn["type"] == "CNN"))


def test_there_are_the_eight_video_configs():
    assert len(VIDEO_CONFIGS) == 8 and "configs/runs/videos_CNN_LSTM_large.yaml" in VIDEO_CONFIGS


@pytest.mark.parametrize("rel", VIDEO_CONFIGS, ids=lambda r: os.path.basename(r)[:-5])
def test_cnn_plan_and_feature_size_match_jax(rel):
    """Each video config's CNN from both registries: the same layer plan
    (the padding quirk included) and the same feature size."""
    kw = _cnn_kwargs(rel)
    ours, ref = FeatureNetworkFactory.get_feature_network("CNN", kw), JaxFactory.get_feature_network("CNN", kw)
    assert isinstance(ours, CNN)
    assert ours.plan == ref.plan and ours.final_output_size == ref.final_output_size
    assert (ours.output_size, ours.output_size_lin, ours.num_CNN) == (ref.output_size, ref.output_size_lin,
                                                                      ref.num_CNN)


def test_published_video_cnn_plan():
    """`videos_CNN_LSTM_large`'s CNN: JAX's plan, 8064 features a camera,
    a head of 16128 -> 1000."""
    cnn = FeatureNetworkFactory.get_feature_network("CNN", _cnn_kwargs("configs/runs/videos_CNN_LSTM_large.yaml"))
    assert cnn.plan == [(1, 8, 8, 1, (3, 3)), (8, 16, 5, 1, (3, 3)), (16, 32, 3, 1, (2, 2))]
    assert cnn.final_output_size == 8064
    head = cnn.init(torch.Generator().manual_seed(0))["head"]
    assert tuple(head["w"].shape) == (16128, 1000)


def _small_cnns(num_cnn: int, dropout: float = 0.0):
    kw = dict(hidden_channels=[4, 8, 6], kernel_sizes=[5, 3, 3], strides=[1, 1, 2], output_size_lin=16,
              output_size=16, image_input_size=(18, 32), dropout_prob=dropout, num_CNN=num_cnn)
    return JaxCNN(**kw), CNN(**kw)


@pytest.mark.parametrize("train", [False, True], ids=["xla_conv", "im2col"])
@pytest.mark.parametrize("num_cnn", [1, 2])
def test_cnn_forward_on_bridged_weights_matches_jax(num_cnn, train):
    """The port's conv path against JAX's inference conv and its training
    im2col product (dropout 0), on the same bridged weights; the bridge
    copies the towers' OIHW weights both ways unchanged."""
    jnet, net = _small_cnns(num_cnn)
    assert jnet.plan == net.plan
    jp = _np_tree(jnet.init(jax.random.key(num_cnn)))
    tp = params_from_numpy(jp, "cpu")
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)))
    x = np.random.default_rng(5).uniform(size=(3, 2, 4, 18, 32)).astype(np.float32)
    ref = np.asarray(jnet.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), train=train))
    ours = net.apply(tp, torch.from_numpy(x), train=train).numpy()
    assert ours.shape == ref.shape == (3, 4, 16)
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("num_cnn", [1, 2])
def test_cnn_weight_grads_match_jax(num_cnn):
    """Every conv weight and bias grad and the head's, pulled back from the
    same cotangent, against `jax.grad` of JAX's training path (im2col in the
    first layer, dropout 0)."""
    jnet, net = _small_cnns(num_cnn)
    jp = _np_tree(jnet.init(jax.random.key(7)))
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(2, 2, 3, 18, 32)).astype(np.float32)
    ct = rng.normal(size=(2, 3, 16)).astype(np.float32)
    ref = jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x), train=True) * ct))(jax.tree.map(jnp.asarray, jp))
    tp = params_from_numpy(jp, "cpu", requires_grad=True)
    (net.apply(tp, torch.from_numpy(x), train=True) * torch.from_numpy(ct)).sum().backward()
    for ours, theirs in zip(tree_leaves(tp), jax.tree.leaves(ref)):
        np.testing.assert_allclose(ours.grad.numpy(), np.asarray(theirs), atol=5e-4, rtol=1e-3)


def test_cnn_dropout_draws_from_the_generator():
    _, net = _small_cnns(1, dropout=0.5)
    p = net.init(torch.Generator().manual_seed(0))
    x = torch.rand((2, 2, 3, 18, 32), generator=torch.Generator().manual_seed(1))
    a = net.apply(p, x, torch.Generator().manual_seed(2), train=True)
    assert torch.equal(a, net.apply(p, x, torch.Generator().manual_seed(2), train=True))
    assert not torch.equal(a, net.apply(p, x, torch.Generator().manual_seed(3), train=True))
    assert torch.equal(net.apply(p, x), net.apply(p, x, torch.Generator().manual_seed(2), train=False))


def _port_video_model(n_meta: int = 7) -> CondRealNVP:
    """`tests/test_video_model.py:_video_model` in the port."""
    lstm_out = 24
    stack = FeatureNetworkStack([
        ConcatenateCondition(input_size=None, output_size=(18, 32)),
        CNN(hidden_channels=[4, 8], kernel_sizes=[3, 3], strides=[1, 1], output_size_lin=16, output_size=16,
            image_input_size=(18, 32), dropout_prob=0.2, num_CNN=1),
        LSTMFeatureNetwork(input_size=16, hidden_size=8, output_size=lstm_out, num_layers=1),
        ConcatenateCondition(input_size=lstm_out, output_size=lstm_out + n_meta, dim=-1),
    ])
    return CondRealNVP(size=19, nested_sizes=[16], n_blocks=2, n_conditions=lstm_out + n_meta,
                       feature_network_stack=stack, act_norm=True, random_state=0)


def test_toy_video_model_forward_log_prob_and_sample_match_jax():
    """The toy video model (render-shaped videos -> CNN -> LSTM -> metadata
    concat -> flow) on bridged weights, ActNorm perturbed: `forward`,
    `log_prob`, and `sample` against JAX's inverse on the z the port drew."""
    jm, tm = jax_video_model(), _port_video_model()
    tm.verify()
    jp = _np_tree(jm.init(jax.random.key(0)))
    rng = np.random.default_rng(9)
    an = jp["blocks"]["actnorm"]
    an["scale"] = an["scale"] + 0.1 * rng.normal(size=an["scale"].shape).astype(np.float32)
    an["bias"] = 0.1 * rng.normal(size=an["bias"].shape).astype(np.float32)
    tp, jpj = params_from_numpy(jp, "cpu"), jax.tree.map(jnp.asarray, jp)
    B = 3
    videos = rng.uniform(size=(B, 2, 4, 18, 32)).astype(np.float32)
    meta = rng.normal(size=(B, 7)).astype(np.float32)
    y = rng.normal(size=(B, 19)).astype(np.float32)
    conds_t, conds_j = (torch.from_numpy(videos), torch.from_numpy(meta)), (jnp.asarray(videos), jnp.asarray(meta))
    z, ld, h = tm.forward(tp, torch.from_numpy(y), *conds_t, return_features=True)
    z_r, ld_r, h_r = jm.forward(jpj, jnp.asarray(y), *conds_j, return_features=True)
    assert h.shape == (B, 31)
    for ours, ref in ((z, z_r), (ld, ld_r), (h, h_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm.log_prob(tp, torch.from_numpy(y), *conds_t).numpy(),
                               np.asarray(jm.log_prob(jpj, jnp.asarray(y), *conds_j)), atol=1e-4, rtol=0)
    samples = tm.sample(tp, torch.Generator().manual_seed(4), 5, *conds_t, device="cpu")
    z_drawn = torch.randn((5, B, 19), generator=torch.Generator().manual_seed(4))
    h_j = jm.encode(jpj, conds_j)
    ref = jax.vmap(lambda zz: jm.inverse_given_h(jpj, zz, h_j))(jnp.asarray(z_drawn.numpy()))
    assert samples.shape == (5, B, 19)
    np.testing.assert_allclose(samples.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tm.inverse(tp, z, *conds_t).numpy(), y, atol=5e-4, rtol=0)  # the round trip


# ---------------------------------------------------------------------------
# real-video ingestion and the debug plots (host-side NumPy copies)
# ---------------------------------------------------------------------------


def _footage(n_frames: int = 12, height: int = 180, width: int = 320) -> np.ndarray:
    """BGR frames: a fixed textured background and a bright square that moves."""
    rng = np.random.default_rng(0)
    background = rng.uniform(0, 50, size=(height, width, 3))
    frames = np.repeat(background[None], n_frames, axis=0)
    for t in range(n_frames):
        r, c = 40 + 6 * t, 60 + 15 * t
        frames[t, r: r + 24, c: c + 24] = 255.0
    return frames.astype(np.uint8)


class _StubCapture:
    """`cv2.VideoCapture` over in-memory frames keyed by path."""

    FRAMES: dict = {}

    def __init__(self, path: str) -> None:
        self.frames, self.pos = list(self.FRAMES[path]), 0

    def get(self, prop: int) -> float:
        return float(self.frames[0].shape[1])

    def isOpened(self) -> bool:
        return self.pos <= len(self.frames)

    def read(self):
        self.pos += 1
        return (True, self.frames[self.pos - 1]) if self.pos <= len(self.frames) else (False, None)

    def release(self) -> None:
        self.pos = len(self.frames) + 1


@pytest.fixture
def stub_cv2(monkeypatch):
    """A `cv2` module that serves `_footage` to both packages, for this test only."""
    stub = types.ModuleType("cv2")
    stub.VideoCapture, stub.CAP_PROP_FRAME_WIDTH = _StubCapture, 3
    monkeypatch.setitem(sys.modules, "cv2", stub)
    monkeypatch.setattr(_StubCapture, "FRAMES", {"cam1.mp4": _footage(), "cam2.mp4": _footage(10)[:, ::-1]})
    return stub


@pytest.mark.parametrize("gmm", [False, True], ids=["thresholded", "gmm"])
def test_process_video_matches_jax(stub_cv2, gmm):
    ours = video_processing.process_video("cam1.mp4", use_gmm_approximation=gmm)
    ref = jax_vp.process_video("cam1.mp4", use_gmm_approximation=gmm)
    assert ours.shape == ref.shape == (11, 90, 160)
    np.testing.assert_array_equal(ours, ref)
    assert (ours.sum(axis=(1, 2)) > 0.99).all()  # every frame keeps the moving square


def test_video_tensors_match_jax(stub_cv2):
    for grey in (False, True):
        ours = video_processing.video_to_tensor("cam1.mp4", greyscale=grey)
        np.testing.assert_array_equal(ours, jax_vp.video_to_tensor("cam1.mp4", greyscale=grey))
    two = video_processing.two_camera_videos_to_tensor("cam1.mp4", "cam2.mp4")
    np.testing.assert_array_equal(two, jax_vp.two_camera_videos_to_tensor("cam1.mp4", "cam2.mp4"))
    assert two.shape == (10, 2, 180, 320)


def test_gmm_approximation_matches_jax():
    frames = np.zeros((3, 90, 160))
    rng = np.random.default_rng(1)
    frames[0, 30:40, 50:70] = rng.uniform(size=(10, 20))
    frames[2, 70:75, 100:130] = 1.0  # frame 1 stays empty
    ours = video_processing.gmm_approximation(frames, n_mc_samples=2000)
    np.testing.assert_array_equal(ours, jax_vp.gmm_approximation(frames, n_mc_samples=2000))
    assert ours.shape == (3, 90, 160) and (ours[1] == 0).all()
    np.testing.assert_allclose(ours[[0, 2]].sum(axis=(1, 2)), 1.0)


def test_make_gif_writes_a_gif(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    from bcnf_tpu_torch.plots.debug_plotting import debug_plotting, make_gif, show_camera_image

    video = np.random.default_rng(2).uniform(size=(3, 9, 16))
    make_gif(video, str(tmp_path / "v.gif"), interval_ms=10)
    assert (tmp_path / "v.gif").read_bytes()[:3] == b"GIF"
    traj = np.random.default_rng(3).normal(size=(5, 3))
    assert len(debug_plotting(traj, traj + 1).axes) == 4
    assert show_camera_image(video[0]).axes[0].images


@pytest.mark.parametrize("sigma,window", [(2.0, None), (0.7, 3), (5.0, 4)])
def test_gaussian_kernel_and_partconv1d_match_jax(sigma, window):
    kernel = get_gaussian_kernel(sigma, window)
    np.testing.assert_array_equal(kernel, jax_gaussian_kernel(sigma, window))
    data = np.random.default_rng(4).normal(size=40)
    for periodic in (False, True):
        np.testing.assert_array_equal(partconv1d(data, kernel, periodic), jax_partconv1d(data, kernel, periodic))
    with pytest.raises(ValueError, match="odd"):
        partconv1d(data, np.ones(4))
    with pytest.raises(ValueError, match="numpy"):
        partconv1d(list(data), kernel)
