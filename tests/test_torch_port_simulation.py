"""Port parity, simulator slice: `bcnf_tpu_torch.simulation` and
`bcnf_tpu_torch.native` against `bcnf_tpu.simulation` and `bcnf_tpu.native`
on the same inputs, on the CPU.

JAX's PRNG cannot be reproduced in torch, so the integrators, renderers and
resimulation get the same parameter rows, sample points and posterior draws
in both packages; the priors are held to JAX's by a two-sample KS test.
Trajectories are float32 in both packages and integrate the same RK4 steps
in a different rounding order: they agree to |d| <= 1e-5 (1 + max|row|)
(`TRAJ_REL`), and a row that is non-finite in one is non-finite in the other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import ks_2samp

from bcnf_tpu import native as jax_native
from bcnf_tpu.config import ParameterIndexMapping as JaxMapping
from bcnf_tpu.config import load_yaml as jax_load_yaml
from bcnf_tpu.simulation import camera as jcam
from bcnf_tpu.simulation import physics as jphys
from bcnf_tpu.simulation import priors as jpriors
from bcnf_tpu.simulation import resimulation as jresim
from bcnf_tpu.simulation import sampling as jsampling
from bcnf_tpu_torch import native
from bcnf_tpu_torch.config import ParameterIndexMapping
from bcnf_tpu_torch.config import load_yaml
from bcnf_tpu_torch.simulation import camera, physics, priors, resimulation, sampling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR = os.path.join(REPO, "configs", "data_prior.yaml")
PRIOR_FAMILY = ["config", "big", "windy", "old", "throw_upwards", "throw_upwards_no_a"]
TRAJ_REL = 1e-5
VECS = ("x0", "v0", "g", "w", "a")
SCALARS = ("b", "m", "rho", "r")


def _prior_rows(n: int = 40, seed: int = 0) -> dict[str, np.ndarray]:
    """Prior draws (JAX's) plus the rows the integrators find hard: no wind,
    a stiff drag tail, a runaway (thrust beats gravity) and rows that hit
    the ground within the first steps."""
    spec = jax_load_yaml(PRIOR).to_dict()
    p = {k: np.array(v) for k, v in jax.device_get(
        jpriors.sample_ballistic_parameters(jax.random.key(seed), n, spec)).items()}
    p["w_x"][0] = p["w_y"][0] = p["w_z"][0] = 0.0  # w = 0: the safe norm
    p["b"][1], p["m"][1], p["v0_x"][1] = 2.0, 0.05, 40.0  # stiff: c = 0.5 b / m = 20
    p["b"][2], p["m"][2], p["v0_z"][2] = 5.0, 0.01, 30.0  # past RK4's stability at dt 0.1
    p["a_z"][3] = 30.0  # runaway
    p["x0_z"][4], p["v0_z"][4] = 0.2, -5.0  # hits the ground in the first step
    p["x0_z"][5], p["v0_z"][5] = 0.5, -2.0
    return p


def _args(p: dict, to) -> list:
    vec = {k: to(np.stack([p[f"{k}_x"], p[f"{k}_y"], p[f"{k}_z"]], -1).astype(np.float32)) for k in VECS}
    sc = {k: to(p[k].astype(np.float32)) for k in SCALARS}
    return [vec["x0"], vec["v0"], vec["g"], vec["w"], sc["b"], sc["m"], sc["rho"], sc["r"], vec["a"]]


def _assert_trajectories_close(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape
    fin_o, fin_r = np.isfinite(ours).all(axis=(-2, -1)), np.isfinite(ref).all(axis=(-2, -1))
    np.testing.assert_array_equal(fin_o, fin_r)
    scale = 1.0 + np.abs(ref[fin_r]).max(axis=(-2, -1))
    d = np.abs(ours[fin_o] - ref[fin_r]).max(axis=(-2, -1))
    assert (d <= TRAJ_REL * scale).all(), (d / scale).max()


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_substeps", [1, 4])
@pytest.mark.parametrize("break_on_impact", [True, False], ids=["break", "no_break"])
def test_simulate_trajectory_matches_jax(n_substeps, break_on_impact):
    p = _prior_rows()
    kw = dict(n_steps=physics.n_steps_for(0.5, 0.1), dt=0.1, break_on_impact=break_on_impact,
              n_substeps=n_substeps)
    ref = np.asarray(jphys.simulate_trajectory(*_args(p, jnp.asarray), **kw))
    ours = physics.simulate_trajectory(*_args(p, torch.from_numpy), **kw).numpy()
    _assert_trajectories_close(ours, ref)
    if n_substeps == 1:
        assert not np.isfinite(ref[2]).all()  # the stiff row leaves RK4's stability region
    if break_on_impact:
        assert (ours[4, 1:] == ours[4, 1]).all() and ours[4, 1, 2] == pytest.approx(0.0, abs=1e-6)
    else:
        assert ours[4, -1, 2] < 0


def test_point_of_impact_matches_jax_and_leaves_its_loop_exactly(monkeypatch):
    p = _prior_rows()
    ref = np.asarray(jphys.point_of_impact(*_args(p, jnp.asarray), dt=0.1))
    stats = {}
    ours = physics.point_of_impact(*_args(p, torch.from_numpy), dt=0.1, stats=stats)
    assert stats["steps"] == 1200  # the runaway row never lands
    np.testing.assert_array_equal(ours[3].numpy(), [999.0, 999.0, 999.0])
    np.testing.assert_array_equal(ref[3], [999.0, 999.0, 999.0])
    _assert_trajectories_close(ours.numpy()[:, None], ref[:, None])
    # without the runaway every row lands: the early exit returns the full loop's bits
    landed = {k: np.delete(v, 3, axis=0) for k, v in p.items()}
    early = {}
    out = physics.point_of_impact(*_args(landed, torch.from_numpy), dt=0.1, stats=early)
    monkeypatch.setattr(physics, "IMPACT_CHECK_EVERY", 10**9)
    full = {}
    out_full = physics.point_of_impact(*_args(landed, torch.from_numpy), dt=0.1, stats=full)
    assert early["steps"] < full["steps"] == 1200
    assert torch.equal(out, out_full)


def test_scalar_apis_match_jax():
    row = dict(x0_x=0.0, x0_y=0.0, x0_z=1.5, v0_x=12.0, v0_y=3.0, v0_z=9.0, g_x=0.0, g_y=0.0, g_z=-9.81,
               w_x=-3.0, w_y=2.0, w_z=0.5, b=0.05, m=0.3, rho=1.2, r=0.1, a_x=0.0, a_y=0.0, a_z=0.0)
    vals = [row[k] for k in native.PARAM_LAYOUT]
    ours = physics.physics_ODE_simulation(*vals, T=0.5, dt=0.1, device="cpu")
    ref = jphys.physics_ODE_simulation(*vals, T=0.5, dt=0.1)
    _assert_trajectories_close(ours[None], np.asarray(ref)[None])
    poi = physics.calculate_point_of_impact(*vals, dt=0.1, device="cpu")
    _assert_trajectories_close(poi[None, None], np.asarray(jphys.calculate_point_of_impact(*vals, dt=0.1))[None, None])
    assert poi.shape == (3,) and poi[2] == pytest.approx(0.0, abs=1e-5)


# ---------------------------------------------------------------------------
# priors
# ---------------------------------------------------------------------------

_OUTPUT_KEYS = [
    "x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g_x", "g_y", "g_z", "w_x", "w_y", "w_z", "b", "m",
    "a_x", "a_y", "a_z", "cam_radian_array", "r", "A", "Cd", "rho", "cam_radius", "cam_angles", "cam_heights",
]


@pytest.mark.parametrize("name", ["data_prior"] + PRIOR_FAMILY)
def test_prior_matches_jax_in_distribution(name):
    """Each of `_sample_batch`'s 25 outputs against JAX's by a two-sample KS
    test at n = 20,000 (fixed seeds: deterministic); derived quantities
    exactly."""
    path = PRIOR if name == "data_prior" else os.path.join(REPO, "configs", "data", f"{name}.yaml")
    n = 20_000
    ref = jax.device_get(jpriors.sample_ballistic_parameters(jax.random.key(1), n, jax_load_yaml(path).to_dict()))
    ours = priors.sample_ballistic_parameters(torch.Generator().manual_seed(1), n, load_yaml(path).to_dict())
    assert sorted(ours) == sorted(ref) == sorted(_OUTPUT_KEYS)
    for k in _OUTPUT_KEYS:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, k
        result = ks_2samp(a.ravel(), b.ravel())
        assert result.pvalue > 1e-4, (k, result)
    assert torch.equal(ours["A"], np.pi * ours["r"] ** 2)
    assert torch.equal(ours["b"], ours["rho"] * ours["A"] * ours["Cd"])
    assert (ours["g_x"] == 0).all() and (ours["g_y"] == 0).all() and (ours["g_z"] <= 0).all()


def test_sample_from_config_shapes_and_refuses_malformed_specs():
    g = torch.Generator().manual_seed(0)
    assert priors.sample_from_config(g, {"distribution": "gamma", "shape": 2.0, "scale": 3.0}, (4, 2)).shape == (4, 2)
    from bcnf_tpu_torch.errors import ConfigError

    for spec in ({"distribution": "uniform", "min": 0}, {"distribution": "gamma", "shape": 1},
                 {"distribution": "cauchy"}):
        with pytest.raises(ConfigError):
            priors.sample_from_config(g, spec, (3,))


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("legacy", [False, True], ids=["zip", "legacy"])
def test_cams_position_matches_jax(legacy):
    """The pairing and the heights exactly; x and y within two float32 ulps
    (the packages' cos and sin differ in the last bit)."""
    rng = np.random.default_rng(2)
    rad = rng.uniform(0, 2 * np.pi, size=(7, 2)).astype(np.float32)
    radius = rng.gamma(2.5, 5, size=7).astype(np.float32)
    hgt = rng.uniform(0.4, 1.4, size=(7, 2)).astype(np.float32)
    ref = np.asarray(jcam.get_cams_position(jnp.asarray(rad), jnp.asarray(radius), jnp.asarray(hgt), legacy))
    ours = camera.get_cams_position(torch.from_numpy(rad), torch.from_numpy(radius), torch.from_numpy(hgt), legacy)
    np.testing.assert_array_equal(ours[..., 2].numpy(), ref[..., 2])
    np.testing.assert_allclose(ours[..., :2].numpy(), ref[..., :2], rtol=2.5e-7, atol=0)
    if legacy:  # camera 1 takes (radian[0], radian[1]), camera 2 (height[0], height[1])
        np.testing.assert_array_equal(ours[:, :, 2].numpy(), np.stack([rad[:, 1], hgt[:, 1]], -1))


def _frames(n: int = 6, seed: int = 3):
    """Ball positions in view of cameras on the prior's circle, one out of view."""
    rng = np.random.default_rng(seed)
    rad = rng.uniform(0, 2 * np.pi, size=n).astype(np.float32)
    cams = np.stack([-15 * np.cos(rad), 15 * np.sin(rad), rng.uniform(0.4, 1.4, n)], -1).astype(np.float32)
    ball = (rng.normal(size=(n, 3)) * np.array([3, 3, 1]) + np.array([0, 0, 2])).astype(np.float32)
    ball[-1] = 2 * cams[-1]  # behind the camera (it looks towards the circle's axis)
    angle = rng.gamma(3, 10, size=n).astype(np.float32) * 0.3
    radius = rng.gamma(1.75, 0.05, size=n).astype(np.float32) + 0.05
    return ball, cams, angle, radius


def test_render_frame_analytic_matches_jax():
    """Within 1e-5 of JAX's images (pixel values up to ~0.5): torch's and
    JAX's `linspace` place some bin edges one float32 ulp apart (6e-8 rad),
    which a ball's angular std of ~4e-3 rad turns into ~2e-6 of a pixel's mass."""
    ball, cams, angle, radius = _frames()
    ours = camera.render_frame_analytic(*map(torch.from_numpy, (ball, cams, angle, radius))).numpy()
    for i in range(len(ball)):
        ref = np.asarray(jcam.render_frame_analytic(ball[i], cams[i], angle[i], radius[i]))
        assert ours[i].shape == ref.shape == (90, 160)
        np.testing.assert_allclose(ours[i], ref, atol=1e-5, rtol=0)
    assert ours[:-1].sum(axis=(1, 2)) == pytest.approx(1.0, abs=1e-5)
    assert (ours[-1] == 0).all()


def test_mc_histogram_on_the_same_points_matches_jax():
    """JAX's MC frame and the port's binning of the same 5000 points (the
    noise JAX draws from the frame's key, scaled and shifted by XLA as its
    renderer does). The packages' arctan2 (and arccos, sin, cos in the camera
    basis) differ in the last bit, so a point within that ulp of a bin edge
    may land in the neighbouring bin: at most 5 of 5000 points a frame move,
    and every other count is equal."""
    ball, cams, angle, radius = _frames()
    points = []
    for i in range(len(ball)):
        key = jax.random.key(10 + i)
        points.append(np.asarray(jax.jit(lambda k, b, r: b + r * jcam.RADIUS_TO_STD * jax.random.normal(
            k, (jcam.MC_SAMPLES, 3)))(key, ball[i], radius[i])))
    ours = camera.render_frame_mc_points(torch.from_numpy(np.stack(points)), torch.from_numpy(cams),
                                         torch.from_numpy(angle)).numpy()
    moved = []
    for i in range(len(ball)):
        ref = np.asarray(jcam.render_frame_mc(jax.random.key(10 + i), ball[i], cams[i], angle[i], radius[i]))
        assert ours[i].shape == ref.shape == (90, 160)
        moved.append(np.abs(ours[i] - ref).sum() * jcam.MC_SAMPLES / 2)
    assert max(moved) <= 5 and sum(m == 0 for m in moved) >= len(ball) // 2, moved
    assert (ours[-1] == 0).all() and ours[0].sum() == pytest.approx(1.0, abs=1e-5)


def test_record_trajectory_renders_every_frame_both_ways():
    ball, cams, angle, radius = _frames()
    traj = torch.from_numpy(ball[:4])  # four frames of one trajectory
    cam, ang, r = torch.from_numpy(cams[0]), torch.tensor(angle[0]), torch.tensor(radius[0])
    analytic = camera.record_trajectory(traj, cam, ang, r)
    mc = camera.record_trajectory(traj, cam, ang, r, generator=torch.Generator().manual_seed(0), mode="mc")
    assert analytic.shape == mc.shape == (4, 90, 160)
    # the MC image is a 5000-point estimate of the analytic one
    assert (mc - analytic).abs().sum(dim=(1, 2)).max() < 0.25
    with pytest.raises(ValueError, match="generator"):
        camera.record_trajectory(traj, cam, ang, r, mode="mc")


# ---------------------------------------------------------------------------
# dataset generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("do_filter,renderer", [(False, "mc"), (True, "analytic"), (True, "mc")])
def test_generate_data_gives_exactly_n_rows_in_the_jax_schema(do_filter, renderer):
    kw = dict(config_file=PRIOR, n=11, output_type="trajectories", dt=0.1, T=0.5, seed=0)
    stats = {}
    ours = sampling.generate_data(**kw, do_filter=do_filter, renderer=renderer, batch_size=16, device="cpu",
                                  stats=stats)
    ref = jsampling.generate_data(**kw, do_filter=False, batch_size=16)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert len(ours[k]) == 11, k
        assert np.asarray(ours[k]).shape == np.asarray(ref[k]).shape, k
    assert np.asarray(ours["trajectories"]).dtype == np.float32
    assert np.isfinite(np.asarray(ours["trajectories"])).all()
    cams = np.asarray(ours["cam_radian_array"])
    assert (cams[:, 0] == 0.0).all() and cams.shape == (11, 2)
    if do_filter:
        assert stats["impact_steps"] and max(stats["impact_steps"]) <= 1200
        assert (np.asarray(ours["x0_z"]) >= 0).all()


def test_generate_data_videos_and_observation_noise():
    kw = dict(config_file=PRIOR, n=3, dt=0.1, T=0.3, seed=1, do_filter=False, device="cpu")
    vids = sampling.generate_data(output_type="videos", renderer="analytic", **kw)
    assert np.asarray(vids["videos"]).shape == (3, 2, 3, 90, 160)
    clean = sampling.generate_data(output_type="trajectories", **kw)
    noisy = sampling.generate_data(output_type="trajectories", observation_noise=0.5, **kw)
    x, xn = np.asarray(clean["trajectories"]), np.asarray(noisy["trajectories"])
    np.testing.assert_array_equal(np.asarray(clean["v0_x"]), np.asarray(noisy["v0_x"]))  # same draws
    airborne = x[..., 2] > 0
    assert (xn[~airborne] == x[~airborne]).all()
    assert 0.25 < np.std((xn - x)[airborne]) < 1.0


def test_generate_data_old_matches_jax_on_the_same_seed():
    ours = sampling.generate_data_old(N=8, T=0.5, dt=0.1, seed=4, device="cpu")
    ref = jsampling.generate_data_old(N=8, T=0.5, dt=0.1, seed=4)
    assert sorted(ours) == sorted(ref)
    np.testing.assert_array_equal(ours["v0_x"], ref["v0_x"])  # NumPy's generator draws the parameters
    _assert_trajectories_close(ours["trajectories"], np.asarray(ref["trajectories"]))


# ---------------------------------------------------------------------------
# resimulation
# ---------------------------------------------------------------------------


class _Mapped:
    def __init__(self, mapping):
        self.parameter_index_mapping = mapping


def test_resimulate_given_y_hat_and_impact_points_match_jax():
    names = ["x0_x", "x0_y", "x0_z", "v0_x", "v0_y", "v0_z", "g", "w_x", "w_y", "w_z", "b", "m", "r"]
    spec = jax_load_yaml(PRIOR).to_dict()
    truth = {k: np.array(v) for k, v in jax.device_get(
        jpriors.sample_ballistic_parameters(jax.random.key(5), 4, spec)).items()}
    rng = np.random.default_rng(6)
    base = np.stack([(-truth["g_z"] if k == "g" else truth[k]) for k in names], -1).astype(np.float32)
    y_hat = (base[None] * (1 + 0.05 * rng.normal(size=(6, 4, len(names))))).astype(np.float32)  # (M, N, D)
    data = {k: truth[k] for k in ("rho", "a_x", "a_y", "a_z", "g_x", "x0_x")}
    ref = jresim.resimulate(_Mapped(JaxMapping(names)), None, 0.5, 0.1, data, y_hat)
    ours = resimulation.resimulate(_Mapped(ParameterIndexMapping(names)), None, 0.5, 0.1, data, y_hat, device="cpu")
    assert ours.shape == ref.shape == (4, 6, 5, 3)
    _assert_trajectories_close(ours.reshape(24, 5, 3), np.asarray(ref).reshape(24, 5, 3))
    # learned x0_x overrides the fixed one; g maps to g_z (pointing down)
    np.testing.assert_array_equal(ours[:, :, 0, 0], y_hat[..., 0].T)
    below = ours.copy()
    below[..., 2] -= 1.0  # every trajectory crosses the ground within the window
    np.testing.assert_array_equal(resimulation.impact_points(below), jresim.impact_points(below))
    above = ours.copy()
    above[..., 2] += 100.0  # no trajectory reaches the ground
    assert np.isnan(resimulation.impact_points(above)).all() and np.isnan(jresim.impact_points(above)).all()


# ---------------------------------------------------------------------------
# the native engine
# ---------------------------------------------------------------------------


def test_native_engine_matches_jax_packages_and_is_built_outside_native(tmp_path):
    p = _prior_rows(n=16, seed=7)
    keep = [i for i in range(16) if i not in (1, 2, 3)]  # the RK4-stiff rows and the runaway
    rows = native.params_matrix({k: v[keep] for k, v in p.items()})
    ours = native.simulate_trajectories(rows, 2.0, 0.067, break_on_impact=True, n_threads=2)
    ref = jax_native.simulate_trajectories(rows, 2.0, 0.067, break_on_impact=True, n_threads=2)
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(native.points_of_impact(rows, n_threads=2),
                               jax_native.points_of_impact(rows, n_threads=2), rtol=1e-9, atol=1e-9)
    assert os.path.dirname(native.build_library()) == os.path.join(REPO, "bcnf_tpu_torch", "_build")
    # the adaptive oracle against the port's RK4 with 4 substeps, away from the stiff tail
    rk4 = physics.simulate_trajectory(*_args({k: v[keep] for k, v in p.items()}, torch.from_numpy),
                                      n_steps=physics.n_steps_for(2.0, 0.067), dt=0.067, n_substeps=4).numpy()
    np.testing.assert_allclose(rk4, ours, atol=5e-3)
    with pytest.raises(ValueError, match="19"):
        native.simulate_trajectories(rows[:, :5], 1.0, 0.1)
