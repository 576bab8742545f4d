"""Port parity, calibration: `bcnf_tpu_torch.eval.calibration` and
`bcnf_tpu_torch.plots` against `bcnf_tpu.eval.calibration` and
`bcnf_tpu.plots` on the CPU.

The NumPy functions are copies and must give JAX's results exactly. The
ranks are held against ranks computed from both packages' inverse on the
same fed-in z: a draw within `TIE` of the true value may fall on the other
side of it in the other package, so each rank may differ by at most the
number of such near-ties.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from bcnf_tpu.config import load_config as jax_load_config
from bcnf_tpu.eval import calibration as jcal
from bcnf_tpu.models import CondRealNVP as JaxCondRealNVP
from bcnf_tpu_torch.bridge import params_from_numpy
from bcnf_tpu_torch.config import load_config
from bcnf_tpu_torch.eval import calibration as cal
from bcnf_tpu_torch.models import CondRealNVP

TIE = 1e-4  # the inverse's parity bar (tests/test_flow_kernel.py)


# ---------------------------------------------------------------------------
# the NumPy functions, exactly
# ---------------------------------------------------------------------------


def _ranks(seed: int = 0, n: int = 150, d: int = 4, m: int = 1000) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, m + 1, size=(n, d))


@pytest.mark.parametrize("q", [0.01, 0.3, 0.5, 0.9, 0.99, 0.999])
def test_kolmogorov_quantile_and_sidak_band_match_jax_exactly(q):
    assert cal.kolmogorov_quantile(q) == jcal.kolmogorov_quantile(q)
    for k in (1, 3, 16):
        assert cal.sidak_joint_band(k, q) == jcal.sidak_joint_band(k, q)


@pytest.mark.parametrize("t_divisions,sigma", [(100, 1.0), (37, 0.5)])
def test_cdf_residuals_match_jax_exactly(t_divisions, sigma):
    ranks = _ranks(t_divisions)
    t = np.linspace(0, 1, t_divisions)
    np.testing.assert_array_equal(cal.CDF(ranks, t, 1000), jcal.CDF(ranks, t, 1000))
    np.testing.assert_array_equal(cal.brownian_confidence_interval(t), jcal.brownian_confidence_interval(t))
    for a, b in zip(cal.compute_CDF_residuals(ranks, 1000, t_divisions, sigma),
                    jcal.compute_CDF_residuals(ranks, 1000, t_divisions, sigma)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_bins", [32, 7])
def test_rank_histogram_matches_jax_exactly(n_bins):
    ranks = _ranks(n_bins)
    np.testing.assert_array_equal(cal.rank_histogram(ranks, 1000, n_bins), jcal.rank_histogram(ranks, 1000, n_bins))


# ---------------------------------------------------------------------------
# compute_y_hat_ranks
# ---------------------------------------------------------------------------


def _tiny_run_config(tmp_path) -> str:
    """The flagship's topology (LSTM encoder, affine couplings) at small widths."""
    from bcnf_tpu_torch.config import sub_root_path

    with open(sub_root_path("{{BCNF_ROOT}}/configs/runs/trajectory_LSTM_large.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["kwargs"].update(nested_sizes=[16] * 3, n_conditions=8, n_blocks=3, dropout=0.0)
    cfg["feature_networks"][1]["kwargs"].update(hidden_size=6, output_size=8, dropout=0.0)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


class _FedZ:
    """The port's model with `sample` inverting given z, in the order
    `compute_y_hat_ranks` asks for them: condition batches, then draw chunks."""

    def __init__(self, model, z: np.ndarray, batch_size: int, sample_batch_size: int):
        self.model, self.z = model, z
        M, N = z.shape[:2]
        self.slices = [(slice(d, min(d + sample_batch_size, M)), slice(b, min(b + batch_size, N)))
                       for b in range(0, N, batch_size) for d in range(0, M, sample_batch_size)]

    def sample(self, params, generator, m, *conditions, device=None):
        draws, rows = self.slices.pop(0)
        assert draws.stop - draws.start == m and conditions[0].shape[0] == rows.stop - rows.start
        h = self.model.encode(params, conditions)
        return self.model.inverse_given_h(params, torch.from_numpy(self.z[draws, rows]), h)


def test_ranks_match_both_packages_inverse_on_the_same_z(tmp_path):
    path = _tiny_run_config(tmp_path)
    jm = JaxCondRealNVP.from_config(jax_load_config(path, verify=False))
    tm = CondRealNVP.from_config(load_config(path, verify=False))
    jp = jax.tree.map(np.asarray, jax.device_get(jm.init(jax.random.key(3))))
    rng = np.random.default_rng(4)
    N, M = 30, 200
    traj = rng.normal(size=(N, 30, 3)).astype(np.float32)
    z = rng.normal(size=(M, N, 19)).astype(np.float32)
    jpj = jax.tree.map(jnp.asarray, jp)
    y_hat_jax = np.asarray(jm.inverse_given_h(jpj, jnp.asarray(z), jm.encode(jpj, (jnp.asarray(traj),))))
    # true values among the draws, so that every rank is away from 0 and M
    y = y_hat_jax[rng.integers(0, M, size=N), np.arange(N)] + 0.05 * rng.normal(size=(N, 19)).astype(np.float32)

    fed = _FedZ(tm, z, batch_size=16, sample_batch_size=64)
    ours = cal.compute_y_hat_ranks(fed, params_from_numpy(jp, "cpu"), y, traj, M_samples=M,
                                   sample_batch_size=64, batch_size=16, device="cpu")
    assert not fed.slices and ours.shape == (N, 19) and ours.dtype == np.int64
    ref = (y_hat_jax < y[None]).sum(axis=0)
    ties = (np.abs(y_hat_jax - y[None]) < TIE).sum(axis=0)
    assert (np.abs(ours - ref) <= ties).all()
    assert 0 < ours.mean() < M and (ours != ref).sum() <= ties.sum()


def test_ranks_of_the_exact_posterior_are_uniform():
    """`tests/test_eval.py`'s check: with the true posterior of a conjugate
    Gaussian toy problem as the sampler, the scaled CDF residuals stay
    within the Brownian band."""
    rng = np.random.default_rng(3)
    N, D = 400, 3
    s = 0.7
    theta = rng.normal(size=(N, D)).astype(np.float32)
    x = theta + s * rng.normal(size=(N, D)).astype(np.float32)
    post_std = np.sqrt(s**2 / (1 + s**2))

    class _TruePosterior:
        def sample(self, params, generator, m, cond, device=None):
            noise = torch.randn((m, cond.shape[0], D), generator=generator, device=generator.device)
            return (cond / (1 + s**2))[None] + post_std * noise

    ranks = cal.compute_y_hat_ranks(_TruePosterior(), None, theta, x, M_samples=2000,
                                    generator=torch.Generator().manual_seed(0), device="cpu")
    _, resid, _ = cal.compute_CDF_residuals(ranks, 2000)
    assert np.abs(resid).max() < 2.2, np.abs(resid).max(axis=1)


def test_ranks_without_device_raise_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("checks the device rule of a host without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cal.compute_y_hat_ranks(None, None, np.zeros((2, 3), np.float32), np.zeros((2, 3), np.float32))


# ---------------------------------------------------------------------------
# the eval figures
# ---------------------------------------------------------------------------


def test_eval_plots_draw_and_the_package_imports_without_matplotlib():
    from bcnf_tpu_torch.plots import plot_cdf_residuals, plot_impact_heatmap, plot_rank_histograms, plot_resimulation

    rng = np.random.default_rng(0)
    ranks = rng.integers(0, 101, size=(200, 7))
    assert len(plot_rank_histograms(ranks, 100).axes) == 10  # 7 histograms, 3 blank panels
    t, resid, _ = cal.compute_CDF_residuals(ranks, 100)
    assert plot_cdf_residuals(t, resid, [f"p{i}" for i in range(7)]) is not None
    poi = rng.normal(size=(2, 50, 3))
    assert plot_impact_heatmap(poi, poi[:, 0], index=1) is not None
    X = rng.normal(size=(2, 5, 6, 3))
    assert plot_resimulation(X[:, 0], X) is not None
    code = ("import sys, bcnf_tpu_torch.plots, bcnf_tpu_torch.eval\n"
            "assert not [m for m in sys.modules if m.startswith('matplotlib')]\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
