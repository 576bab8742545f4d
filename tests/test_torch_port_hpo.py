"""Port parity, the `hpo` path: k-fold cross-validation and the checkpointable
GP minimizer, held against the JAX package (`bcnf_tpu/eval/crossvalidate.py`,
`bcnf_tpu/hpo/gp_minimize.py`) on the same inputs.

The port's GP surrogate is sklearn's `GaussianProcessRegressor` rewritten in
NumPy and SciPy (the card's machine has no sklearn): here it is held against
sklearn itself, its predictions within 1e-8 at fixed hyperparameters and its
fitted log-marginal likelihood no worse than sklearn's less 1e-3. The
minimizer's random initial points, its checkpoints and a resume from a
checkpoint the JAX package wrote are held against JAX's `gp_minimize_fixed`;
JAX's own four `tests/test_hpo.py` checks are repeated on the port.
"""

import pickle
import shutil
import warnings

import numpy as np
import pytest

from bcnf_tpu.eval import crossvalidate as jax_cv
from bcnf_tpu.hpo import gp_minimize as jax_gp
from bcnf_tpu_torch.eval import crossvalidate
from bcnf_tpu_torch.eval.crossvalidate import cross_validate, kfold_indices
from bcnf_tpu_torch.errors import TrainingDivergedError
from bcnf_tpu_torch.hpo import Categorical, GaussianProcess, Integer, Real, gp_minimize_fixed, load_checkpoint
from bcnf_tpu_torch.models import CondRealNVP, ConcatenateCondition, FeatureNetworkStack, LSTMFeatureNetwork

PREDICT_ATOL = 1e-8  # the numpy GP against sklearn's at fixed hyperparameters
LML_SLACK = 1e-3  # the fitted log-marginal likelihood may fall short of sklearn's by at most this


@pytest.mark.parametrize("n,n_splits,shuffle,seed", [(10, 3, False, None), (11, 4, True, 0), (64, 2, True, 3),
                                                     (7, 7, False, None)])
def test_kfold_indices_match_jax(n, n_splits, shuffle, seed):
    ours = list(kfold_indices(n, n_splits, shuffle, seed))
    ref = list(jax_cv.kfold_indices(n, n_splits, shuffle, seed))
    assert len(ours) == len(ref) == n_splits
    for (tr, va), (tr_r, va_r) in zip(ours, ref):
        np.testing.assert_array_equal(tr, tr_r)
        np.testing.assert_array_equal(va, va_r)
    assert sorted(np.concatenate([va for _, va in ours]).tolist()) == list(range(n))


def _factory():
    stack = FeatureNetworkStack([ConcatenateCondition(input_size=None, output_size=3),
                                 LSTMFeatureNetwork(input_size=3, hidden_size=8, output_size=6, num_layers=1,
                                                    bidirectional=True, pooling="mean")])
    return CondRealNVP(size=4, nested_sizes=[8, 8], n_blocks=3, n_conditions=6, feature_network_stack=stack,
                       act_norm=True, random_state=0)


def _data(n=24):
    rng = np.random.default_rng(0)
    return rng.normal(size=(n, 4)).astype(np.float32), [rng.normal(size=(n, 5, 3)).astype(np.float32)]


def test_cross_validate_records_match_jax_and_each_fold_is_seeded_by_its_index(monkeypatch):
    """With training stood in by a recorder in both packages, the per-fold
    records are JAX's (keys and values); each fold gets a fresh model,
    parameters from a generator seeded with the fold's index (JAX:
    `jax.random.key(i)`), the fold's rows, `seed=i` and the device."""
    y, conds = _data(10)
    calls = []

    def fake(package):
        def train(model, params, y_tr, c_tr, y_va, c_va, **kw):
            calls.append((package, kw["seed"], len(y_tr), len(y_va), kw.get("device")))
            s = kw["seed"]
            return params, {"train": [1.0 + s, 0.5 + s], "val": [2.0 + s], "stop_reason": "max_epochs"}
        return train

    monkeypatch.setattr(crossvalidate, "train_CondRealNVP", fake("port"))
    monkeypatch.setattr(jax_cv, "train_CondRealNVP", fake("jax"))
    inits = []
    init = CondRealNVP.init
    monkeypatch.setattr(CondRealNVP, "init", lambda self, g=None, device=None: inits.append(g.initial_seed())
                        or init(self, g, device=device))
    ours = cross_validate(_factory, y, conds, n_splits=3, device="cpu")
    ref = jax_cv.cross_validate(lambda: _JaxStub(), y, conds, n_splits=3)
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref] == [["loss_history", "train_loss", "val_loss"]] * 3
    for a, b in zip(ours, ref):
        assert a["train_loss"] == b["train_loss"] and a["val_loss"] == b["val_loss"]
        assert a["loss_history"] == b["loss_history"]
    assert inits == [0, 1, 2]
    assert [c[1:4] for c in calls if c[0] == "port"] == [c[1:4] for c in calls if c[0] == "jax"]
    assert {c[4] for c in calls if c[0] == "port"} == {"cpu"}


class _JaxStub:
    """A JAX-side model whose init takes a key: the recorder trains nothing."""

    def init(self, key):
        return {}


def test_cross_validate_errors_rule_on_a_diverging_fold(monkeypatch):
    """A fold whose training diverges is left out with errors="return" and
    raises with errors="raise" (the default), as in JAX."""
    y, conds = _data(12)
    real = crossvalidate.train_CondRealNVP

    def diverging_fold_1(*a, **kw):
        if kw["seed"] == 1:
            raise TrainingDivergedError("Loss exploded to inf at epoch 11")
        return real(*a, **kw)

    monkeypatch.setattr(crossvalidate, "train_CondRealNVP", diverging_fold_1)
    folds = cross_validate(_factory, y, conds, n_splits=3, n_epochs=1, batch_size=4, errors="return", device="cpu")
    assert len(folds) == 2 and all(np.isfinite(f["val_loss"]) and np.isfinite(f["train_loss"]) for f in folds)
    with pytest.raises(TrainingDivergedError):
        cross_validate(_factory, y, conds, n_splits=3, n_epochs=1, batch_size=4, device="cpu")


def test_cross_validate_trains_each_fold_on_the_cpu():
    """Two real folds of one epoch: finite losses, one val loss an epoch."""
    y, conds = _data(16)
    folds = cross_validate(_factory, y, conds, n_splits=2, n_epochs=2, batch_size=4, device="cpu")
    assert len(folds) == 2
    for f in folds:
        assert len(f["loss_history"]["val"]) == 2 and np.isfinite(f["val_loss"]) and np.isfinite(f["train_loss"])


# ---------------------------------------------------------------------------
# the GP surrogate against sklearn's regressor
# ---------------------------------------------------------------------------


def _sklearn_gp(dims: int, optimize: bool, seed: int):
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern, WhiteKernel

    kernel = ConstantKernel(1.0) * Matern(length_scale=np.full(dims, 0.3), nu=2.5) + WhiteKernel(1e-6)
    if optimize:
        return GaussianProcessRegressor(kernel=kernel, normalize_y=True, n_restarts_optimizer=2, random_state=seed)
    return GaussianProcessRegressor(kernel=kernel, normalize_y=True, optimizer=None)


def _gp_data(seed: int, n: int, dims: int):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, dims))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.normal(size=n) + 5.0
    return X, y, rng.uniform(size=(200, dims))


@pytest.mark.parametrize("seed,n,dims", [(0, 12, 6), (1, 9, 3), (2, 25, 6), (3, 5, 1)])
def test_gp_predictions_match_sklearn_at_fixed_hyperparameters(seed, n, dims):
    X, y, cand = _gp_data(seed, n, dims)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = _sklearn_gp(dims, False, seed).fit(X, y)
    ours = GaussianProcess(np.full(dims, 0.3), optimize=False).fit(X, y)
    mu, sd = ours.predict(cand, return_std=True)
    mu_r, sd_r = sk.predict(cand, return_std=True)
    np.testing.assert_allclose(mu, mu_r, atol=PREDICT_ATOL, rtol=0)
    np.testing.assert_allclose(sd, sd_r, atol=PREDICT_ATOL, rtol=0)
    np.testing.assert_allclose(ours.predict(cand), mu_r, atol=PREDICT_ATOL, rtol=0)
    assert ours.log_marginal_likelihood_value_ == pytest.approx(sk.log_marginal_likelihood_value_, abs=1e-8)


@pytest.mark.parametrize("seed,n,dims", [(0, 12, 6), (1, 9, 3), (2, 25, 6), (4, 16, 2)])
def test_gp_fit_is_no_worse_than_sklearn(seed, n, dims):
    """L-BFGS-B over the log-hyperparameters from the initial point and two
    log-uniform restarts: the fitted log-marginal likelihood at least
    sklearn's less 1e-3, and sklearn's own value at the port's optimum."""
    X, y, _ = _gp_data(seed, n, dims)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = _sklearn_gp(dims, True, seed).fit(X, y)
        ours = GaussianProcess(np.full(dims, 0.3), random_state=seed).fit(X, y)
        assert ours.log_marginal_likelihood_value_ >= sk.log_marginal_likelihood_value_ - LML_SLACK
        assert sk.log_marginal_likelihood(ours.theta) == pytest.approx(ours.log_marginal_likelihood_value_, abs=1e-8)
        lml, grad = ours.log_marginal_likelihood(ours.theta + 0.1, eval_gradient=True)
        lml_r, grad_r = sk.log_marginal_likelihood(ours.theta + 0.1, eval_gradient=True)
    assert lml == pytest.approx(lml_r, abs=1e-8)
    np.testing.assert_allclose(grad, grad_r, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# the minimizer against JAX's, and JAX's own checks
# ---------------------------------------------------------------------------


def _quadratic(x):
    # minimum at (0.3, 5, 'b')
    return (x[0] - 0.3) ** 2 + 0.01 * (x[1] - 5) ** 2 + (0.0 if x[2] == "b" else 0.5)


SPACE = [Real(0.0, 1.0), Integer(0, 10), Categorical(["a", "b", "c"])]
JAX_SPACE = [jax_gp.Real(0.0, 1.0), jax_gp.Integer(0, 10), jax_gp.Categorical(["a", "b", "c"])]
HPO_SPACE = [Integer(6, 32), Integer(16, 256), Integer(2, 6), Integer(32, 256), Real(1e-4, 3e-3, prior="log-uniform"),
             Real(0.0, 0.5)]
JAX_HPO_SPACE = [jax_gp.Integer(6, 32), jax_gp.Integer(16, 256), jax_gp.Integer(2, 6), jax_gp.Integer(32, 256),
                 jax_gp.Real(1e-4, 3e-3, prior="log-uniform"), jax_gp.Real(0.0, 0.5)]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_initial_points_and_checkpoints_match_jax(seed, tmp_path):
    """The first `n_initial_points` (the `hpo` driver's search space) and the
    checkpoint after them are JAX's for the same seed."""
    f = lambda x: float(x[0] + x[4] * 1e3)  # noqa: E731
    ours = gp_minimize_fixed(f, HPO_SPACE, n_calls=5, n_initial_points=5, random_state=seed,
                             checkpoint_file=str(tmp_path / "ours.pkl"))
    ref = jax_gp.gp_minimize_fixed(f, JAX_HPO_SPACE, n_calls=5, n_initial_points=5, random_state=seed,
                                   checkpoint_file=str(tmp_path / "ref.pkl"))
    assert ours.x_iters == ref.x_iters and ours.func_vals == ref.func_vals
    assert load_checkpoint(str(tmp_path / "ours.pkl")) == jax_gp.load_checkpoint(str(tmp_path / "ref.pkl"))


def test_resume_from_a_checkpoint_jax_wrote(tmp_path):
    """A checkpoint of JAX's minimizer (plain lists and an int) resumes in the
    port, which then picks the same GP points JAX picks from it."""
    jax_ckpt, ours_ckpt = str(tmp_path / "jax.pkl"), str(tmp_path / "ours.pkl")
    jax_gp.gp_minimize_fixed(_quadratic, JAX_SPACE, n_calls=6, n_initial_points=4, checkpoint_file=jax_ckpt,
                             random_state=1)
    shutil.copy(jax_ckpt, ours_ckpt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_gp.gp_minimize_fixed(_quadratic, JAX_SPACE, n_calls=9, n_initial_points=4,
                                       checkpoint_file=jax_ckpt, random_state=1)
    ours = gp_minimize_fixed(_quadratic, SPACE, n_calls=9, n_initial_points=4, checkpoint_file=ours_ckpt,
                             random_state=1)
    assert ours.x_iters[:6] == ref.x_iters[:6] and len(ours.func_vals) == 9
    for a, b in zip(ours.x_iters[6:], ref.x_iters[6:]):
        assert a[1:] == b[1:] and a[0] == pytest.approx(b[0], abs=1e-9)
    np.testing.assert_allclose(ours.func_vals, ref.func_vals, atol=1e-9, rtol=0)


def test_gp_minimize_finds_minimum():
    res = gp_minimize_fixed(_quadratic, SPACE, n_calls=25, n_initial_points=8, random_state=0)
    assert res.fun < 0.05
    assert abs(res.x[0] - 0.3) < 0.25
    assert len(res.x_iters) == 25 and len(res.func_vals) == 25


def test_gp_minimize_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "hpo.pkl")
    res1 = gp_minimize_fixed(_quadratic, SPACE, n_calls=6, n_initial_points=4, checkpoint_file=ckpt, random_state=1)
    state = load_checkpoint(ckpt)
    assert len(state["func_vals"]) == 6
    # resume continues exactly where it left off
    res2 = gp_minimize_fixed(_quadratic, SPACE, n_calls=10, n_initial_points=4, checkpoint_file=ckpt, random_state=1)
    assert len(res2.func_vals) == 10
    assert res2.func_vals[:6] == res1.func_vals


def test_dimension_roundtrips():
    r = Real(1e-5, 1e-1, prior="log-uniform")
    assert abs(r.to_unit(r.from_unit(0.37)) - 0.37) < 1e-9
    i = Integer(2, 20)
    assert i.from_unit(i.to_unit(7)) == 7
    c = Categorical(["x", "y", "z"])
    assert c.from_unit(c.to_unit("y")) == "y"


def test_gp_handles_nan_objective():
    calls = []

    def f(x):
        calls.append(x)
        return float("nan") if x[1] < 2 else (x[0] - 0.5) ** 2

    res = gp_minimize_fixed(f, SPACE, n_calls=15, n_initial_points=6, random_state=2)
    assert np.isfinite(res.fun)


def test_hpo_driver_rejects_unknown_space_dimensions(tmp_path):
    from bcnf_tpu_torch.hpo.driver import run_hpo

    y, conds = _data(8)
    data = tmp_path / "d.pkl"
    with open(data, "wb") as fh:
        pickle.dump({"trajectories": list(conds[0]), **{k: list(np.zeros(8, np.float32)) for k in
                                                       ("x0_x", "x0_y", "x0_z")}}, fh)
    with pytest.raises(ValueError, match="unknown space dimensions"):
        run_hpo(str(data), str(tmp_path / "out"), n_calls=1, n_initial_points=1, n_splits=2, n_epochs=1,
                n_samples=8, parameter_names=["x0_x", "x0_y", "x0_z"], space_bounds={"bogus": (0, 1)},
                device="cpu")
