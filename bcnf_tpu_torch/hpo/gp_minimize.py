"""Checkpointable Bayesian (GP) hyperparameter optimization (port of
`bcnf_tpu/hpo/gp_minimize.py`; reference `src/bcnf/gp_minimize/gp_minimize.py:21-194`).

The search space (`Real`, `Integer`, `Categorical`), the expected-improvement
acquisition maximised over random candidates, the checkpoint format (a
pickle of plain lists and an int, so a checkpoint the JAX package wrote
resumes here) and the resume loop are the JAX package's. Its surrogate is
sklearn's `GaussianProcessRegressor`, which the card's machine does not
have: `GaussianProcess` is the same model in NumPy and SciPy,
``ConstantKernel(1.0) * Matern(nu=2.5, one length scale a dimension, 0.3) +
WhiteKernel(1e-6)`` with `normalize_y`, its log-marginal likelihood
maximised over the log-hyperparameters by L-BFGS-B inside sklearn's default
bounds (1e-5, 1e5), from the initial point and from restarts drawn
log-uniformly from `numpy.random.RandomState(random_state)`, as sklearn
draws them.
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Search-space dimensions
# ---------------------------------------------------------------------------


@dataclass
class Real:
    low: float
    high: float
    prior: str = "uniform"  # or "log-uniform"
    name: str | None = None

    def to_unit(self, x: float) -> float:
        if self.prior == "log-uniform":
            return (np.log(x) - np.log(self.low)) / (np.log(self.high) - np.log(self.low))
        return (x - self.low) / (self.high - self.low)

    def from_unit(self, u: float) -> float:
        u = float(np.clip(u, 0.0, 1.0))
        if self.prior == "log-uniform":
            return float(np.exp(np.log(self.low) + u * (np.log(self.high) - np.log(self.low))))
        return float(self.low + u * (self.high - self.low))

    def sample(self, rng: np.random.Generator) -> float:
        return self.from_unit(rng.uniform())


@dataclass
class Integer:
    low: int
    high: int
    name: str | None = None

    def to_unit(self, x: int) -> float:
        return (x - self.low) / max(self.high - self.low, 1)

    def from_unit(self, u: float) -> int:
        return int(round(self.low + float(np.clip(u, 0, 1)) * (self.high - self.low)))

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.low, self.high + 1))


@dataclass
class Categorical:
    categories: Sequence[Any]
    name: str | None = None

    def to_unit(self, x: Any) -> float:
        return list(self.categories).index(x) / max(len(self.categories) - 1, 1)

    def from_unit(self, u: float) -> Any:
        idx = int(round(float(np.clip(u, 0, 1)) * (len(self.categories) - 1)))
        return list(self.categories)[idx]

    def sample(self, rng: np.random.Generator) -> Any:
        return list(self.categories)[rng.integers(len(self.categories))]


Dimension = Real | Integer | Categorical


@dataclass
class OptimizeResult:
    """Result container (skopt-compatible attribute surface)."""

    x: list
    fun: float
    x_iters: list[list] = field(default_factory=list)
    func_vals: list[float] = field(default_factory=list)


# ---------------------------------------------------------------------------
# The surrogate: sklearn's regressor in NumPy and SciPy
# ---------------------------------------------------------------------------

LOG_BOUNDS = (math.log(1e-5), math.log(1e5))  # sklearn's default bounds of every hyperparameter
JITTER = 1e-10  # sklearn's `alpha`, added to the training covariance's diagonal


class GaussianProcess:
    """sklearn's `GaussianProcessRegressor(kernel=ConstantKernel(1.0) *
    Matern(length_scale, nu=2.5) + WhiteKernel(1e-6), normalize_y=True,
    n_restarts_optimizer=n_restarts, random_state=random_state)`.

    `theta` holds the log-hyperparameters in sklearn's order: the constant,
    the length scales, the noise level. `optimize=False` keeps them as given
    (sklearn's ``optimizer=None``)."""

    def __init__(self, length_scale: Sequence[float], n_restarts: int = 2, random_state: int | None = 0,
                 optimize: bool = True) -> None:
        self.theta = np.log(np.concatenate([[1.0], np.asarray(length_scale, dtype=float), [1e-6]]))
        self.n_restarts = n_restarts
        self.random_state = random_state
        self.optimize = optimize

    @staticmethod
    def _kernel(theta: np.ndarray, X: np.ndarray, Y: np.ndarray | None = None,
                eval_gradient: bool = False) -> tuple[np.ndarray, np.ndarray | None]:
        """k(X, Y) (Y None: X's own covariance, the white noise on its
        diagonal) and, with `eval_gradient`, its gradient along the last
        axis by each log-hyperparameter."""
        c, ls, noise = np.exp(theta[0]), np.exp(theta[1:-1]), np.exp(theta[-1])
        Xs = X / ls
        Ys = Xs if Y is None else Y / ls
        sq = np.sum((Xs[:, None, :] - Ys[None, :, :]) ** 2, axis=-1)
        r = math.sqrt(5.0) * np.sqrt(sq)
        matern = (1.0 + r + r**2 / 3.0) * np.exp(-r)
        K = c * matern
        if Y is None:
            K = K + noise * np.eye(X.shape[0])
        if not eval_gradient:
            return K, None
        D = (Xs[:, None, :] - Xs[None, :, :]) ** 2  # per-dimension scaled squared distances
        t = np.sqrt(5.0 * D.sum(-1))[..., None]
        dmatern = 5.0 / 3.0 * D * (t + 1.0) * np.exp(-t)  # by each log length scale
        grad = np.concatenate([K[..., None] - noise * np.eye(X.shape[0])[..., None],  # by log c: c * matern
                               c * dmatern,
                               noise * np.eye(X.shape[0])[..., None]], axis=-1)
        return K, grad

    def log_marginal_likelihood(self, theta: np.ndarray, eval_gradient: bool = False) -> Any:
        """The normalised training targets' log-marginal likelihood at
        `theta` (and its gradient), as sklearn computes it: -inf where the
        covariance is not positive definite."""
        from scipy.linalg import cho_solve, cholesky

        K, K_grad = self._kernel(theta, self.X_train_, eval_gradient=eval_gradient)
        K[np.diag_indices_from(K)] += JITTER
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return (-np.inf, np.zeros_like(theta)) if eval_gradient else -np.inf
        y = self.y_train_[:, None]
        alpha = cho_solve((L, True), y, check_finite=False)
        lml = float(-0.5 * np.einsum("ik,ik->k", y, alpha).sum() - np.log(np.diag(L)).sum()
                    - K.shape[0] / 2 * np.log(2 * np.pi))
        if not eval_gradient:
            return lml
        inner = np.einsum("ik,jk->ijk", alpha, alpha) - cho_solve((L, True), np.eye(K.shape[0]),
                                                                   check_finite=False)[..., None]
        return lml, 0.5 * np.einsum("ijl,jik->kl", inner, K_grad).sum(-1)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        from scipy.linalg import cho_solve, cholesky
        from scipy.optimize import minimize

        self.X_train_ = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        self.y_mean_ = float(np.mean(y))
        std = float(np.std(y))
        self.y_std_ = std if std != 0.0 else 1.0  # sklearn's `_handle_zeros_in_scale`
        self.y_train_ = (y - self.y_mean_) / self.y_std_

        if self.optimize:
            def neg(theta: np.ndarray) -> tuple[float, np.ndarray]:
                lml, grad = self.log_marginal_likelihood(theta, eval_gradient=True)
                return -lml, -grad

            bounds = np.tile(LOG_BOUNDS, (self.theta.size, 1))
            starts = [self.theta]
            rng = np.random.RandomState(self.random_state)
            starts += [rng.uniform(bounds[:, 0], bounds[:, 1]) for _ in range(self.n_restarts)]
            optima = [minimize(neg, x0, method="L-BFGS-B", jac=True, bounds=bounds) for x0 in starts]
            best = min(optima, key=lambda o: o.fun)
            self.theta = best.x
        self.log_marginal_likelihood_value_ = self.log_marginal_likelihood(self.theta)

        K, _ = self._kernel(self.theta, self.X_train_)
        K[np.diag_indices_from(K)] += JITTER
        self.L_ = cholesky(K, lower=True, check_finite=False)
        self.alpha_ = cho_solve((self.L_, True), self.y_train_, check_finite=False)
        return self

    def predict(self, X: np.ndarray, return_std: bool = False) -> Any:
        """The predictive mean (and standard deviation) at `X`, in the
        targets' units; the white noise counts in the variance, as in sklearn."""
        from scipy.linalg import solve_triangular

        X = np.asarray(X, dtype=float)
        K_trans, _ = self._kernel(self.theta, X, self.X_train_)
        mean = self.y_std_ * (K_trans @ self.alpha_) + self.y_mean_
        if not return_std:
            return mean
        V = solve_triangular(self.L_, K_trans.T, lower=True, check_finite=False)
        var = np.exp(self.theta[0]) + np.exp(self.theta[-1]) - np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        return mean, np.sqrt(var * self.y_std_**2)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------


def _to_unit(dimensions: Sequence[Dimension], x: Sequence[Any]) -> np.ndarray:
    return np.array([d.to_unit(v) for d, v in zip(dimensions, x)], dtype=float)


def _from_unit(dimensions: Sequence[Dimension], u: np.ndarray) -> list:
    return [d.from_unit(v) for d, v in zip(dimensions, u)]


def _expected_improvement(mu: np.ndarray, sigma: np.ndarray, best: float, xi: float = 0.01) -> np.ndarray:
    from scipy.stats import norm

    sigma = np.maximum(sigma, 1e-12)
    imp = best - mu - xi
    z = imp / sigma
    return imp * norm.cdf(z) + sigma * norm.pdf(z)


def _fit_gp(X: np.ndarray, y: np.ndarray, random_state: int) -> GaussianProcess:
    return GaussianProcess(np.full(X.shape[1], 0.3), n_restarts=2, random_state=random_state).fit(X, y)


def save_checkpoint(checkpoint_file: str, state: dict) -> None:
    """Atomic checkpoint of the optimizer state (reference
    `gp_minimize/gp_minimize.py:173-194` pickles minus unpicklables)."""
    os.makedirs(os.path.dirname(os.path.abspath(checkpoint_file)), exist_ok=True)
    tmp = checkpoint_file + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, checkpoint_file)


def load_checkpoint(checkpoint_file: str) -> dict | None:
    if not os.path.exists(checkpoint_file):
        return None
    with open(checkpoint_file, "rb") as f:
        return pickle.load(f)


def gp_minimize_fixed(
    func: Callable[[list], float],
    dimensions: Sequence[Dimension],
    n_calls: int = 50,
    n_initial_points: int = 10,
    checkpoint_file: str | None = None,
    random_state: int = 0,
    x0: list[list] | None = None,
    y0: list[float] | None = None,
    n_candidates: int = 5000,
    verbose: bool = False,
) -> OptimizeResult:
    """Minimize `func` over the search space; checkpoint every iteration and
    resume automatically from `checkpoint_file` (reference
    `gp_minimize_fixed` / `base_minimize_fixed`,
    `src/bcnf/gp_minimize/gp_minimize.py:21-171`)."""
    rng = np.random.default_rng(random_state)
    x_iters: list[list] = list(x0 or [])
    func_vals: list[float] = list(y0 or [])

    state = load_checkpoint(checkpoint_file) if checkpoint_file else None
    if state is not None:
        x_iters = state["x_iters"]
        func_vals = state["func_vals"]
        rng = np.random.default_rng(state.get("rng_seed", random_state))
        if verbose:
            print(f"Resumed HPO from {checkpoint_file} with {len(x_iters)} evaluations")

    while len(func_vals) < n_calls:
        i = len(func_vals)
        if i < n_initial_points or len(x_iters) < 2:
            x_next = [d.sample(rng) for d in dimensions]
        else:
            X = np.stack([_to_unit(dimensions, x) for x in x_iters])
            y = np.asarray(func_vals, dtype=float)
            finite = np.isfinite(y)
            penalty = y[finite].max() if finite.any() else 0.0
            y = np.where(finite, y, penalty)
            gp = _fit_gp(X, y, random_state)
            cand = rng.uniform(size=(n_candidates, len(dimensions)))
            mu, sigma = gp.predict(cand, return_std=True)
            ei = _expected_improvement(mu, sigma, y.min())
            x_next = _from_unit(dimensions, cand[int(np.argmax(ei))])

        val = float(func(x_next))
        x_iters.append(list(x_next))
        func_vals.append(val)
        if verbose:
            print(f"[HPO {i + 1}/{n_calls}] f({x_next}) = {val:.4f} (best {min(func_vals):.4f})")

        if checkpoint_file:
            save_checkpoint(
                checkpoint_file,
                {"x_iters": x_iters, "func_vals": func_vals, "rng_seed": int(rng.integers(2**31))},
            )
            rng = np.random.default_rng(load_checkpoint(checkpoint_file)["rng_seed"])

    vals = np.asarray(func_vals, dtype=float)
    vals = np.where(np.isfinite(vals), vals, np.inf)  # diverged points never win
    best = int(np.argmin(vals))
    return OptimizeResult(x=x_iters[best], fun=float(vals[best]), x_iters=x_iters, func_vals=func_vals)
