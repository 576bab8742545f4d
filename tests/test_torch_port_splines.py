"""Port parity, splines: `bcnf_tpu_torch/models/splines.py` against
`bcnf_tpu/models/splines.py` on the same inputs and raw parameters, both
ways, inside and outside the tails: outputs at the flow bar 1e-4, logdets at
2e-3 (tests/test_cnf.py:107's bar for the spline's logdet, whose float32
derivative products carry ~1e-4-scale error); the forward's logdet against
autograd at 2e-3; the inverse after the forward at the round-trip bar 5e-4.

The raw parameters are drawn with std 2, which makes very uneven bins (a
bin may be 1e-3 of the range): float32 then moves theta by up to ~1e-4 in
either package. Round trips on such bins miss 5e-4 in JAX too (0.018 on the
case below): there the port is held to JAX's own round-trip error; at std 1
to 5e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcnf_tpu.models import splines as jax_splines
from bcnf_tpu_torch.models import splines

TOL, ROUNDTRIP_TOL, LOGDET_TOL = 1e-4, 5e-4, 2e-3


def _case(num_bins: int, tail_bound: float, seed: int, n: int = 400, spread: float = 1.0, raw_std: float = 2.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, 3)) * tail_bound * spread).astype(np.float32)
    raw = (raw_std * rng.normal(size=(n, 3, 3 * num_bins - 1))).astype(np.float32)
    return x, raw[..., :num_bins], raw[..., num_bins: 2 * num_bins], raw[..., 2 * num_bins:]


def _both(args, inverse, tail_bound):
    ref = jax_splines.rational_quadratic_spline(*(jnp.asarray(a) for a in args), inverse=inverse,
                                                tail_bound=tail_bound)
    ours = splines.rational_quadratic_spline(*(torch.from_numpy(a) for a in args), inverse=inverse,
                                             tail_bound=tail_bound)
    return [np.asarray(r) for r in ref], [o.numpy() for o in ours]


def test_spline_constants_match_jax():
    assert splines.n_spline_params(8) == jax_splines.n_spline_params(8) == 23
    for name in ("DEFAULT_MIN_BIN_WIDTH", "DEFAULT_MIN_BIN_HEIGHT", "DEFAULT_MIN_DERIVATIVE"):
        assert getattr(splines, name) == getattr(jax_splines, name) == 1e-3


@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
@pytest.mark.parametrize("num_bins,tail_bound", [(8, 3.0), (4, 1.5)])
def test_spline_matches_jax_inside_and_outside_the_tails(inverse, num_bins, tail_bound):
    args = _case(num_bins, tail_bound, seed=num_bins, spread=0.8)
    x = args[0]
    outside = np.abs(x) > tail_bound
    assert outside.sum() > 20 and (~outside).sum() > 600  # both regions are held
    (ref_y, ref_ld), (y, ld) = _both(args, inverse, tail_bound)
    np.testing.assert_allclose(y, ref_y, atol=TOL, rtol=0)
    np.testing.assert_allclose(ld, ref_ld, atol=LOGDET_TOL, rtol=0)
    # identity tails, logdet 0 there
    np.testing.assert_array_equal(y[outside], x[outside])
    np.testing.assert_array_equal(ld[outside], 0.0)


@pytest.mark.parametrize("raw_std", [1.0, 2.0])
@pytest.mark.parametrize("num_bins,tail_bound", [(8, 3.0), (4, 1.5)])
def test_spline_inverse_undoes_the_forward(num_bins, tail_bound, raw_std):
    args = _case(num_bins, tail_bound, seed=num_bins, spread=0.8, raw_std=raw_std)
    fwd = [torch.from_numpy(a) for a in args]
    y, ld = splines.rational_quadratic_spline(*fwd, tail_bound=tail_bound)
    x_back, ld_inv = splines.rational_quadratic_spline(y, *fwd[1:], inverse=True, tail_bound=tail_bound)
    err = np.abs(x_back.numpy() - args[0]).max()
    jy, _ = jax_splines.rational_quadratic_spline(*(jnp.asarray(a) for a in args), tail_bound=tail_bound)
    jx, _ = jax_splines.rational_quadratic_spline(jy, *(jnp.asarray(a) for a in args[1:]), inverse=True,
                                                  tail_bound=tail_bound)
    jax_err = np.abs(np.asarray(jx) - args[0]).max()
    if raw_std == 1.0:
        assert err <= ROUNDTRIP_TOL, err
        np.testing.assert_allclose(ld_inv.numpy(), -ld.numpy(), atol=LOGDET_TOL, rtol=0)
    else:  # the bins' float32 conditioning, in both packages
        assert jax_err > ROUNDTRIP_TOL and err <= 1.1 * jax_err, (err, jax_err)


def test_spline_inverse_at_the_knots_matches_jax():
    """Inputs exactly on the height knots and the tail bounds, where the bin
    search and the quadratic's discriminant decide the bin, at raw std 1.
    The outputs are held against JAX and the forward brings them back within
    the round-trip bar. The two packages' float32 knots may sit an ulp apart,
    which puts an input in adjacent bins: the output is continuous there, but
    the logdet's float32 value next to a knot is not (2 of these 1728 differ
    from JAX's by ~0.02; at std 2 by ~0.3), so the logdet is held against
    autograd of the port's own inverse."""
    _, w, hgt, d = _case(8, 3.0, seed=20, n=64, raw_std=1.0)
    cum = torch.cumsum(torch.softmax(torch.from_numpy(hgt), dim=-1) * (1 - 1e-3 * 8) + 1e-3, dim=-1)
    knots = (6.0 * cum - 3.0).numpy().astype(np.float32)
    x = np.concatenate([knots[:, :, :-1], np.full(knots.shape[:2] + (1,), 3.0, np.float32),
                        np.full(knots.shape[:2] + (1,), -3.0, np.float32)], axis=-1)
    rep = x.shape[-1]
    args = (x.transpose(2, 0, 1).reshape(-1, 3), *(np.tile(a, (rep, 1, 1)) for a in (w, hgt, d)))
    (ref_y, ref_ld), (y, ld) = _both(args, True, 3.0)
    assert np.isfinite(y).all() and np.isfinite(ld).all()
    np.testing.assert_allclose(y, ref_y, atol=TOL, rtol=0)
    assert np.mean(np.abs(ld - ref_ld) <= LOGDET_TOL) > 0.99
    x = torch.from_numpy(args[0]).requires_grad_(True)
    y_t, ld_t = splines.rational_quadratic_spline(x, *(torch.from_numpy(a) for a in args[1:]), inverse=True,
                                                  tail_bound=3.0)
    (dy,) = torch.autograd.grad(y_t.sum(), x)
    np.testing.assert_allclose(ld_t.detach().numpy(), torch.log(dy.abs()).numpy(), atol=LOGDET_TOL, rtol=0)
    back, _ = splines.rational_quadratic_spline(torch.from_numpy(y), *(torch.from_numpy(a) for a in args[1:]),
                                                tail_bound=3.0)
    np.testing.assert_allclose(back.numpy(), args[0], atol=ROUNDTRIP_TOL, rtol=0)


@pytest.mark.parametrize("num_bins", [8, 5])
def test_spline_logdet_matches_autograd(num_bins):
    x, w, hgt, d = (torch.from_numpy(a) for a in _case(num_bins, 3.0, seed=30 + num_bins, spread=0.8))
    x.requires_grad_(True)
    y, ld = splines.rational_quadratic_spline(x, w, hgt, d, tail_bound=3.0)
    (dy,) = torch.autograd.grad(y.sum(), x)  # elementwise: the Jacobian is diagonal
    np.testing.assert_allclose(ld.detach().numpy(), torch.log(dy.abs()).numpy(), atol=LOGDET_TOL, rtol=0)
