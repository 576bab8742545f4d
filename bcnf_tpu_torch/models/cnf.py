"""Conditional RealNVP normalizing flow (port of `bcnf_tpu/models/cnf.py`).

The same design as the JAX package, in PyTorch idiom:

- **Parameters are a plain tree** of dicts, lists and tensors, with the JAX
  package's keys and layouts (linear weights ``(in, out)``; every inner
  block's leaves stacked on a leading block axis), so `bcnf_tpu_torch.bridge`
  carries weights across by plain copies.
- **Hoisted condition projections.** Each coupling's first-layer weight is
  split ``W1 = [W1_y; W1_h]`` and ``h @ W1_h`` is computed once for every
  block in one batched matmul; conditions are encoded once per batch, not
  once per posterior draw.
- **The whole-flow kernels.** On a CUDA tensor with no gradient required,
  `forward` and `inverse_given_h` run the flow as one launch of the
  hand-written kernel K1 (`ops/flow_kernel.py`), the counterpart of the JAX
  package's Pallas `fused_flow`: in 3xTF32 on the tensor cores by default
  (the inverse on `wgmma` up to the padded width 544, on the row tiles
  above it; the forward on the row tiles), in float32 FMA with
  `pallas_strict`, in one TF32 pass at the reduced precisions. Under autograd
  (training), `forward` runs K2a and its backward K2b (`fused_flow_train`,
  the counterpart of the JAX package's `forward_fused_flow`) behind the gate
  `_use_fused_train`, in K1's mode (`train_kernel_mode`: float32 FMA too
  with `pallas_strict`). Where a gate is closed for a structural reason
  (dropout in training, a small batch, a CPU tensor), the plain composition
  below runs: the counterpart of the JAX XLA path.
- **The per-coupling kernel.** A model with `use_pallas_coupling = True`
  (off by default, as in JAX) runs `inverse_given_h` and the no-grad
  `forward` as the per-block loop with K4 (`ops/coupling_kernel.py`) in
  every coupling, in place of K1; `sample(outer=True)` keeps K1, as JAX's
  `sample` does.

Every option of the JAX model is ported: affine and RQS couplings
(`coupling`, `coupling_kwargs`), one-way or `two_way`, with the `Linear`,
`AnyGLU` or `LinearFFTEnriched` layer family, and the hybrid MSE head. The
kernels cover what the JAX package's cover: one-way affine couplings of the
`Linear` family with GELU (`AffineCoupling.fusable`); every other coupling
runs the plain composition, as it runs the XLA path in JAX.

**Precision** (`precision`, the JAX model's matmul-precision string; the
table `FUSED_PRECISION_MODES`): "highest"/"float32" run the kernels in
3xTF32 and every other product in float32; "default", "bfloat16" and
"BF16_BF16_F32_X3" run the kernels in one TF32 pass and allow TF32 in cuBLAS
and cuDNN (`matmul_precision`, the counterpart of
`jax.default_matmul_precision`, around the model's work where JAX wraps it);
"BF16_BF16_F32_X6" closes the kernel gate and runs the plain path in
float32. The CPU computes float32 at every precision, as JAX's does.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from collections.abc import Callable, Iterator
from typing import Any, Sequence

import numpy as np
import torch

from bcnf_tpu_torch.bridge import map_tree, tree_leaves
from bcnf_tpu_torch.models.splines import n_spline_params, rational_quadratic_spline
from bcnf_tpu_torch.ops.flow_kernel import MODE_3XTF32, MODE_FMA, MODE_TF32
from bcnf_tpu_torch.ops.nn import Params, dropout, get_activation, get_dense_layer, linear_init
from bcnf_tpu_torch.utils.misc import resolve_device

# The matmul-precision strings the model takes, and the kernels' mode for
# each (`_FUSED_PRECISION_MODES`, bcnf_tpu/models/cnf.py:951-973): the
# "highest"/"float32" contract in 3xTF32 (JAX's "x3"; `pallas_strict` makes
# K1 float32 FMA, JAX's "highest"), the reduced ones in one TF32 pass (JAX's
# "default"). "BF16_BF16_F32_X6" is missing from the table, so the kernel
# gate closes, as in JAX, and the plain path runs in float32; any other
# string raises: the port knows no other XLA algorithm to mirror.
FUSED_PRECISION_MODES = {
    "highest": MODE_3XTF32,
    "float32": MODE_3XTF32,
    "default": MODE_TF32,
    "bfloat16": MODE_TF32,
    "BF16_BF16_F32_X3": MODE_TF32,
}
PRECISIONS = (*FUSED_PRECISION_MODES, "BF16_BF16_F32_X6")
REDUCED_PRECISIONS = tuple(p for p, m in FUSED_PRECISION_MODES.items() if m == MODE_TF32)


def check_precision(precision: str) -> str:
    """`precision` if the port takes it, else ValueError naming those it takes."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    return precision


@contextlib.contextmanager
def matmul_precision(precision: str) -> Iterator[None]:
    """The counterpart of `jax.default_matmul_precision`: inside, cuBLAS's
    float32 products and cuDNN's convolutions may take TF32 at the reduced
    precisions (`torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` on) and run float32 at every other (both
    off). Both flags are restored on exit, also on an exception. Torch reads
    them when each op launches, so a backward that should run at the
    precision runs inside too."""
    tf32 = check_precision(precision) in REDUCED_PRECISIONS
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _at_precision(method: Callable) -> Callable:
    """Run a model method inside `matmul_precision(model.precision)`, where
    the JAX model wraps the same work."""

    @functools.wraps(method)
    def wrapped(self: "CondRealNVP", *args: Any, **kwargs: Any) -> Any:
        with matmul_precision(self.precision):
            return method(self, *args, **kwargs)

    return wrapped


def _checkpointed(fn: Callable, i: int, y: torch.Tensor, log_det: torch.Tensor,
                  generator: torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    """`fn(i, y, log_det)` under `torch.utils.checkpoint`, its dropout drawn
    alike both times: the recomputation in the backward replays the
    generator from its state at the first call, then puts it back, as
    `jax.checkpoint` replays the block's key."""
    from torch.utils.checkpoint import checkpoint

    start = generator.get_state() if generator is not None else None
    calls = [0]

    def run(y: torch.Tensor, log_det: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        calls[0] += 1
        if calls[0] == 1 or start is None:
            return fn(i, y, log_det)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(i, y, log_det)
        finally:
            generator.set_state(after)

    return checkpoint(run, y, log_det, use_reentrant=False)


def count_params(params: Any) -> int:
    """Total number of scalar parameters in a tree (reference `cnf.py:19-20`)."""
    return sum(int(x.numel()) for x in tree_leaves(params))


class NestedMLP:
    """The conditioner MLP inside a coupling layer (reference
    `ConditionalNestedNeuralNetwork`, `src/bcnf/models/cnf.py:49-107`;
    `bcnf_tpu/models/cnf.py:99-195`).

    ``sizes = [half_in] + nested_sizes + [half_out]``; the first layer input is
    widened by ``n_conditions`` and the last layer output by
    ``n_output_parameters``. The first-layer split (``h @ W1_h`` hoisted out
    of the block loop) holds for the `Linear` and `AnyGLU` families, whose
    first layer is one or two plain matrices; `LinearFFTEnriched` mixes the
    condition into its FFT features and is applied whole.
    """

    def __init__(
        self,
        sizes: Sequence[int],
        n_conditions: int,
        n_output_parameters: int,
        layer: str = "Linear",
        layer_kwargs: dict | None = None,
        activation: str = "GELU",
        activation_kwargs: dict | None = None,
        dropout: float = 0.0,
    ) -> None:
        if len(sizes) < 2:
            raise ValueError("NestedMLP requires at least input and output sizes")
        self.in_dim = sizes[0]
        self.n_conditions = n_conditions
        self.dims = [sizes[0] + n_conditions] + list(sizes[1:-1]) + [sizes[-1] * n_output_parameters]
        self.family = get_dense_layer(layer, layer_kwargs)
        self.activation_name = activation
        self.act = get_activation(activation, **(activation_kwargs or {}))
        self.dropout_rate = dropout
        self.splittable = n_conditions > 0 and self.family.name in ("Linear", "AnyGLU")

    def init(self, generator: torch.Generator) -> Params:
        return {
            "layers": [
                self.family.init(generator, self.dims[i], self.dims[i + 1])
                for i in range(len(self.dims) - 1)
            ]
        }

    def _first_weights(self, layer0: Params) -> list[Params]:
        return [layer0] if self.family.name == "Linear" else [layer0["value"], layer0["gate"]]  # AnyGLU

    def cond_proj(self, params: Params, h: torch.Tensor) -> list[torch.Tensor] | None:
        """Precompute ``h @ W1_h``: a list with one entry per first-layer
        matrix (2 for AnyGLU: value, gate), each ``(..., B, hidden)`` with the
        params' leading block axes kept; None where the split does not hold."""
        if not self.splittable:
            return None
        return [torch.matmul(h, p["w"][..., self.in_dim:, :]) for p in self._first_weights(params["layers"][0])]

    def apply(
        self,
        params: Params,
        y: torch.Tensor,
        h: torch.Tensor | None,
        h_proj: list[torch.Tensor] | None = None,
        generator: torch.Generator | None = None,
        train: bool = False,
    ) -> torch.Tensor:
        layers = params["layers"]
        if self.splittable and h_proj is not None:
            outs = [y @ p["w"][: self.in_dim] + p["b"] + proj
                    for p, proj in zip(self._first_weights(layers[0]), h_proj)]
            x = outs[0] if self.family.name == "Linear" else outs[0] * self.family.glu_act(outs[1])
        else:
            # h (N, c) broadcasts against draws-major rows y (..., N, d), as the projections do
            inp = y if self.n_conditions == 0 or h is None else torch.cat(
                [y, h.expand(y.shape[:-1] + h.shape[-1:])], dim=-1)
            x = self.family.apply(layers[0], inp)
        for i in range(len(layers) - 1):
            if i > 0:
                x = self.family.apply(layers[i], x)
            x = self.act(x)
            x = dropout(generator, x, self.dropout_rate, train)
        return self.family.apply(layers[-1], x)


class _Coupling:
    """What the affine and the RQS coupling share: the halves ``d_a =
    ceil(size/2)``, ``d_b = floor(size/2)``, the conditioner ``nn_a`` of the
    b half on the a half, and with `two_way` a second conditioner ``nn_b``
    of the a half on the transformed b half; parameters ``{"a"[, "b"]}``,
    and the projections ``{"a", "b"}`` that `cond_proj` returns in the same
    structure (``"b"`` is None when one-way)."""

    def __init__(self, input_size: int, nested_sizes: Sequence[int], n_output_parameters: int,
                 two_way: bool, **mlp_kwargs: Any) -> None:
        self.input_size = input_size
        self.d_a = math.ceil(input_size / 2)
        self.d_b = math.floor(input_size / 2)
        self.two_way = two_way
        self.nn_a = NestedMLP([self.d_a] + list(nested_sizes) + [self.d_b], n_output_parameters=n_output_parameters,
                              **mlp_kwargs)
        self.nn_b = NestedMLP([self.d_b] + list(nested_sizes) + [self.d_a], n_output_parameters=n_output_parameters,
                              **mlp_kwargs) if two_way else None

    def init(self, generator: torch.Generator) -> Params:
        p = {"a": self.nn_a.init(generator)}
        if self.nn_b is not None:
            p["b"] = self.nn_b.init(generator)
        return p

    def cond_proj(self, params: Params, h: torch.Tensor) -> dict:
        return {"a": self.nn_a.cond_proj(params["a"], h),
                "b": None if self.nn_b is None else self.nn_b.cond_proj(params["b"], h)}


class AffineCoupling(_Coupling):
    """Conditional affine coupling (reference `ConditionalAffineCouplingLayer`,
    `src/bcnf/models/cnf.py:110-213`; `bcnf_tpu/models/cnf.py:198-337`),
    with the optional `two_way` second half-transform. The scale is
    `tanh`-bounded, exactly as the reference."""

    def __init__(
        self,
        input_size: int,
        nested_sizes: Sequence[int],
        n_conditions: int,
        layer: str = "Linear",
        layer_kwargs: dict | None = None,
        activation: str = "GELU",
        activation_kwargs: dict | None = None,
        dropout: float = 0.0,
        two_way: bool = False,
    ) -> None:
        super().__init__(input_size, nested_sizes, 2, two_way, n_conditions=n_conditions, layer=layer,
                         layer_kwargs=layer_kwargs, activation=activation, activation_kwargs=activation_kwargs,
                         dropout=dropout)

    @staticmethod
    def _coeffs(mlp: NestedMLP, p: Params, y: torch.Tensor, h: torch.Tensor | None,
                h_proj: list[torch.Tensor] | None, generator: torch.Generator | None,
                train: bool) -> tuple[torch.Tensor, torch.Tensor]:
        t, s = torch.chunk(mlp.apply(p, y, h, h_proj, generator, train), 2, dim=-1)
        return t, torch.tanh(s)

    def forward(self, params: Params, y: torch.Tensor, h: torch.Tensor | None = None,
                h_proj: dict | None = None, generator: torch.Generator | None = None,
                train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        h_proj = h_proj or {}
        y_a, y_b = y[..., : self.d_a], y[..., self.d_a:]
        t_a, log_s_a = self._coeffs(self.nn_a, params["a"], y_a, h, h_proj.get("a"), generator, train)
        z_b = torch.exp(log_s_a) * y_b + t_a
        log_det = torch.sum(log_s_a, dim=-1)
        z_a = y_a
        if self.nn_b is not None:
            # the second half-transform conditions on the *transformed* z_b
            # (reference `cnf.py:183`)
            t_b, log_s_b = self._coeffs(self.nn_b, params["b"], z_b, h, h_proj.get("b"), generator, train)
            z_a = torch.exp(log_s_b) * y_a + t_b
            log_det = log_det + torch.sum(log_s_b, dim=-1)
        return torch.cat([z_a, z_b], dim=-1), log_det

    def inverse(self, params: Params, z: torch.Tensor, h: torch.Tensor | None = None,
                h_proj: dict | None = None, generator: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """The inverse of `forward`. With `two_way` it takes the JAX
        package's corrected order (`bcnf_tpu/models/cnf.py:287-306`; the
        reference's is not the inverse of its forward): undo the
        b-conditioned transform of y_a first (its conditioner input z_b is at
        hand), then the a side."""
        h_proj = h_proj or {}
        z_a, z_b = z[..., : self.d_a], z[..., self.d_a:]
        y_a = z_a
        if self.nn_b is not None:
            t_b, log_s_b = self._coeffs(self.nn_b, params["b"], z_b, h, h_proj.get("b"), generator, train)
            y_a = (z_a - t_b) * torch.exp(-log_s_b)
        t_a, log_s_a = self._coeffs(self.nn_a, params["a"], y_a, h, h_proj.get("a"), generator, train)
        return torch.cat([y_a, (z_b - t_a) * torch.exp(-log_s_a)], dim=-1)

    @property
    def fusable(self) -> bool:
        """Whether the whole-flow and per-coupling kernels cover this
        coupling: one-way, the Linear family and GELU (the kernels hardcode
        tanh-GELU; `bcnf_tpu/models/cnf.py:309-318`)."""
        return (self.nn_b is None and self.nn_a.family.name == "Linear"
                and self.nn_a.activation_name.upper() == "GELU")

    def _fused_rows(self, y: torch.Tensor, h_proj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """`y (..., N, size)` as K4's contiguous row halves; flattened row r
        is conditioned on `h_proj[r % N]`, which is how the rows broadcast
        against the (N, hidden) projections."""
        N = h_proj.shape[0]
        if N != 1 and (y.dim() < 2 or y.shape[-2] != N):
            raise ValueError(f"rows of shape {tuple(y.shape)} do not broadcast against {N} conditions")
        rows = y.reshape(-1, self.input_size)
        return rows[:, : self.d_a].contiguous(), rows[:, self.d_a:].contiguous()

    def forward_fused(self, params: Params, y: torch.Tensor, h_proj: dict,
                      mode: str = MODE_3XTF32) -> tuple[torch.Tensor, torch.Tensor]:
        """The coupling through K4 in `mode` (`bcnf_tpu/models/cnf.py:320-328`;
        eval only: the kernel has no dropout). `h_proj` is `cond_proj`'s dict."""
        from bcnf_tpu_torch.ops.coupling_kernel import fused_affine_coupling, mlp_params_to_kernel_args

        proj = h_proj["a"][0]
        x_a, x_b = self._fused_rows(y, proj)
        z_b, ld = fused_affine_coupling(x_a, x_b, proj, **mlp_params_to_kernel_args(params["a"], self.d_a),
                                        mode=mode)
        return torch.cat([y[..., : self.d_a], z_b.reshape(y.shape[:-1] + (self.d_b,))], dim=-1), ld.reshape(y.shape[:-1])

    def inverse_fused(self, params: Params, z: torch.Tensor, h_proj: dict, mode: str = MODE_3XTF32) -> torch.Tensor:
        """The coupling's inverse through K4 in `mode` (`bcnf_tpu/models/cnf.py:330-337`)."""
        from bcnf_tpu_torch.ops.coupling_kernel import fused_affine_coupling, mlp_params_to_kernel_args

        proj = h_proj["a"][0]
        z_a, z_b = self._fused_rows(z, proj)
        y_b = fused_affine_coupling(z_a, z_b, proj, **mlp_params_to_kernel_args(params["a"], self.d_a),
                                    inverse=True, mode=mode)
        return torch.cat([z[..., : self.d_a], y_b.reshape(z.shape[:-1] + (self.d_b,))], dim=-1)


class RQSCoupling(_Coupling):
    """Rational-quadratic-spline coupling (`bcnf_tpu/models/cnf.py:340-445`),
    the working form of the reference's intended
    `ConditionalRQSplineCouplingLayer` (SURVEY.md Q4), one-way or `two_way`.
    Each conditioner's raw output is reshaped to ``(..., d_out, 3K-1)`` and
    split into K widths, K heights and K-1 derivatives, the JAX layout that
    bridged weights depend on. No kernel covers it (`fusable` is False)."""

    fusable = False

    def __init__(
        self,
        input_size: int,
        nested_sizes: Sequence[int],
        n_conditions: int,
        num_bins: int = 8,
        tail_bound: float = 3.0,
        dropout: float = 0.0,
        layer: str = "Linear",
        layer_kwargs: dict | None = None,
        activation: str = "GELU",
        activation_kwargs: dict | None = None,
        two_way: bool = False,
    ) -> None:
        self.num_bins = num_bins
        self.tail_bound = tail_bound
        super().__init__(input_size, nested_sizes, n_spline_params(num_bins), two_way, n_conditions=n_conditions,
                         layer=layer, layer_kwargs=layer_kwargs, activation=activation,
                         activation_kwargs=activation_kwargs, dropout=dropout)

    def _spline(self, mlp: NestedMLP, p: Params, y_in: torch.Tensor, y_trans: torch.Tensor,
                h: torch.Tensor | None, h_proj: list[torch.Tensor] | None, generator: torch.Generator | None,
                train: bool, inverse: bool) -> tuple[torch.Tensor, torch.Tensor]:
        K = self.num_bins
        raw = mlp.apply(p, y_in, h, h_proj, generator, train)
        raw = raw.reshape(raw.shape[:-1] + (y_trans.shape[-1], n_spline_params(K)))
        out, ld = rational_quadratic_spline(y_trans, raw[..., :K], raw[..., K: 2 * K], raw[..., 2 * K:],
                                            inverse=inverse, tail_bound=self.tail_bound)
        return out, torch.sum(ld, dim=-1)

    def forward(self, params: Params, y: torch.Tensor, h: torch.Tensor | None = None,
                h_proj: dict | None = None, generator: torch.Generator | None = None,
                train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        h_proj = h_proj or {}
        y_a, y_b = y[..., : self.d_a], y[..., self.d_a:]
        z_b, ld = self._spline(self.nn_a, params["a"], y_a, y_b, h, h_proj.get("a"), generator, train, False)
        z_a = y_a
        if self.nn_b is not None:
            z_a, ld_b = self._spline(self.nn_b, params["b"], z_b, y_a, h, h_proj.get("b"), generator, train, False)
            ld = ld + ld_b
        return torch.cat([z_a, z_b], dim=-1), ld

    def inverse(self, params: Params, z: torch.Tensor, h: torch.Tensor | None = None,
                h_proj: dict | None = None, generator: torch.Generator | None = None,
                train: bool = False) -> torch.Tensor:
        """The corrected two-way order, as `AffineCoupling.inverse`."""
        h_proj = h_proj or {}
        z_a, z_b = z[..., : self.d_a], z[..., self.d_a:]
        y_a = z_a
        if self.nn_b is not None:
            y_a, _ = self._spline(self.nn_b, params["b"], z_b, z_a, h, h_proj.get("b"), generator, train, True)
        y_b, _ = self._spline(self.nn_a, params["a"], y_a, z_b, h, h_proj.get("a"), generator, train, True)
        return torch.cat([y_a, y_b], dim=-1)


class ActNorm:
    """Learnable elementwise affine (reference `src/bcnf/models/cnf.py:342-354`);
    log-det is ``sum(log|scale|)``."""

    def __init__(self, size: int) -> None:
        self.size = size

    def init(self) -> Params:
        return {"scale": torch.ones(self.size), "bias": torch.zeros(self.size)}

    def forward(self, params: Params, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        z = params["scale"] * x + params["bias"]
        ld = torch.sum(torch.log(torch.abs(params["scale"])), dim=-1)
        return z, ld.expand(x.shape[:-1])

    def inverse(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        return (z - params["bias"]) / params["scale"]


def orthonormal_init(seed: Any, size: int) -> torch.Tensor:
    """Fixed random orthonormal matrix: float64 NumPy QR cast to float32
    (`bcnf_tpu/models/cnf.py:472-485`), bit for bit the JAX package's."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((size, size)))
    return torch.from_numpy(q.astype(np.float32))


def _grad_required(*trees: Any) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for tree in trees for t in tree_leaves(tree)
    )


class CondRealNVP:
    """Conditional RealNVP v2 (reference `CondRealNVP_v2`, `src/bcnf/models/cnf.py:357-588`).

    Static configuration object; parameters live in the tree returned by
    :meth:`init`. Structure (reference `cnf.py:394-423`)::

        (n_blocks - 1) x [ActNorm?, Coupling, Orthonormal]  +  final Coupling

    The keyword arguments are the JAX package's. `use_pallas` gates the
    whole-flow kernel (here the CUDA one). The "highest"/"float32" precision
    runs it in 3xTF32 on the tensor cores, as the JAX model serves that
    contract with its "x3" kernel mode; `pallas_strict=True` forces the
    exact-float32 kernels (float32 FMA) at those precisions for sampling and
    the no-grad forward (K1) and for training (K2a, K2b), as the JAX model's
    flag forces its exact-float32 mode (`bcnf_tpu/models/cnf.py:1032-1033,
    1053-1054`). The reduced precisions run K1, K2a, K2b and K4 in one TF32
    pass (`FUSED_PRECISION_MODES`). The per-coupling kernel K4 has no
    exact-float32 mode: strict does not change it (`coupling_kernel_mode`;
    JAX's K4 takes no strict flag).
    """

    def __init__(
        self,
        size: int,
        nested_sizes: Sequence[int],
        n_blocks: int,
        n_conditions: int,
        feature_network_stack: Any | None = None,
        dropout: float = 0.0,
        act_norm: bool = False,
        two_way: bool = False,
        layer: str = "Linear",
        layer_kwargs: dict | None = None,
        activation: str = "GELU",
        activation_kwargs: dict | None = None,
        random_state: int | None = None,
        parameter_index_mapping: Any = None,
        hybrid: bool = False,
        coupling: str = "affine",
        coupling_kwargs: dict | None = None,
        precision: str = "highest",
        use_pallas: bool = True,
        pallas_strict: bool = False,
    ) -> None:
        self.size = size
        self.nested_sizes = list(nested_sizes)
        self.n_blocks = n_blocks
        self.n_conditions = n_conditions
        self.features = feature_network_stack if n_conditions > 0 else None
        self.dropout = dropout
        self.act_norm = act_norm
        self.two_way = two_way
        self.random_state = random_state
        self.parameter_index_mapping = parameter_index_mapping
        self.hybrid = hybrid
        self.precision = precision
        self.use_pallas = use_pallas
        self.pallas_strict = pallas_strict
        # the per-coupling kernel K4: opt-in, as in the JAX package (`cnf.py:555-558`)
        self.use_pallas_coupling = False
        # block-boundary rematerialization of the plain path (`training.remat`;
        # `bcnf_tpu/models/cnf.py:563-570`): under autograd each inner block
        # runs in `torch.utils.checkpoint`, so the backward recomputes its
        # activations from the block's input instead of keeping them. The
        # training kernels ignore it: the tensor-core K2b recomputes each
        # step's MLP from the stored step inputs; the strict K2a keeps each
        # layer's h and gelu' for the strict K2b, and past a row chunk's
        # share of the card's memory the strict backward runs K2a again a
        # chunk (`ops/flow_kernel.py::strict_chunks`), so the keep and K2b's
        # scratch stay within that share at any batch; the rest of the step
        # still grows with the rows, as the plain path's does.
        self.remat = False
        common = dict(
            input_size=size, nested_sizes=nested_sizes, n_conditions=n_conditions,
            layer=layer, layer_kwargs=layer_kwargs, activation=activation,
            activation_kwargs=activation_kwargs, dropout=dropout, two_way=two_way,
        )
        if coupling == "affine":
            self.coupling = AffineCoupling(**common)
        elif coupling == "rqs":
            self.coupling = RQSCoupling(**common, **(coupling_kwargs or {}))
        else:
            raise NotImplementedError(f"Coupling type {coupling} not implemented")
        self.actnorm = ActNorm(size) if act_norm else None

    @property
    def precision(self) -> str:
        return self._precision

    @precision.setter
    def precision(self, value: str) -> None:
        """One of `PRECISIONS`; any other string raises ValueError."""
        self._precision = check_precision(value)

    @property
    def kernel_mode(self) -> str | None:
        """K1's mode at this precision (None: the gate is closed):
        `FUSED_PRECISION_MODES`, with `pallas_strict` making the
        "highest"/"float32" contract float32 FMA."""
        if self.pallas_strict and self.precision in ("highest", "float32"):
            return MODE_FMA
        return FUSED_PRECISION_MODES.get(self.precision)

    @property
    def train_kernel_mode(self) -> str | None:
        """The mode of K2a and K2b at this precision (None: closed): K1's,
        as JAX's `forward_fused_flow` takes its exact-float32 mode under
        `pallas_strict` at "highest"/"float32"."""
        return self.kernel_mode

    @property
    def coupling_kernel_mode(self) -> str | None:
        """The mode of K4 at this precision (None: closed), which
        `pallas_strict` does not change (JAX's K4 takes no strict flag)."""
        return FUSED_PRECISION_MODES.get(self.precision)

    # -- construction -----------------------------------------------------

    def init(self, generator: torch.Generator | None = None, device: str | torch.device | None = None) -> Params:
        """Random parameters drawn on the CPU from `generator` (a CPU
        `torch.Generator`; default: seeded with `random_state`), then moved
        to `device` (default CUDA): one seed gives the same weights on every
        device."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(self.random_state or 0)
        params: Params = {}
        if self.features is not None:
            params["features"] = self.features.init(generator)
        n_inner = self.n_blocks - 1
        if n_inner > 0:
            couplings = [self.coupling.init(generator) for _ in range(n_inner)]
            base_seed = self.random_state if self.random_state is not None else 0
            blocks: Params = {
                "coupling": map_tree(lambda *xs: torch.stack(xs), *couplings),
                "ortho": torch.stack([orthonormal_init([base_seed, i], self.size) for i in range(n_inner)]),
            }
            if self.actnorm is not None:
                blocks["actnorm"] = map_tree(
                    lambda *xs: torch.stack(xs), *[self.actnorm.init() for _ in range(n_inner)]
                )
            params["blocks"] = blocks
        params["final"] = self.coupling.init(generator)
        if self.hybrid:
            params["head"] = linear_init(generator, self.n_conditions, self.size)
        return map_tree(lambda t: t.to(dev), params)

    def n_params(self, params: Params) -> int:
        return count_params(params)

    @torch.no_grad()
    @_at_precision
    def init_actnorm(self, params: Params, y: torch.Tensor, *conditions: torch.Tensor,
                     eps: float = 1e-6) -> Params:
        """Glow-style data-dependent ActNorm initialization
        (`bcnf_tpu/models/cnf.py:623-672`): walks the stack once with a data
        batch, setting each ActNorm's scale to 1/std and bias to -mean/std of
        its own input (population std), so every block sees a zero-mean
        unit-variance activation at step 0. Returns a new tree; the tensors
        of `params` are not changed."""
        blocks = params.get("blocks")
        if self.actnorm is None or blocks is None or "actnorm" not in blocks:
            return params
        h = self.encode(params, conditions) if self.features is not None else None
        scale = blocks["actnorm"]["scale"].clone()
        bias = blocks["actnorm"]["bias"].clone()
        x = y
        for i in range(self.n_blocks - 1):
            sd = torch.std(x, dim=0, correction=0) + eps
            scale[i], bias[i] = 1.0 / sd, -torch.mean(x, dim=0) / sd
            x = x * scale[i] + bias[i]
            x, _ = self.coupling.forward(map_tree(lambda t: t[i], blocks["coupling"]), x, h)
            x = x @ blocks["ortho"][i]
        return dict(params, blocks=dict(blocks, actnorm={"scale": scale, "bias": bias}))

    def verify(self) -> None:
        """Shape-chain check over the feature networks (reference `cnf.py:425-440`)."""
        if self.features is None:
            return

        def _norm(s: Any) -> Any:
            return tuple(s) if isinstance(s, (list, tuple)) else s

        current = None
        for fn in self.features.feature_networks:
            in_size = _norm(getattr(fn, "input_size", None))
            out_size = _norm(getattr(fn, "output_size", None))
            if in_size is None and out_size is None:
                continue
            if current is not None and in_size not in (None, current):
                raise AssertionError(
                    f"Feature network output {current} does not match next input {in_size}."
                )
            if out_size is not None:
                current = out_size
        if current is not None and current != self.n_conditions:
            raise AssertionError(
                f"Feature network output {current} must match n_conditions {self.n_conditions}."
            )

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "CondRealNVP":
        """Build from a reference-schema run config (reference `cnf.py:442-456`)."""
        from bcnf_tpu_torch.config import ParameterIndexMapping
        from bcnf_tpu_torch.factories import FeatureNetworkFactory
        from bcnf_tpu_torch.models.feature_network import FeatureNetworkStack

        feature_networks = [
            FeatureNetworkFactory.get_feature_network(fn_config["type"], dict(fn_config.get("kwargs") or {}))
            for fn_config in config["feature_networks"]
        ]
        model_kwargs = {k: v for k, v in dict(config["model"]["kwargs"]).items() if k != "device"}
        if "nested_sizes" in model_kwargs:
            model_kwargs["nested_sizes"] = list(model_kwargs["nested_sizes"])
        model = cls(
            feature_network_stack=FeatureNetworkStack(feature_networks),
            parameter_index_mapping=ParameterIndexMapping(list(config["global"]["parameter_selection"])),
            **model_kwargs,
        )
        model.verify()
        return model

    # -- encoding ---------------------------------------------------------

    @_at_precision
    def encode(self, params: Params, conditions: Sequence[torch.Tensor],
               generator: torch.Generator | None = None, train: bool = False) -> torch.Tensor:
        """Run the feature-network stack once (reference `cnf.py:467-473`)."""
        if self.features is None:
            raise ValueError("Model has no conditions")
        return self.features.apply(params["features"], *conditions, generator=generator, train=train)

    # -- the whole-flow kernel ---------------------------------------------

    def _use_fused(self, train: bool, x: torch.Tensor, *trees: Any) -> bool:
        """Kernel gate: `_use_fused` of the JAX package (`bcnf_tpu/models/cnf.py:744-760`)
        with the TPU platform test replaced by "a CUDA tensor, no gradient
        required". Structural guards: at least one inner block and two nested
        layers (`stack_flow_params`), one hidden width for all of them, and a
        shape K1's kernels take in this mode (`_fused_flow_takes`), as JAX's
        `inverse_fused_flow` returns None for a layout it does not take
        (`bcnf_tpu/models/cnf.py:1058-1059`), and a precision the kernels
        have a mode for (`kernel_mode`; JAX's returns None for the rest)."""
        return (
            self.use_pallas
            and self.kernel_mode is not None
            and not train
            and self.n_conditions > 0
            and self.n_blocks > 1
            and len(self.nested_sizes) >= 2
            and len(set(self.nested_sizes)) == 1
            and self.coupling.fusable
            and self._fused_flow_takes()
            and x.is_cuda
            and not _grad_required(x, *trees)
        )

    def _fused_flow_takes(self) -> bool:
        """Whether K1's kernels take this model's shape in its mode, both
        ways: the hidden width within the widest compiled one, and the rows'
        state within the shared memory of the kernel each direction runs."""
        from bcnf_tpu_torch.ops.flow_kernel import KERNEL_TN, flow_route, padded_width

        H = self.nested_sizes[0]
        if H > 32 * KERNEL_TN[-1]:
            return False
        Hp, d_a = padded_width(H), self.coupling.d_a
        mode = self.kernel_mode or MODE_3XTF32
        return all(flow_route(Hp, self.size, d_a, inverse, mode) for inverse in (True, False))

    def _fused_train_takes(self) -> bool:
        """Whether K2a and K2b take this model's shape in its kernel mode: the
        hidden width within the widest compiled one, and a K2b route for the
        mode (`train_kernels_take`: the row tiles' weight-grad jobs and both
        rows kernels' shared memory, or the `wgmma` route's, the limits
        their launchers check). Where they do not, the gate closes
        and the plain autograd path trains, as JAX's `forward_fused_flow` returns None
        for a layout its kernel does not take (`bcnf_tpu/ops/flow_kernel.py:692-696`)."""
        from bcnf_tpu_torch.ops.flow_kernel import KERNEL_TN, padded_width, train_kernels_take

        H = self.nested_sizes[0]
        if H > 32 * KERNEL_TN[-1]:
            return False
        return train_kernels_take(padded_width(H), self.size, self.coupling.d_a, len(self.nested_sizes) - 1,
                                  self.train_kernel_mode or MODE_3XTF32)

    def _use_fused_coupling(self, train: bool, x: torch.Tensor, *trees: Any) -> bool:
        """Per-coupling kernel gate (`bcnf_tpu/models/cnf.py:762-764`)."""
        return self.use_pallas_coupling and self._use_fused(train, x, *trees)

    # Minimum batch for the training kernels (`bcnf_tpu/models/cnf.py:998`,
    # overridable per model or by the BCNF_FUSED_TRAIN_MIN_BATCH variable):
    # on an H100 K2a/K2b beat plain autograd at every batch chip_smoke.py
    # sweeps, 32 to 256 rows (PERF.md, the training floor's table), so the
    # floor is the least batch measured.
    fused_train_min_batch: int = 32

    def _use_fused_train(self, train: bool, x: torch.Tensor) -> bool:
        """Training-kernel gate: `_use_fused_train` of the JAX package
        (`bcnf_tpu/models/cnf.py:1000-1017`): the structural guards of
        `_use_fused`, a dropout-free coupling when training (the kernels draw
        no random bits), a batch of at least `fused_train_min_batch` rows, and
        a CUDA tensor in place of the TPU platform test, at a precision the
        kernels have a mode for (`train_kernel_mode`) and a shape they take
        (`_fused_train_takes`). It checks no memory: the strict pair's keep
        (`train_keep`) grows with the rows, but where a chunk's keep and K2b
        scratch would pass their share of the card's memory the strict
        backward runs in row chunks, K2a again on each
        (`ops/flow_kernel.py::strict_chunks`), which bounds those two. The
        rest of the step (activations, step inputs, grads, the encoder)
        still grows with the rows, so the largest batch is the card's: at
        the flagship's shape it grows 0.63 MB a row beyond ~16 GB, and on an
        NVIDIA H100 80GB HBM3 65,536 rows train and 81,920 run out of memory
        (PERF.md §5, `tools/strict_step_rate.py --batch N`)."""
        min_batch = int(os.environ.get("BCNF_FUSED_TRAIN_MIN_BATCH", self.fused_train_min_batch))
        return (
            self.use_pallas
            and self.train_kernel_mode is not None
            and self.n_conditions > 0
            and self.n_blocks > 1
            and len(self.nested_sizes) >= 2
            and len(set(self.nested_sizes)) == 1
            and self.coupling.fusable
            and (not train or float(self.dropout) == 0.0)
            and x.dim() == 2
            and x.shape[0] >= min_batch
            and x.is_cuda
            and self._fused_train_takes()
        )

    def _fused_flow_args(self, params: Params, h: torch.Tensor) -> tuple[dict, torch.Tensor]:
        """Stacked kernel args + the (K+1, N, Hp) condition projections, with
        the hidden width zero-padded to the kernel's width."""
        from bcnf_tpu_torch.ops.flow_kernel import pad_hidden, stack_flow_params

        kargs = stack_flow_params(self, params)
        proj_blocks = self.coupling.cond_proj(params["blocks"]["coupling"], h)["a"][0]
        proj_final = self.coupling.cond_proj(params["final"], h)["a"][0]
        return pad_hidden(kargs, torch.cat([proj_blocks, proj_final[None]], dim=0))

    def _fused(self, params: Params, x: torch.Tensor, h: torch.Tensor, inverse: bool) -> Any:
        """One kernel launch over all rows of `x` (..., size); flattened row
        r is conditioned on h[r % N], which is how (..., N, size) rows
        broadcast against (N, n_conditions) conditions."""
        from bcnf_tpu_torch.ops.flow_kernel import fused_flow

        N = h.shape[0]
        if N != 1 and (x.dim() < 2 or x.shape[-2] != N):
            raise ValueError(f"rows of shape {tuple(x.shape)} do not broadcast against {N} conditions")
        kargs, h_proj = self._fused_flow_args(params, h)
        out = fused_flow(x.reshape(-1, self.size).contiguous(), h_proj, **kargs, inverse=inverse, n_cond=N,
                         mode=self.kernel_mode)
        if inverse:
            return out.reshape(x.shape)
        z, ld = out
        return z.reshape(x.shape), ld.reshape(x.shape[:-1])

    def forward_fused_flow(self, params: Params, y: torch.Tensor,
                           h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The differentiable whole-flow forward (`bcnf_tpu/models/cnf.py:1019-1039`):
        K2a for z and logdet, K2b for every grad in the backward. Grads reach
        the param tree through the stacking and padding (`torch.cat`,
        `F.pad`), and the encoder through the condition projections."""
        from bcnf_tpu_torch.ops.flow_kernel import fused_flow_train

        kargs, h_proj = self._fused_flow_args(params, h)
        return fused_flow_train(y.contiguous(), h_proj, **kargs, mode=self.train_kernel_mode)

    # -- flow -------------------------------------------------------------

    def _block(self, params: Params, projs: dict | None, i: int) -> tuple[Params, dict | None]:
        """Block i's parameters and its slice of the stacked projections
        (`cond_proj`'s dict of per-matrix lists, each entry with a leading
        block axis; None entries stay None)."""
        blk = map_tree(lambda t: t[i], params["blocks"])
        if projs is None:
            return blk, None
        return blk, {k: None if v is None else [t[i] for t in v] for k, v in projs.items()}

    @_at_precision
    def forward(
        self,
        params: Params,
        y: torch.Tensor,
        *conditions: torch.Tensor,
        generator: torch.Generator | None = None,
        train: bool = False,
        return_features: bool = False,
    ) -> tuple[torch.Tensor, ...]:
        """theta -> z with log|det J| (reference `cnf.py:467-493`)."""
        h = self.encode(params, conditions, generator, train) if self.features is not None else None
        fused = h is not None and self._use_fused_coupling(train, y, h, params)
        if h is not None and not fused and self._use_fused(train, y, h, params):
            z, log_det = self._fused(params, y, h, inverse=False)
            return (z, log_det, h) if return_features else (z, log_det)
        if h is not None and not fused and self._use_fused_train(train, y):
            z, log_det = self.forward_fused_flow(params, y, h)
            return (z, log_det, h) if return_features else (z, log_det)

        def couple(p: Params, x: torch.Tensor, proj: dict | None) -> tuple[torch.Tensor, torch.Tensor]:
            if fused:
                return self.coupling.forward_fused(p, x, proj, self.coupling_kernel_mode)
            return self.coupling.forward(p, x, h, proj, generator, train)

        log_det = y.new_zeros(y.shape[:-1])
        if "blocks" in params:
            projs = self.coupling.cond_proj(params["blocks"]["coupling"], h) if h is not None else None

            def block(i: int, y: torch.Tensor, log_det: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
                blk, proj = self._block(params, projs, i)
                if self.actnorm is not None:
                    y, ld_an = self.actnorm.forward(blk["actnorm"], y)
                    log_det = log_det + ld_an
                y, ld_c = couple(blk["coupling"], y, proj)
                # fixed (non-trainable) mixing matrix, reference `cnf.py:323-324`
                return y @ blk["ortho"].detach(), log_det + ld_c

            for i in range(self.n_blocks - 1):
                if self.remat and torch.is_grad_enabled():
                    y, log_det = _checkpointed(block, i, y, log_det, generator)
                else:
                    y, log_det = block(i, y, log_det)
        final_proj = self.coupling.cond_proj(params["final"], h) if h is not None else None
        y, ld_f = couple(params["final"], y, final_proj)
        log_det = log_det + ld_f
        return (y, log_det, h) if return_features else (y, log_det)

    def inverse(self, params: Params, z: torch.Tensor, *conditions: torch.Tensor,
                generator: torch.Generator | None = None, train: bool = False) -> torch.Tensor:
        """z -> theta (reference `cnf.py:495-508`)."""
        h = self.encode(params, conditions, generator, train) if self.features is not None else None
        return self.inverse_given_h(params, z, h, generator=generator, train=train)

    @_at_precision
    def inverse_given_h(self, params: Params, z: torch.Tensor, h: torch.Tensor | None,
                        generator: torch.Generator | None = None, train: bool = False) -> torch.Tensor:
        """Inverse with a pre-encoded condition vector: encode conditions once
        and reuse them across many z draws (posterior sampling). With
        `use_pallas_coupling` (and its gate open) every coupling runs through
        K4; else, with the whole-flow gate open, one launch of K1."""
        fused = h is not None and self._use_fused_coupling(train, z, h, params)
        if h is not None and not fused and self._use_fused(train, z, h, params):
            return self._fused(params, z, h, inverse=True)

        def uncouple(p: Params, x: torch.Tensor, proj: dict | None) -> torch.Tensor:
            if fused:
                return self.coupling.inverse_fused(p, x, proj, self.coupling_kernel_mode)
            return self.coupling.inverse(p, x, h, proj, generator, train)

        final_proj = self.coupling.cond_proj(params["final"], h) if h is not None else None
        z = uncouple(params["final"], z, final_proj)
        if "blocks" in params:
            projs = self.coupling.cond_proj(params["blocks"]["coupling"], h) if h is not None else None
            for i in range(self.n_blocks - 2, -1, -1):
                blk, proj = self._block(params, projs, i)
                z = z @ blk["ortho"].detach().T
                z = uncouple(blk["coupling"], z, proj)
                if self.actnorm is not None:
                    z = self.actnorm.inverse(blk["actnorm"], z)
        return z

    # -- probabilistic API -------------------------------------------------

    def log_prob(self, params: Params, y: torch.Tensor, *conditions: torch.Tensor) -> torch.Tensor:
        """Per-example log p(theta | condition) under the reference's NLL
        convention (constant omitted, SURVEY.md Q9)."""
        z, log_det = self.forward(params, y, *conditions)
        return -(0.5 * torch.sum(z**2, dim=-1) - log_det)

    def predict_head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Hybrid prediction head (`bcnf_tpu/models/cnf.py:915-919`)."""
        if not self.hybrid:
            raise ValueError("Model was not built with hybrid=True")
        return h @ params["head"]["w"] + params["head"]["b"]

    @_at_precision
    def sample(
        self,
        params: Params,
        generator: torch.Generator,
        n_samples: int,
        *conditions: torch.Tensor,
        sigma: float = 1.0,
        outer: bool = True,
        device: str | torch.device | None = None,
    ) -> torch.Tensor:
        """Draw `n_samples` posterior samples per condition row on `device`
        (default CUDA; the params must live there).

        Returns `(n_samples, N, size)`, draws-major, matching the reference's
        `outer=True` broadcast semantics (reference `cnf.py:540-588`).
        Conditions are encoded once. z is drawn from `generator` on its own
        device and moved (`draw_z`), so one seed gives the same z on every
        device. With `outer` and the whole-flow gate open the inverse is one
        launch of K1, with or without `use_pallas_coupling` (`bcnf_tpu/models/cnf.py:945-948`).
        """
        dev = resolve_device(device)
        conditions = tuple((c[None] if c.dim() == 1 else c).to(dev) for c in conditions)
        N = conditions[0].shape[0] if conditions else 1
        z = self.draw_z(generator, n_samples, N, sigma=sigma, outer=outer).to(dev)
        return self.sample_from_z(params, z, *conditions, outer=outer)

    def draw_z(self, generator: torch.Generator, n_samples: int, n_rows: int, sigma: float = 1.0,
               outer: bool = True) -> torch.Tensor:
        """`sample`'s draws, on the generator's device: `(n_samples, n_rows,
        size)` (`(n_samples, size)` without `outer`). The sharded paths draw
        them once for all rows and hand each shard its rows' slice, so their
        samples are one device's (`parallel/mesh.py`)."""
        shape = (n_samples, n_rows, self.size) if outer else (n_samples, self.size)
        return sigma * torch.randn(shape, generator=generator, device=generator.device)

    @_at_precision
    def sample_from_z(self, params: Params, z: torch.Tensor, *conditions: torch.Tensor,
                      outer: bool = True) -> torch.Tensor:
        """`sample` on given draws `z` and conditions on `z`'s device: the
        conditions encoded once, then the inverse (one launch of K1 where its
        gate is open and `outer`)."""
        h = self.encode(params, conditions) if self.features is not None else None
        if outer and h is not None and self._use_fused(False, z, h, params):
            return self._fused(params, z, h, inverse=True)
        return self.inverse_given_h(params, z, h)


# Backwards-compatible alias matching the reference class name
CondRealNVP_v2 = CondRealNVP
