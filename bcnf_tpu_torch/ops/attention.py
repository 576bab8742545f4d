"""Multi-head self-attention and the post-norm transformer block (port of
`bcnf_tpu/ops/attention.py`).

Sequences here are T ~ 20-60 frames, so attention is written as the JAX
module writes it: a float32 product, a softmax and a float32 product. It does
not call `scaled_dot_product_attention`, whose kernel choice on the card
(flash or memory-efficient, with their own accumulation order) would differ
from the float32 products the port holds elsewhere.
"""

from __future__ import annotations

import math

import torch

from bcnf_tpu_torch.ops.nn import (
    Params,
    dropout,
    gelu,
    layer_norm_apply,
    layer_norm_init,
    linear_apply,
    linear_init,
)


def mha_init(generator: torch.Generator, d_model: int, n_heads: int = 1) -> Params:
    """Projections to ``n_heads * (d_model // n_heads)``, which is d_model
    when n_heads divides it: the JAX package's deliberate divergence
    (`bcnf_tpu/ops/attention.py:29-42`) that lets configs such as
    t_PTRF_small (width 46, 4 heads) and t_DPTRF_medium (70, 8) run."""
    inner = n_heads * (d_model // n_heads)
    return {
        "q": linear_init(generator, d_model, inner),
        "k": linear_init(generator, d_model, inner),
        "v": linear_init(generator, d_model, inner),
        "out": linear_init(generator, inner, d_model),
    }


def mha_apply(params: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Self-attention over `(B, T, D)` (reference `feature_network.py:203-229`)."""
    B, T, D = x.shape
    head_dim = D // n_heads

    def split_heads(h: torch.Tensor) -> torch.Tensor:
        return h.reshape(B, T, n_heads, head_dim).transpose(1, 2)

    q = split_heads(linear_apply(params["q"], x))
    k = split_heads(linear_apply(params["k"], x))
    v = split_heads(linear_apply(params["v"], x))
    scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(head_dim)
    out = torch.matmul(torch.softmax(scores, dim=-1), v)
    return linear_apply(params["out"], out.transpose(1, 2).reshape(B, T, n_heads * head_dim))


def transformer_block_init(generator: torch.Generator, d_model: int, ff_size: int, n_heads: int = 1) -> Params:
    return {
        "attn": mha_init(generator, d_model, n_heads),
        "norm1": layer_norm_init(d_model),
        "norm2": layer_norm_init(d_model),
        "ff1": linear_init(generator, d_model, ff_size),
        "ff2": linear_init(generator, ff_size, d_model),
    }


def transformer_block_apply(params: Params, x: torch.Tensor, n_heads: int, dropout_rate: float = 0.1,
                            generator: torch.Generator | None = None, train: bool = False) -> torch.Tensor:
    """Post-norm block: `norm(x + drop(attn)); norm(x + drop(ffn))`
    (reference `feature_network.py:255-260`), tanh-GELU in the feed-forward."""
    attn = mha_apply(params["attn"], x, n_heads)
    x = layer_norm_apply(params["norm1"], x + dropout(generator, attn, dropout_rate, train))
    ff = linear_apply(params["ff2"], gelu(linear_apply(params["ff1"], x)))
    return layer_norm_apply(params["norm2"], x + dropout(generator, ff, dropout_rate, train))


def sinusoidal_positional_embeddings(seq_len: int, dim: int, device: str | torch.device | None = None) -> torch.Tensor:
    """`(seq_len, dim)` sinusoidal embeddings over the full width, by the JAX
    package's formula (`bcnf_tpu/ops/attention.py:96-109`): angle
    ``pos / 10000^(2j/dim)`` for column j, sine on even j and cosine on odd
    j (not the textbook exponent ``2*floor(j/2)``), in float32."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(dim, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * j / dim)
    even = (torch.arange(dim, device=device) % 2 == 0)[None, :]
    return torch.where(even, torch.sin(angle), torch.cos(angle))
