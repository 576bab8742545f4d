"""Weights across packages: `bcnf_tpu` parameter trees <-> the port's.

A `bcnf_tpu` parameter tree (`jax.device_get(model.init(...))`, or the
`params.pkl` that `bcnf-tpu train` writes) is nested dicts and lists of NumPy
arrays. The port keeps the same keys and layouts, e.g.
``features.nets[i].lstm.layers[l].{fwd,bwd}.{w_ih,w_hh,b_ih,b_hh}``,
``blocks.{coupling.a.layers[j].{w,b}, ortho, actnorm.{scale,bias}}`` and
``final.a.layers[j]``; a `DualDomainLSTM`'s ``{time, freq, fc}`` (two LSTM
trees and ``fc.layers[j]``) and a `VerboseLSTM`'s ``layers[i]`` (one
single-layer LSTM tree each) likewise. So do the model zoo's trees: a
`Transformer`'s ``embed``, ``blocks[i].{attn.{q,k,v,out}, norm1, norm2, ff1,
ff2}`` and ``out``; the dual-domain encoders' ``{time, freq, fc}``; an
AnyGLU layer's ``{gate, value}``; a two-way coupling's ``b`` beside ``a``
(RQS couplings keep the affine ones' keys). So the bridge is a plain copy
each way and `params_to_numpy(params_from_numpy(t))` gives `t` back exactly
(`tests/test_torch_port_conditioners.py`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch

from bcnf_tpu_torch.utils.misc import resolve_device


def map_tree(fn: Callable[..., Any], *trees: Any) -> Any:
    """Apply `fn` leafwise over trees of one structure (dicts, lists, tuples)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(map_tree(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree: Any) -> Iterator[Any]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def params_from_numpy(tree: Any, device: str | torch.device | None = None, requires_grad: bool = False) -> Any:
    """A tree of NumPy arrays -> the same tree of tensors on `device`
    (default CUDA; dtypes kept), leaf tensors that require grad when asked
    (the trainer's parameters)."""
    dev = resolve_device(device)
    return map_tree(lambda a: torch.from_numpy(np.array(a)).to(dev).requires_grad_(requires_grad), tree)


def params_to_numpy(params: Any) -> Any:
    """The port's parameter tree -> the same tree of NumPy arrays."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)
