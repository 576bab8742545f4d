"""The published training step in plain PyTorch: the NLL of a batch through
the encoder and the flow with dropout, its gradients by autograd,
global-norm clipping of all of them at once (g * max / ||g|| where ||g|| is
at least max, no epsilon), then Adam (b1 0.9, b2 0.999, eps 1e-8 outside
the square root) on every leaf, a leaf without a gradient taking zeros."""

from __future__ import annotations

import math

import torch

from .model import Flow, encode, float32_products, nll


def leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def rebuild(tree, flat: list[torch.Tensor]):
    """`tree`'s structure with its leaves taken from `flat` in order."""
    it = iter(flat)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return next(it)

    return walk(tree)


def loss(run_config: dict, params: dict, y: torch.Tensor, trajectories: torch.Tensor,
         generator: torch.Generator) -> torch.Tensor:
    kw = run_config["model"]["kwargs"]
    h = encode(run_config["feature_networks"], params["features"], trajectories, generator)
    flow = Flow(params, int(kw["size"]), float(kw.get("dropout", 0.0)))
    # the mixes are fixed: no gradient reaches them
    flow.ortho = flow.ortho.detach()
    z, log_det = flow.forward(y, flow.projections(h), generator)
    return nll(z, log_det)


def train_steps(run_config: dict, params0: dict, batches: list[tuple[torch.Tensor, torch.Tensor]],
                generator: torch.Generator, max_grad_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8) -> tuple[list[float], list[torch.Tensor], list[torch.Tensor]]:
    """Steps over `batches` from `params0`, dropout drawn from `generator`:
    (each step's loss, the first step's clipped gradient a leaf, each leaf's
    change after the last step). Leaves in `leaves(params0)` order."""
    lr = float(run_config["optimizer"]["kwargs"]["lr"])
    p = [t.detach().clone().requires_grad_(True) for t in leaves(params0)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    losses, first = [], []
    with float32_products():
        for step, (y, traj) in enumerate(batches, start=1):
            value = loss(run_config, rebuild(params0, p), y, traj, generator)
            grads = torch.autograd.grad(value, p, allow_unused=True)
            g = [torch.zeros_like(t) if gi is None else gi for t, gi in zip(p, grads)]
            norm = torch.sqrt(sum(torch.sum(gi * gi) for gi in g))
            if float(norm) >= max_grad_norm:
                g = [gi / norm * max_grad_norm for gi in g]
            if step == 1:
                first = [gi.detach().clone() for gi in g]
            losses.append(float(value.detach()))
            with torch.no_grad():
                for t, gi, mi, vi in zip(p, g, m, v):
                    mi.mul_(b1).add_(gi, alpha=1 - b1)
                    vi.mul_(b2).addcmul_(gi, gi, value=1 - b2)
                    denom = (vi / (1 - b2 ** step)).sqrt_().add_(eps)
                    t.sub_(lr / (1 - b1 ** step) * mi / denom)
    change = [(t.detach() - t0) for t, t0 in zip(p, leaves(params0))]
    return losses, first, change


def norm_gap(got: list[float], ref: list[float], counted: list[bool] | None = None) -> float:
    """The worst leaf's gap between two norms, |got - ref|, over the larger
    of the reference's norm of that leaf and the median leaf's; leaves not
    `counted` are left out."""
    keep = [i for i in range(len(ref)) if counted is None or counted[i]]
    if not keep:
        return math.inf
    med = sorted(ref[i] for i in keep)[len(keep) // 2]
    return max(abs(got[i] - ref[i]) / max(ref[i], med) for i in keep)
