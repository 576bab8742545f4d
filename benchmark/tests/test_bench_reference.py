"""The plain reference against the port's plain path, at tiny sizes on the
CPU: the encoders, the flow both ways, and three training steps with
dropout, clipping and Adam."""

import copy

import pytest
import torch

import tiny
from benchmark import harness
from benchmark.reference import model as ref
from benchmark.reference.train import leaves, train_steps


def built(encoder=None, seed=11):
    cell = tiny.cell("sample", encoder)
    model = harness.build_model(cell)
    return cell, model, harness.make_weights(model, seed, torch.device("cpu"))


def close(a, b, tol=1e-6):
    return float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("encoder", [None, tiny.DUAL_ENCODER], ids=["lstm", "dual_lstm"])
def test_encoder_and_flow_both_ways(encoder):
    cell, model, params = built(encoder)
    traj = torch.randn(4, 6, 3, generator=torch.Generator().manual_seed(1))
    h = model.encode(params, [traj])
    h_ref = ref.encode(cell.run_config["feature_networks"], params["features"], traj)
    assert close(h, h_ref)
    flow = ref.Flow(params, 5)
    projs = flow.projections(h_ref)
    z = torch.randn(7, 4, 5, generator=torch.Generator().manual_seed(2))
    x = model.inverse_given_h(params, z, h)
    rows = torch.arange(28) % 4
    x_ref = flow.inverse(z.reshape(-1, 5), [p[rows] for p in projs])
    assert close(x.reshape(-1, 5), x_ref)
    z_back, ld = model.forward(params, x, traj)
    z_ref, ld_ref = flow.forward(x_ref, [p[rows] for p in projs])
    assert close(z_back.reshape(-1, 5), z_ref, 1e-5) and close(ld.reshape(-1), ld_ref, 1e-5)
    assert close(z_ref, z.reshape(-1, 5), 1e-4)


def test_three_training_steps_with_dropout():
    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.train.optim import make_optimizer
    from bcnf_tpu_torch.train.trainer import hybrid_loss

    cell, model, weights = built()
    rc = cell.run_config
    gen_data = torch.Generator().manual_seed(3)
    batches = [(torch.randn(16, 5, generator=gen_data), torch.randn(16, 6, 3, generator=gen_data)) for _ in range(3)]
    params = map_tree(lambda t: t.detach().clone().requires_grad_(True), weights)
    opt = make_optimizer("Adam", lr=rc["optimizer"]["kwargs"]["lr"]).init(params)
    gen = torch.Generator().manual_seed(4)
    losses = []
    for y, traj in batches:
        for p in tree_leaves(params):
            p.grad = None
        loss = hybrid_loss(model, params, y, [traj], gen, 0.0)[0]
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    losses_r, _, change_r = train_steps(rc, weights, batches, torch.Generator().manual_seed(4))
    assert losses == pytest.approx(losses_r, rel=1e-6)
    for p, p0, c in zip(tree_leaves(params), leaves(weights), change_r):
        assert close(p.detach() - p0, c, 1e-5)
    # dropout drawn: the same step without the generator differs
    no_drop, _, _ = train_steps(copy.deepcopy(rc) | {"model": {"kwargs": rc["model"]["kwargs"] | {"dropout": 0.0}}},
                                weights, batches[:1], torch.Generator().manual_seed(4))
    assert no_drop[0] != pytest.approx(losses_r[0], rel=1e-6)
