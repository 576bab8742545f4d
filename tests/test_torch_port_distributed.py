"""Port parity, data parallelism across processes: the mirror of
tests/test_distributed.py on `torch.distributed` with gloo. Two processes
with two CPU shards each make a 4-shard mesh (`initialize_distributed`, then
`make_mesh(4, device="cpu")`); each checks its sharded loss and grad norm
(`Trainer.shard_grads`: local shards, then one all_reduce) against the
full-batch single-process result, at tests/test_distributed.py:80-81's bars:
loss within 1e-5, grad norm within 1e-4 max(1, |g|). The workers import no
JAX; the parent checks that both exited cleanly."""

import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent("""
    import sys

    import numpy as np
    import torch

    from bcnf_tpu_torch.bridge import map_tree, tree_leaves
    from bcnf_tpu_torch.models import (ConcatenateCondition, CondRealNVP, FeatureNetworkStack,
                                       FullyConnectedFeatureNetwork)
    from bcnf_tpu_torch.parallel import initialize_distributed, is_host_zero, make_mesh, replicate_trainable
    from bcnf_tpu_torch.train import Trainer
    from bcnf_tpu_torch.utils.misc import inn_nll_loss

    coordinator, pid = sys.argv[1], int(sys.argv[2])
    initialize_distributed(coordinator, 2, pid, device="cpu")
    mesh = make_mesh(4, device="cpu")  # two local shards in each of two processes
    assert (mesh.size, mesh.process_count, mesh.local_shards) == (4, 2, [2 * pid, 2 * pid + 1]), mesh
    assert torch.distributed.get_backend() == "gloo"
    assert is_host_zero() == (pid == 0)

    stack = FeatureNetworkStack([ConcatenateCondition(None, 4), FullyConnectedFeatureNetwork(sizes=[4, 16, 8])])
    model = CondRealNVP(size=3, nested_sizes=[24], n_blocks=3, n_conditions=8, feature_network_stack=stack,
                        act_norm=True, random_state=0)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")

    rng = np.random.default_rng(0)  # identical data in both processes
    B = 32
    y = torch.from_numpy(rng.normal(size=(B, 3)).astype(np.float32))
    cond = torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32))
    config = {"global": {"dtype": "float32"}, "optimizer": {"type": "Adam", "kwargs": {"lr": 1e-3}},
              "lr_scheduler": {"type": "ReduceLROnPlateau", "kwargs": {}},
              "training": {"validation_split": 0.0, "val_loss_window_size": 1, "val_loss_patience": None,
                           "val_loss_tolerance_mode": "rel", "val_loss_tolerance": 1e-3, "batch_size": B,
                           "n_epochs": 1}}

    def trainable():
        return map_tree(lambda t: t.detach().clone().requires_grad_(True), params)

    # (a) sharded over the 4-shard mesh of two processes
    trainer = Trainer(config, data=(y.numpy(), [cond.numpy()]), mesh=mesh)
    replicas = replicate_trainable(trainer.mesh, trainable())
    metrics = trainer.shard_grads(model, replicas, y, [cond], trainer.shard_generators(0))
    loss_g = float(metrics[0])
    gnorm_g = float(torch.sqrt(sum(torch.sum(p.grad ** 2) for p in tree_leaves(replicas[0]))))

    # (b) local unsharded full batch
    p = trainable()
    z, ld = model.forward(p, y, cond)
    loss = inn_nll_loss(z, ld)
    loss.backward()
    loss_l = float(loss)
    gnorm_l = float(torch.sqrt(sum(torch.sum(t.grad ** 2) for t in tree_leaves(p) if t.grad is not None)))

    dl = abs(loss_g - loss_l)
    dg = abs(gnorm_g - gnorm_l)
    assert dl < 1e-5, f"loss mismatch: {dl}"
    assert dg < 1e-4 * max(1.0, gnorm_l), f"grad-norm mismatch: {dg}"
    torch.distributed.destroy_process_group()
    print(f"proc {pid}: OK loss={loss_g:.6f} dl={dl:.2e} dg={dg:.2e}", flush=True)
""")


def test_two_process_distributed_training_step(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"

    worker_path = tmp_path / "worker.py"
    worker_path.write_text(WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker_path), coordinator, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "OK" in out
