"""Data parallelism on `torch.distributed` (port of `bcnf_tpu/parallel/mesh.py`).

The JAX package's model, kept: one process drives its local devices, and
processes join through a coordinator (`initialize_distributed`). A `Mesh`
is this process's local devices, the process group (None for one process)
and `size`, the local devices times the processes: the JAX package's
``--dp-devices N`` is that global size. Shard ``i`` is process rank times
the local count plus the local index, `jax.devices()`' global order, so
every shard takes the rows it takes in JAX.

- Parameters are replicated: one copy per local shard (`replicate`).
- A batch is sharded along axis 0: each local shard gets its rows on its
  device (`shard_batch`); the rows must divide evenly, as a JAX batch
  sharding requires.
- Grads and metrics reduce with `pmean`, the counterpart of
  `jax.lax.pmean`: the local shards' tensors are summed onto the first
  local device, all-reduced over the group (NCCL on CUDA, gloo on the CPU)
  and divided by `size`. `shard_backward` is a training step's shards:
  each one's forward and backward, then the reduce.
- The single-device paths run on a mesh of one shard (`Mesh([device])`),
  where a reduce is the identity and a shard is the whole batch: one code
  path, sharded or not.

Each shard's forward and backward run the model's kernels on the shard's
rows on its device, as the JAX package's `shard_map` keeps its Pallas
kernels inside, one launch per chip (`bcnf_tpu/models/cnf.py` `spmd_local`).
On a host without a card, ``device="cpu"`` makes ``n`` logical shards on
the CPU, the counterpart of ``--xla_force_host_platform_device_count``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from bcnf_tpu_torch.bridge import map_tree, tree_leaves
from bcnf_tpu_torch.utils.misc import resolve_device


class Mesh:
    """A 1-D data mesh: `devices`, this process's local devices (a device
    may appear more than once: each entry is a shard); `group`, the process
    group its reduces run over (None: this process alone, no collective);
    `size`, the shards of all processes."""

    def __init__(self, devices: Sequence[str | torch.device], group: Any = None) -> None:
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        self.process_count = dist.get_world_size(group) if group is not None else 1
        self.process_index = dist.get_rank(group) if group is not None else 0
        self.size = len(self.devices) * self.process_count
        # the global indices of this process's shards
        self.local_shards = [self.process_index * len(self.devices) + i for i in range(len(self.devices))]

    def __repr__(self) -> str:
        return f"Mesh(devices={self.devices}, size={self.size}, process {self.process_index}/{self.process_count})"


def ensure_cpu_devices(n: int) -> None:
    """A no-op, kept for the JAX package's name. JAX fixes its CPU device
    count when its backend starts; torch needs nothing: `make_mesh(n,
    device="cpu")` makes `n` logical shards on the CPU at any time."""


def make_mesh(n_devices: int | None = None, device: str | torch.device | None = None) -> Mesh:
    """A 1-D data mesh of `n_devices` shards over all processes (default: every
    visible card of every process). On CUDA (the default; raises without a
    GPU) each process takes its first `n_devices / processes` visible cards,
    and raises when fewer are visible: silently shrinking the mesh hides a
    misconfiguration. With ``device="cpu"``, `n_devices / processes` logical
    shards on the CPU."""
    dev = resolve_device(device)
    group = dist.group.WORLD if dist.is_initialized() else None
    world = dist.get_world_size() if group is not None else 1
    visible = torch.cuda.device_count() if dev.type == "cuda" else None
    if n_devices is None:
        n_devices = (visible or 1) * world
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"a {n_devices}-device mesh does not divide over {world} process(es)")
    n_local = n_devices // world
    if dev.type == "cuda":
        if visible < n_local:
            devices = [torch.device("cuda", i) for i in range(visible)]
            raise ValueError(
                f"Requested a {n_devices}-device mesh but only {visible * world} device(s) are visible: "
                f"{devices}. On a host without enough cards pass device='cpu' (--device cpu) for "
                f"logical CPU shards."
            )
        devices = [torch.device("cuda", i) for i in range(n_local)]
    else:
        devices = [dev] * n_local
    return Mesh(devices, group)


def make_2d_mesh(dp: int, mp: int, device: str | torch.device | None = None) -> list[list[torch.device]]:
    """The (data, model) grid of the first `dp * mp` devices, row-major, as
    the JAX package builds it (the port shards no parameters over it)."""
    dev = resolve_device(device)
    n = dp * mp
    if dev.type == "cuda":
        if torch.cuda.device_count() < n:
            raise ValueError(f"Requested a {dp}x{mp} mesh but only {torch.cuda.device_count()} device(s) are visible")
        flat = [torch.device("cuda", i) for i in range(n)]
    else:
        flat = [dev] * n
    return [flat[r * mp:(r + 1) * mp] for r in range(dp)]


def batch_sharding(mesh: Mesh, n_rows: int) -> list[slice]:
    """Each local shard's rows of a batch of `n_rows` (the counterpart of a
    JAX batch sharding over the `data` axis); raises unless the rows divide
    evenly over the mesh."""
    if n_rows % mesh.size:
        raise ValueError(f"a batch of {n_rows} rows does not shard evenly over a {mesh.size}-device mesh")
    per = n_rows // mesh.size
    return [slice(i * per, (i + 1) * per) for i in mesh.local_shards]


def replicated(mesh: Mesh) -> list[slice]:
    """Each local shard's part of a replicated value: the whole."""
    return [slice(None)] * len(mesh.devices)


def _tensor(x: Any) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def shard_batch(mesh: Mesh, tree: Any) -> list[Any]:
    """Every leaf's axis-0 slice for each local shard, on the shard's device:
    a list with one tree per local shard (on one shard on the leaves' own
    device, views of the whole). NumPy leaves become tensors."""
    leaves = list(tree_leaves(tree))
    slices = batch_sharding(mesh, len(leaves[0]))
    return [map_tree(lambda x, s=s, d=d: _tensor(x)[s].to(d), tree) for s, d in zip(slices, mesh.devices)]


def replicate(mesh: Mesh, tree: Any) -> list[Any]:
    """One copy of the tree per local shard, on the shard's device (a shard
    on the tree's own device shares its tensors; None leaves stay None)."""
    return [map_tree(lambda x, d=d: None if x is None else _tensor(x).to(d), tree) for d in mesh.devices]


def replicate_trainable(mesh: Mesh, params: Any) -> list[Any]:
    """The replicas a data-parallel step trains: `params` itself (leaves that
    require grad; the optimizer updates it) and a trainable copy on each
    other local shard's device."""
    return [params] + [map_tree(lambda t: t.detach().clone().requires_grad_(True), r)
                       for r in replicate(mesh, params)[1:]]


def even_batch(mesh: Mesh, batch: int) -> int:
    """`batch` rounded down to a multiple of the mesh size, so that every
    shard takes as many rows and a mean of the shards' means is the batch's
    (`bcnf_tpu/__main__.py:269-272`); raises when no row is left a shard."""
    if batch < mesh.size:
        raise ValueError(f"a batch of {batch} rows gives no row to each of {mesh.size} shards")
    return batch - batch % mesh.size


def _alone(mesh: Mesh) -> bool:
    """One shard and no process group: a reduce is the identity."""
    return len(mesh.devices) == 1 and mesh.group is None


def pmean(mesh: Mesh, per_shard: Sequence[Sequence[torch.Tensor]]) -> list[torch.Tensor]:
    """The mean over all `mesh.size` shards of each tensor, the counterpart
    of `jax.lax.pmean`: `per_shard[i]` is local shard i's list of tensors
    (the same shapes in every shard). The local shards' tensors are
    flattened into one buffer each and summed onto the first local device,
    the sum is all-reduced over the group in one collective, then divided by
    `mesh.size`. Returns the means on the first local device (a mesh of one
    shard returns its tensors as they are: no buffer, no copy)."""
    if _alone(mesh):
        return list(per_shard[0])
    d0 = mesh.devices[0]
    shapes = [t.shape for t in per_shard[0]]
    total = None
    for tensors in per_shard:
        flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(d0)
        total = flat if total is None else total + flat
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    total /= mesh.size
    return [t.view(shape) for t, shape in zip(torch.split(total, [s.numel() for s in shapes]), shapes)]


def pmean_grads(mesh: Mesh, replicas: Sequence[Any]) -> None:
    """The local replicas' grads (a leaf without one counts as zero) through
    `pmean`, into the first replica's `.grad` (on one shard they are there
    already)."""
    if _alone(mesh):
        return
    leaves = [list(tree_leaves(r)) for r in replicas]
    grads = pmean(mesh, [[p.grad if p.grad is not None else torch.zeros_like(p) for p in ls] for ls in leaves])
    for p, g in zip(leaves[0], grads):
        p.grad = g


def sync_replicas(replicas: Sequence[Any]) -> None:
    """Copy the first replica's leaves into every other replica's, in place."""
    with torch.no_grad():
        for replica in replicas[1:]:
            for dst, src in zip(tree_leaves(replica), tree_leaves(replicas[0])):
                dst.copy_(src)


def shard_backward(mesh: Mesh, replicas: Sequence[Any], shard_inputs: Iterable[Sequence[Any]],
                   loss: Callable[..., torch.Tensor], precision: str = "highest") -> torch.Tensor:
    """The data-parallel backward of one step, the counterpart of a JAX
    `shard_map` of `value_and_grad` and `pmean`: for each local shard, its
    replica's grads are cleared and ``loss(replica, *inputs)`` (a 1-D
    tensor of metrics, the objective first) runs forward and `backward()`
    at the model's `precision` (`matmul_precision`), `inputs` being the
    shard's entry of `shard_inputs` (read lazily: an iterator may make a
    shard's batch just before its step). The grads and the metrics go
    through `pmean`. Leaves the mean grads in the first replica's `.grad`
    and returns the mean metrics."""
    from bcnf_tpu_torch.models.cnf import matmul_precision

    metrics = []
    for replica, inputs in zip(replicas, shard_inputs):
        for p in tree_leaves(replica):
            p.grad = None
        with matmul_precision(precision):
            m = loss(replica, *inputs)
            m[0].backward()
        metrics.append(m.detach())
    pmean_grads(mesh, replicas)
    return pmean(mesh, [[m] for m in metrics])[0]


def gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The local shards' results joined along `dim` in shard order on the
    first local device. The sharded evaluation paths read every shard from
    one process, as the JAX package's host gather does, so the mesh must be
    this process alone."""
    if mesh.process_count > 1:
        raise ValueError("a sharded result is gathered in one process; a mesh over several processes trains only")
    if len(parts) == 1:
        return parts[0].to(mesh.devices[0])
    return torch.cat([p.to(mesh.devices[0]) for p in parts], dim=dim)


def sample_sharded(mesh: Mesh, model: Any, replicas: Sequence[Any], generator: torch.Generator, n_samples: int,
                   *conditions: Any) -> torch.Tensor:
    """`model.sample` with the condition rows sharded over the mesh and the
    params replicated (`replicas`, one per local shard): z is drawn once for
    all rows from `generator` (`model.draw_z`), as one device draws it, and
    each shard inverts its rows' slice on its device, as JAX's sharded
    `model.sample` draws from one key over the global shape. So the draws are
    one device's; the samples are too where a product over a shard's rows
    rounds as over all rows (the CPU's; cuBLAS may pick another kernel for
    another row count, and the flagship's condition projections then move
    its samples by a few 1e-6 on an H100). On one shard it calls
    `model.sample` itself, so any object with the JAX package's `sample`
    serves the unsharded paths. Returns `(n_samples, N, size)` on the first
    local device, the rows in shard order."""
    if _alone(mesh):
        return model.sample(replicas[0], generator, n_samples, *conditions, device=mesh.devices[0])
    conditions = [c[None] if c.dim() == 1 else c for c in map(_tensor, conditions)]
    z = model.draw_z(generator, n_samples, conditions[0].shape[0])
    slices = batch_sharding(mesh, z.shape[1])
    parts = [model.sample_from_z(replica, z[:, s].contiguous().to(d), *cs)
             for replica, s, d, cs in zip(replicas, slices, mesh.devices, shard_batch(mesh, conditions))]
    return gather(mesh, parts, dim=1)


def pad_to_multiple(arrays: Sequence[np.ndarray], multiple: int) -> tuple[list[np.ndarray], int]:
    """Pad batch axis 0 up to a multiple (for even sharding); returns the
    pad count (a copy of the JAX package's NumPy function)."""
    n = len(arrays[0])
    pad = (-n) % multiple
    if pad == 0:
        return list(arrays), 0
    out = []
    for a in arrays:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths))
    return out, pad


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Join the processes of a multi-process run through the coordinator at
    ``host:port`` (`torch.distributed.init_process_group`, ``tcp://``): NCCL
    for CUDA devices (the default; raises without a GPU), gloo for the CPU.
    A no-op at one process or fewer, so the CLI calls it unconditionally."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator host:port and --process-id")
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                            rank=process_id)


def is_host_zero() -> bool:
    """True in the process that writes files: the only one, or rank 0."""
    return not dist.is_initialized() or dist.get_rank() == 0
