"""Data parallelism: the ranks, each rank's shard of the batch, and the
reductions over the ranks.

Counterpart of the JAX package's ``parallel/mesh.py``.  There, one program
runs over a ``Mesh`` of devices and XLA's SPMD partitioner takes every
batch reduction over the global batch.  Here each rank is a process of a
``torch.distributed`` group (``torchrun``; NCCL on the card, gloo on the
CPU) that holds its own shard of the batch, and the reductions are written
out: the BatchNorm statistics (``nn/layers.py:BatchNorm``), the loss
normalisers (``losses/``), the gradients in one flat bucket and the
metrics (``training/step.py``).  Without a group, or with one rank, every
reduction here is the identity and launches nothing, so that a
one-process run computes bit for bit what it computes without a mesh.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

# batch entries laid out [T, B, ...] (time-major) vs [B, ...]
TIME_MAJOR_KEYS = ("left", "right", "disp_gt", "disp_gt_right", "T_cam",
                   "inv_T")
# a collective that one rank never reaches raises after this long
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place among the ranks: its rank, their number, its
    device and the process group (None in a one-process run)."""
    rank: int
    world: int
    device: torch.device
    group: Optional[Any] = None

    @property
    def active(self) -> bool:
        """Whether reductions cross processes."""
        return self.group is not None and self.world > 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def world_size() -> int:
    """The number of ranks of the default group; 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed(device=None, backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Join the process group that ``torchrun`` describes in ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` -> this rank's
    device.

    The device defaults to the card; a card without an index is
    ``cuda:LOCAL_RANK``.  The backend is NCCL for a card and gloo for the
    CPU unless one is passed (gloo also reduces CUDA tensors, through the
    host).  A failed initialisation raises; nothing falls back to another
    backend.  A group that the process has already joined is used as it
    is."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the port on the CPU")
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment; "
                           f"{', '.join(missing)} not set")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", timeout=timeout,
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            **kwargs)
    return device


def make_data_mesh(global_batch: int, max_ranks: int = -1,
                   device=None) -> DataMesh:
    """The ranks of the default group (one rank without a group).

    ``max_ranks`` is ``TPU.MESH.DATA``: above 0 it must equal the number of
    ranks, and that number must divide ``global_batch``.  JAX's mesh takes
    the largest device count that divides the batch and leaves the other
    devices idle; a torch rank that was launched cannot sit idle, so a
    mismatch is refused."""
    if dist.is_available() and dist.is_initialized():
        rank, world, group = (dist.get_rank(), dist.get_world_size(),
                              dist.group.WORLD)
    else:
        rank, world, group = 0, 1, None
    if max_ranks > 0 and max_ranks != world:
        raise ValueError(f"TPU.MESH.DATA={max_ranks} but {world} rank(s) "
                         "were launched; launch as many ranks as it names, "
                         "or set it to -1")
    if global_batch % world:
        raise ValueError(f"{world} ranks do not divide the global batch of "
                         f"{global_batch}")
    return DataMesh(rank, world,
                    torch.device("cpu" if device is None else device), group)


def _batch_axis(key: str) -> int:
    return 1 if key in TIME_MAJOR_KEYS else 0


def shard_batch(mesh: DataMesh, batch: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """This rank's contiguous slice of a host-global batch (numpy arrays
    or tensors), on dim 1 of the time-major keys and dim 0 of the rest, on
    the mesh's device."""
    out = {}
    for k, v in batch.items():
        axis = _batch_axis(k)
        n = v.shape[axis]
        if n % mesh.world:
            raise ValueError(f"{k}: {mesh.world} ranks do not divide its "
                             f"batch of {n}")
        b = n // mesh.world
        index = (slice(None),) * axis + (slice(mesh.rank * b,
                                               (mesh.rank + 1) * b),)
        out[k] = torch.as_tensor(v[index]).to(mesh.device)
    return out


def shard_batch_multihost(mesh: DataMesh, local_batch: Dict[str, Any]
                          ) -> Dict[str, Any]:
    """The batch this rank's loader built (``num_shards`` = the ranks), as
    it is, once every entry is checked to hold the same number of
    samples."""
    sizes = {k: np.shape(v)[_batch_axis(k)] for k, v in local_batch.items()}
    if len(set(sizes.values())) > 1:
        raise ValueError(f"rank {mesh.rank}: the batch entries disagree on "
                         f"the batch size: {sizes}")
    return local_batch


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum over the ranks of
    the incoming gradients, since the loss is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Optional[DataMesh]
                   ) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks; ``x`` itself without
    crossing ranks."""
    if mesh is None or not mesh.active:
        return x
    return _AllReduceSum.apply(x.contiguous(), mesh.group)


def global_sum(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, outside autograd; ``x`` itself
    without crossing ranks."""
    if mesh is None or not mesh.active:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def global_mean(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """The mean of every element of ``x`` on every rank, the same value on
    each rank, outside autograd (``x.mean()`` without crossing ranks)."""
    if mesh is None or not mesh.active:
        return x.mean()
    total = global_sum(torch.stack([x.detach().sum().float(), torch.tensor(
        float(x.numel()), device=x.device)]), mesh)
    return (total[0] / total[1]).to(x.dtype)


def mean_share(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """This rank's share of the mean of every element of ``x`` on every
    rank: its own sum over the global count, so that the ranks' shares sum
    to the global mean and their gradients to its gradient (``x.mean()``
    without crossing ranks)."""
    if mesh is None or not mesh.active:
        return x.mean()
    count = global_sum(torch.tensor(float(x.numel()), device=x.device), mesh)
    return x.sum() / count


def all_reduce_tree(tree: Dict[str, torch.Tensor],
                    mesh: Optional[DataMesh]) -> Dict[str, torch.Tensor]:
    """Every tensor of a dict of one dtype summed over the ranks, as one
    flat all-reduce (one bucket, not one call a tensor), outside autograd;
    the dict itself without crossing ranks."""
    if mesh is None or not mesh.active or not tree:
        return tree
    names = list(tree)
    with torch.no_grad():
        flat = torch.cat([tree[k].detach().reshape(-1) for k in names])
        dist.all_reduce(flat, group=mesh.group)
        parts = flat.split([tree[k].numel() for k in names])
    return {k: p.view(tree[k].shape) for k, p in zip(names, parts)}


def _tensors(tree, out):
    if torch.is_tensor(tree):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _tensors(v, out)
    return out


def _rebuild(tree, new):
    if torch.is_tensor(tree):
        return next(new)
    if isinstance(tree, dict):
        return {k: _rebuild(v, new) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, new) for v in tree)
    return tree


def broadcast_tree(tree, mesh: Optional[DataMesh], src: int = 0):
    """A nested dict / tuple / list of tensors with every tensor replaced by
    rank ``src``'s, one flat broadcast per dtype; other leaves stay as they
    are.  The tree itself without crossing ranks."""
    if mesh is None or not mesh.active:
        return tree
    leaves = _tensors(tree, [])
    new = [None] * len(leaves)
    with torch.no_grad():
        for dtype in dict.fromkeys(t.dtype for t in leaves):
            idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.broadcast(flat, src=src, group=mesh.group)
            for i, part in zip(idx, flat.split([leaves[i].numel()
                                                for i in idx])):
                new[i] = part.view(leaves[i].shape).clone()
    return _rebuild(tree, iter(new))


def barrier(mesh: Optional[DataMesh]) -> None:
    """Every rank waits here for the others."""
    if mesh is not None and mesh.active:
        dist.barrier(group=mesh.group)
