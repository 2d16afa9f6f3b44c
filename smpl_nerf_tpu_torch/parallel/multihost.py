"""Batch rows and host trees across processes (counterpart of
smpl_nerf_tpu/parallel/multihost.py).

JAX assembles a global array from each process's rows
(`make_array_from_process_local_data`); in the port each process keeps its
rows and the global batch exists only as the sum of the ranks' work:

  * `local_row_range`: the [lo, hi) rows of a global batch that this rank's
    data index owns. Ranks that differ only in their model index (the model
    axis replicates rows) own the same span, which JAX dedupes from its
    device map (its `local_row_range` over a 2-D mesh).
  * `make_global_batch`: this rank's rows of a host batch, on its device.
  * `put_replicated`: every tensor of a tree takes rank 0's values (a
    broadcast), so that no rank trains from weights of its own;
    `put_tree` then keeps each rank's slice of the leaves that `dims` names
    (parallel/tp.py's width shards).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from smpl_nerf_tpu_torch.parallel.mesh import Mesh


def comm_device() -> torch.device:
    """Where this process's collectives keep their tensors: its card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def local_row_range(mesh: Mesh, n_rows: int) -> Tuple[int, int]:
    """[lo, hi) rows of an n_rows global batch that this rank's data index owns.

    Rows split into `mesh.data` contiguous equal blocks in data-index order;
    n_rows must divide (pad_to_multiple pads every batch the solver cuts)."""
    if n_rows % mesh.data:
        raise ValueError(f"{n_rows} rows do not split over a {mesh.data}-way data axis "
                         "(pad them with mesh.pad_to_multiple)")
    per = n_rows // mesh.data
    return mesh.data_index * per, (mesh.data_index + 1) * per


def make_global_batch(batch_np: Dict[str, np.ndarray], mesh: Mesh, device="cpu") -> dict:
    """This rank's rows of a host batch (the FULL rows, identical on every
    rank: the index draw is seeded the same everywhere), on `device`."""
    out = {}
    for k, v in batch_np.items():
        lo, hi = local_row_range(mesh, v.shape[0])
        out[k] = torch.as_tensor(np.ascontiguousarray(v[lo:hi]), device=device)
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)


def put_replicated(tree, mesh: Mesh):
    """Every tensor of a nested dict takes rank 0's values, in place.

    Without a process group the tree is returned as it is."""
    if not mesh.distributed:
        return tree
    dev = comm_device()
    for leaf in _leaves(tree):
        buf = leaf.detach().to(dev).contiguous()
        dist.broadcast(buf, src=0)
        with torch.no_grad():
            leaf.copy_(buf)
    return tree


def put_tree(tree, mesh: Mesh, dims: Optional[Mapping] = None):
    """rank 0's tree, with the leaves that `dims` maps to a dimension cut to
    this rank's slice along it over the model axis (new tensors); the other
    leaves replicated."""
    from smpl_nerf_tpu_torch.parallel import tp
    put_replicated(tree, mesh)
    return tp.shard_tree(tree, mesh, dims)


def from_rank0(value: float, mesh: Mesh) -> float:
    """Rank 0's number on every rank (as it is without a process group)."""
    if not mesh.distributed:
        return value
    t = torch.tensor([float(value)], dtype=torch.float64, device=comm_device())
    dist.broadcast(t, src=0)
    return float(t.item())


def all_reduce_flat(tensors, group) -> None:
    """Sum a list of same-dtype tensors over `group` in place, in one call."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole batch from every rank's rows, in data-index order (this rank's
    rows as they are without a process group)."""
    if not mesh.distributed:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(parts, t.contiguous(), group=mesh.data_group)
    return torch.cat(parts, 0)
