"""The device mesh on torch.distributed (counterpart of smpl_nerf_tpu/parallel/mesh.py).

Rays are embarrassingly parallel and the nets are small, so the layout is the
JAX package's: batch rows split over the mesh's 'data' axis, parameters
replicated (or width-split over 'model' under --tensor_parallel,
parallel/tp.py), and the gradients summed over 'data'.

Departures from the JAX package, where one controller drives every device:

  * One process per device. A mesh is a `torch.distributed.device_mesh.DeviceMesh`
    of shape (data, model), dim names ('data', 'model'), over the world's ranks;
    rank r sits at (r // model, r % model), as JAX's device array is filled.
    Each process holds its own rows of a batch (`shard_batch`), not a view of
    a global array.
  * The backend is NCCL for a CUDA device and gloo for the CPU (the tests),
    never the other one, and there is no fallback from one to the other.
  * `make_mesh('')` puts the whole world on the data axis, as JAX puts all
    devices there. A mesh larger than the world raises with JAX's message;
    so does a smaller one, where JAX would take the first n devices: a rank
    outside the mesh would have nothing to do.
  * World size 1 without a process group is the single-device code, with no
    collective at all (`Mesh.device_mesh` is None). With a group, even one of
    size 1, every collective of the data-parallel step runs.
  * `init_distributed` (--multihost=1) initialises the group from the
    environment torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT,
    LOCAL_RANK -> cuda:LOCAL_RANK); it replaces `jax.distributed.initialize()`.

`is_distributed`, `rank` and `world_size` are the one place the port asks
whether a process group is up and where this process sits in it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A (data, model) layout of the world's ranks and this rank's place in it.

    `device_mesh` is None for the single-device mesh (no process group) and
    for a bare layout built to ask where another rank's rows lie."""
    data: int = 1
    model: int = 1
    rank: int = 0
    device_mesh: Optional[object] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """True when the mesh spans a process group (its collectives run)."""
        return self.device_mesh is not None

    @property
    def data_group(self):
        """The ranks that share this rank's model index (gradients sum here)."""
        return self.device_mesh.get_group("data") if self.distributed else None

    @property
    def model_group(self):
        """The ranks that share this rank's rows (tensor, sample, pipeline and
        expert parallelism run here)."""
        return self.device_mesh.get_group("model") if self.distributed else None

    def axis(self, name: str):
        """(group or None, this rank's index along it, its size) of the 'data'
        or 'model' axis; an axis of more than one rank needs a process group."""
        if name not in ("data", "model"):
            raise ValueError(f"unknown mesh axis {name!r}")
        n = self.shape[name]
        if n > 1 and not self.distributed:
            raise ValueError(f"a {n}-way '{name}' axis needs a process group")
        if name == "model":
            return self.model_group, self.model_index, n
        return self.data_group, self.data_index, n


def parse_mesh_shape(mesh_shape: str, world_size: int) -> Tuple[int, int]:
    """'' -> (world, 1); '8' -> (8, 1); '4,2' -> (4, 2), as JAX's make_mesh parses."""
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split(","))
        if len(dims) == 1:
            dims = (dims[0], 1)
        if len(dims) != 2:
            raise ValueError(f"mesh_shape {mesh_shape!r}: give 'data' or 'data,model'")
        return dims
    return (world_size, 1)


def is_distributed() -> bool:
    """True when a process group is up (one process runs per device)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the world (0 without a process group)."""
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    """The number of processes in the world (1 without a process group)."""
    return dist.get_world_size() if is_distributed() else 1


def _backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_backend(device) -> None:
    """The group's backend must be the device's: NCCL for CUDA, gloo for the CPU."""
    want = _backend_for(device)
    have = dist.get_backend()
    if have != want:
        raise RuntimeError(f"the process group runs {have}, but a {torch.device(device).type} "
                           f"mesh needs {want} (no fallback from one to the other)")


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(mesh_shape: str = "", device="cpu") -> Mesh:
    """The ('data', 'model') mesh over the world's ranks.

    mesh_shape: '' = the whole world on the data axis; '8' = 8-way data;
    '4,2' = 4-way data x 2-way model. Without a process group the world is one
    process and the mesh has no collectives. The mesh must hold every rank:
    a larger one raises 'mesh (d, m) needs n devices, have k', as JAX does,
    and so does a smaller one.
    """
    n_world = world_size()
    dims = parse_mesh_shape(mesh_shape, n_world)
    n = dims[0] * dims[1]
    if n > n_world:
        raise ValueError(f"mesh {dims} needs {n} devices, have {n_world}")
    if n < n_world:
        raise ValueError(f"mesh {dims} holds {n} of the world's {n_world} processes; "
                         "one process runs per device, so the mesh must hold them all")
    if not is_distributed():
        return Mesh(dims[0], dims[1])
    device_type = torch.device(device).type
    check_backend(device)
    key = (dims, device_type)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh
        _MESHES[key] = Mesh(dims[0], dims[1], rank(),
                            init_device_mesh(device_type, dims,
                                             mesh_dim_names=("data", "model")))
    return _MESHES[key]


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k >= n (batch padding so shards divide evenly)."""
    return ((n + k - 1) // k) * k


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of every batch array along the data axis.

    '_itable' keys (whole per-image tables the pipeline indexes itself,
    solver.gather_batch) stay whole: their leading axis is images, not rays."""
    from smpl_nerf_tpu_torch.parallel.multihost import local_row_range
    out = {}
    for k, v in batch.items():
        if k.endswith("_itable"):
            out[k] = v
            continue
        lo, hi = local_row_range(mesh, v.shape[0])
        out[k] = v[lo:hi]
    return out


def init_distributed(device="cuda", init_method: str = "env://", rank: Optional[int] = None,
                     world: Optional[int] = None) -> torch.device:
    """Initialise the process group; returns this process's device.

    By default from torchrun's environment (--multihost=1): RANK and
    WORLD_SIZE name this process, MASTER_ADDR / MASTER_PORT the rendezvous.
    `init_method`, `rank` and `world` replace them (a file:// rendezvous
    needs no port). A CUDA device becomes cuda:LOCAL_RANK (the rank when
    LOCAL_RANK is unset). The backend follows the device: NCCL for CUDA,
    gloo for the CPU. A group that is already up (a caller that initialised
    it) is kept."""
    if is_distributed():
        rank = dist.get_rank()
    elif rank is None:
        rank = int(os.environ["RANK"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    if not is_distributed():
        dist.init_process_group(_backend_for(dev), init_method=init_method, rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]) if world is None
                                else world)
    check_backend(dev)
    return dev


def destroy() -> None:
    """Tear the process group down, with the meshes made over it."""
    _MESHES.clear()
    if is_distributed():
        dist.destroy_process_group()
