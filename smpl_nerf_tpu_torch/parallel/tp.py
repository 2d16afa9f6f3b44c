"""Tensor parallelism: width-split the NeRF MLPs over the mesh's 'model' axis
(counterpart of smpl_nerf_tpu/parallel/tp.py).

The trunk layers of `model_coarse` / `model_fine` (the names that start with
`_TRUNK_PREFIXES`, as in the JAX package) are stored column-sharded: a torch
`Linear.weight` is [out, in], so rank j of the model group keeps rows
[j * out / m, (j + 1) * out / m) of the weight and of the bias. A layer whose
width does not divide stays whole, and so do the sigma / rgb heads and every
other model.

Where JAX's SPMD partitioner propagates the activation shardings, the port
says what moves. `place_params_tp` swaps each split layer for a
`ColumnParallelDense` (Megatron's column-parallel layer), so that the nets and
the fused ops call its methods and know nothing of the split:

  * forward: each rank computes its columns of the layer's output and an
    autograd-aware all-gather rebuilds the whole activation before the next
    layer (`gather_from_model`; its backward keeps the rank's own columns);
  * the layer's input passes through `copy_to_model` (identity forward,
    all-reduce of the input's gradient over the model group backward),
    since each rank's columns see only their part of that gradient;
  * the fused kernels (B, C and D) take the whole net, as a Pallas call
    takes replicated operands under JAX's partitioner: its `full_weight` /
    `full_bias` gather the shards (autograd-aware again), and the backward of
    that gather hands each rank its slice of the kernel's dW.

Adam and --param_ema are elementwise, so they run on the shards. Enable with
--tensor_parallel=1 and a mesh whose model axis is > 1 (e.g. --mesh_shape=4,2).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist

from smpl_nerf_tpu_torch.models.render_ray_net import Dense

TP_MODELS = ("model_coarse", "model_fine")
_TRUNK_PREFIXES = ("positions_pose_input", "positional_net", "additional_linear_layer",
                   "directional_input", "directional_net")


def shard_dim(model_name: str, key: str, shape, n_model: int) -> Optional[int]:
    """The dim a parameter is split along over an n_model axis (0, the output
    rows), or None when it stays whole: JAX's prefix rule, `tp.py:38-48`."""
    if n_model <= 1 or model_name not in TP_MODELS or "." not in key:
        return None
    layer, leaf = key.rsplit(".", 1)
    if not layer.startswith(_TRUNK_PREFIXES):
        return None                              # sigma / rgb heads stay whole
    if leaf == "weight" and len(shape) == 2 and shape[0] % n_model == 0:
        return 0
    if leaf == "bias" and len(shape) == 1 and shape[0] % n_model == 0:
        return 0
    return None


def tp_param_shardings(models: Mapping[str, torch.nn.Module],
                       mesh) -> Dict[str, Dict[str, Optional[int]]]:
    """{model: {parameter: split dim or None}} for every parameter of `models`."""
    n_model = int(mesh.model)
    return {name: {key: shard_dim(name, key, tuple(p.shape), n_model)
                   for key, p in m.named_parameters()}
            for name, m in models.items()}


def _slice(t: torch.Tensor, dim: int, index: int, n: int) -> torch.Tensor:
    per = t.shape[dim] // n
    return t.narrow(dim, index * per, per)


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    wire = t.float() if t.dtype not in (torch.float32, torch.float64) else t
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire.contiguous(), group=group)
    return torch.cat(parts, dim).to(t.dtype)


class _GatherFromModel(torch.autograd.Function):
    """All-gather along `dim` over the model group; backward: this rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return _slice(g, ctx.dim, dist.get_rank(ctx.group), n).contiguous(), None, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward: the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        wire = g.float().contiguous()
        dist.all_reduce(wire, group=ctx.group)
        return wire.to(g.dtype), None


def gather_from_model(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    return _GatherFromModel.apply(t, dim % t.dim(), group)


def copy_to_model(t: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(t, group)


class ColumnParallelDense(Dense):
    """A trunk layer that keeps its rank's rows [j * out / m, (j + 1) * out / m)
    of the weight and the bias; `group` is the model group it is split over."""

    group = None

    def dense(self, h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """This rank's output columns, gathered whole over the model group."""
        y = super().dense(copy_to_model(h, self.group), compute_dtype)
        return gather_from_model(y, self.group)

    def full_weight(self) -> torch.Tensor:
        return gather_from_model(self.weight, self.group, 0)

    def full_bias(self) -> torch.Tensor:
        return gather_from_model(self.bias, self.group, 0)


def place_params_tp(models: Mapping[str, torch.nn.Module], mesh) -> Dict[str, Dict[str, int]]:
    """Swap every split trunk layer for a `ColumnParallelDense` that holds this
    rank's shard, in place.

    The layers keep their names, so the state-dict keys stay. Returns
    {model: {parameter: 0}} for the split parameters (what `gather_tree` /
    `shard_tree` take). Build the optimizer after this call."""
    if mesh.model > 1 and not mesh.distributed:
        raise ValueError(f"a {mesh.model}-way model axis needs a process group")
    dims = tp_param_shardings(models, mesh)
    split: Dict[str, Dict[str, int]] = {}
    for name, model in models.items():
        for mod_name, layer in list(model.named_modules()):
            if not isinstance(layer, Dense) or dims[name].get(f"{mod_name}.weight") is None:
                continue
            weight, bias = (_slice(p.detach(), 0, mesh.model_index, mesh.model)
                            for p in (layer.weight, layer.bias))
            shard = torch.nn.utils.skip_init(ColumnParallelDense, layer.in_features,
                                             weight.shape[0], device=weight.device,
                                             dtype=weight.dtype)
            with torch.no_grad():
                shard.weight.copy_(weight)
                shard.bias.copy_(bias)
            shard.group = mesh.model_group
            parent, _, child = mod_name.rpartition(".")
            setattr(model.get_submodule(parent), child, shard)
            split.setdefault(name, {}).update({f"{mod_name}.weight": 0, f"{mod_name}.bias": 0})
    return split


def _map(tree, dims, fn):
    if isinstance(tree, torch.Tensor):
        return tree if dims is None else fn(tree, dims)
    if isinstance(tree, Mapping):
        return {k: _map(v, dims.get(k) if isinstance(dims, Mapping) else None, fn)
                for k, v in tree.items()}
    return tree


def gather_tree(tree, mesh, dims: Optional[Mapping]):
    """The whole tensors of a tree whose leaves `dims` names are shards: a
    collective over the model group on every rank of it."""
    if not dims or mesh.model <= 1:
        return tree
    return _map(tree, dims, lambda t, d: _gather(t.detach(), d, mesh.model_group))


def shard_tree(tree, mesh, dims: Optional[Mapping]):
    """This rank's slices of the leaves that `dims` names (the inverse of gather_tree)."""
    if not dims or mesh.model <= 1:
        return tree
    return _map(tree, dims, lambda t, d: _slice(t, d, mesh.model_index, mesh.model).clone())
