"""Run directories (counterpart of smpl_nerf_tpu/training/checkpoints.py).

A run directory holds the fully resolved `config.txt`, the dataset's
`create_dataset_config.txt` where the dataset directory has one (the frame
order that serving reads back), and one reference-layout torch state_dict per
model: `model_coarse.pt`, `model_fine.pt`,
`model_warp_field.pt` — exactly what the JAX package's
`checkpoints.export_torch_run` writes next to its msgpack weights — and, for
the SMPL-driven families, `model_smpl_estimator.pt` (the pose table or the
two arm angles) and `model_vertex_embedder.pt`. A training
run also keeps `train_state.pt`, the port's own resume state (optimizer
moments, EMA shadow, raw weights, epoch, best validation loss).

`params_from_jax` carries weights over from a JAX params tree of numpy arrays:
flax Dense `kernel [in, out]` becomes torch `weight [out, in]`, a Conv
`kernel [kh, kw, in, out]` (HWIO) becomes `weight [out, in, kh, kw]` (OIHW),
BatchNorm's `scale` / `bias` become `weight` / `bias` and its `batch_stats`
`mean` / `var` the buffers `running_mean` / `running_var`; the flax names
`positional_net_{i}` / `directional_net_0` / `vertices_net_{i}` become
`positional_net.{i}` / `directional_net.0` / `vertices_net.{i}` (a SIREN net
has RenderRayNet's names), while GridNerf's Dense layers (`trunk_{i}`,
`trunk_out`, `dir_0`) keep theirs; a leaf that is no layer (`arm_angle_l`,
`arm_angle_r`, GridNerf's `grid_{res}` [res, res, res, F]; HashGridNerf, a port-only
net, saves its `hash_table` and bias-free layers under the module's names) and the
`constants` collection (`goal_poses`, a buffer in the port) keep their names.
A flax ConvTranspose kernel needs its own conversion
(`cli/pix2pix.state_dict_from_jax`). The CNN estimator's
`fc1` rows stay in flax's NHWC flatten order, which the port's
`SmplEstimator` flattens in. The estimator's run dir holds its BatchNorm
statistics with its weights (`model_smpl_estimator.pt`).

Across processes (a process group is up): `save_run` and `save_train_state`
are called on EVERY rank. They first rebuild the whole tensors of the
--tensor_parallel shards (`_host_tree`, an all-gather over the model group,
given `dims`: which leaves are shards and along which dim), and only rank 0
writes. `broadcast_file` hands every rank rank 0's bytes of a file, or None
on every rank when rank 0 has none, so that a resume takes the same branch
everywhere before any collective (`load_train_state(data=...)` parses them).
"""
from __future__ import annotations

import io
import os
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from smpl_nerf_tpu_torch import config as config_mod
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod

MODEL_NAMES = ("model_coarse", "model_fine", "model_warp_field", "smpl_estimator",
               "vertex_embedder")
TRAIN_STATE = "train_state.pt"


def _torch_layer_name(flax_name: str) -> str:
    for prefix in ("positional_net_", "directional_net_", "vertices_net_"):
        if flax_name.startswith(prefix):
            return f"{prefix[:-1]}.{flax_name[len(prefix):]}"
    return flax_name


_COLLECTIONS = ("params", "constants", "batch_stats")
# flax leaf name -> torch name, for the layers that are not Dense / Conv
_LEAF_NAMES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
               "var": "running_var"}


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32))


def params_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"model_coarse": {"params": {layer: {"kernel", "bias"}}}, "smpl_estimator":
    {"constants": {"goal_poses": ...}} or {"params": ..., "batch_stats": ...},
    ...} -> state dicts."""
    state_dicts = {}
    for model_name, variables in tree.items():
        collections = ([variables[c] for c in _COLLECTIONS if c in variables]
                       if any(c in variables for c in _COLLECTIONS) else [variables])
        sd = {}
        for layers in collections:
            for layer, leaves in layers.items():
                if not isinstance(leaves, Mapping):          # a bare leaf, kept by name
                    sd[layer] = _t(leaves)
                    continue
                name = _torch_layer_name(layer)
                if "kernel" in leaves:
                    kernel = np.asarray(leaves["kernel"], np.float32)
                    sd[f"{name}.weight"] = _t(kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4
                                              else kernel.T)
                    sd[f"{name}.bias"] = _t(leaves["bias"])
                    continue
                for leaf, value in leaves.items():            # BatchNorm params or stats
                    sd[f"{name}.{_LEAF_NAMES[leaf]}"] = _t(value)
        state_dicts[model_name] = sd
    return state_dicts


def weights_file(name: str) -> str:
    """model_coarse -> model_coarse.pt; smpl_estimator -> model_smpl_estimator.pt."""
    return f"{name if name.startswith('model_') else 'model_' + name}.pt"


def _host_tree(tree, mesh=None, dims: Optional[Mapping] = None):
    """A nested dict of tensors whole and on the host: the leaves that `dims`
    names are --tensor_parallel shards, all-gathered over the model group.
    The gather is a collective: every rank of the group calls this."""
    from smpl_nerf_tpu_torch.parallel import tp
    if mesh is not None:
        tree = tp.gather_tree(tree, mesh, dims)

    def cpu(t):
        if isinstance(t, torch.Tensor):
            return t.detach().cpu()
        if isinstance(t, Mapping):
            return {k: cpu(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [cpu(v) for v in t]
        return t
    return cpu(tree)


def broadcast_file(path: str) -> Optional[bytes]:
    """Rank 0's bytes of `path` on every rank, or None on every rank when
    rank 0 has no such file (what the other ranks' disks hold does not
    count). Rank 0 broadcasts the length, then the bytes."""
    from smpl_nerf_tpu_torch.parallel.multihost import comm_device
    dev = comm_device()
    data = b""
    if mesh_mod.rank() == 0 and os.path.exists(path):
        with open(path, "rb") as fh:
            data = fh.read()
    n = torch.tensor([len(data)], dtype=torch.int64, device=dev)
    dist.broadcast(n, src=0)
    if int(n.item()) == 0:
        return None
    if mesh_mod.rank() == 0:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    else:
        buf = torch.empty(int(n.item()), dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=0)
    return buf.cpu().numpy().tobytes()


def save_run(run_dir: str, state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
             args=None, parser=None, dataset_dir: Optional[str] = None, mesh=None,
             dims: Optional[Mapping] = None) -> None:
    """Write model_<name>.pt (CPU tensors), given args and parser config.txt,
    and copy create_dataset_config.txt from the dataset directory
    (`dataset_dir`, else `args.dataset_dir`) when it has one, as the JAX
    package's save_run does. Across processes: call on every rank (the
    shards named by `dims` are gathered over `mesh`); rank 0 writes, and no
    rank returns before it has written (a barrier), so any rank may read the
    run dir next."""
    state_dicts = _host_tree(state_dicts, mesh, dims)
    if mesh_mod.rank() == 0:
        _write_run(run_dir, state_dicts, args, parser, dataset_dir)
    if mesh is not None and mesh.distributed:
        dist.barrier(device_ids=[torch.cuda.current_device()]
                     if dist.get_backend() == "nccl" else None)


def _write_run(run_dir, state_dicts, args, parser, dataset_dir) -> None:
    os.makedirs(run_dir, exist_ok=True)
    for name, sd in state_dicts.items():
        torch.save({k: v.detach().cpu() for k, v in sd.items()},
                   os.path.join(run_dir, weights_file(name)))
    if parser is not None and args is not None:
        parser.write_config_file(args, [os.path.join(run_dir, "config.txt")])
    ds_dir = dataset_dir or getattr(args, "dataset_dir", None)
    if ds_dir:
        src = os.path.join(ds_dir, "create_dataset_config.txt")
        if os.path.exists(src):
            shutil.copy(src, os.path.join(run_dir, "create_dataset_config.txt"))


def load_config(run_dir: str):
    """The run's resolved flags, parsed from run_dir/config.txt."""
    cfg_path = os.path.join(run_dir, "config.txt")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(cfg_path)
    return config_mod.config_parser().parse_args([f"--config={cfg_path}"])


def load_run(run_dir: str, required: str = "model_coarse") -> Dict[str, Dict[str, torch.Tensor]]:
    """{model name: state_dict} for each model_*.pt present in run_dir; raises
    when the `required` model's file is absent (an estimator run holds only
    model_smpl_estimator.pt)."""
    state_dicts = {}
    for name in MODEL_NAMES:
        path = os.path.join(run_dir, weights_file(name))
        if os.path.exists(path):
            state_dicts[name] = torch.load(path, map_location="cpu", weights_only=True)
    if required not in state_dicts:
        raise FileNotFoundError(f"no {weights_file(required)} in {run_dir}")
    return state_dicts


def save_train_state(run_dir: str, optimizer_state: Mapping, ema_params=None,
                     epoch: Optional[int] = None, raw_params=None,
                     best_val: Optional[float] = None, mesh=None,
                     dims: Optional[Mapping] = None) -> None:
    """Full-fidelity resume state: optimizer moments (+ EMA shadow + RAW weights + epoch).

    `save_run` persists weights only, so a run cut mid-way would restart
    Adam's moments cold. With --param_ema, `save_run` stores the EMA shadow as
    the run's weights, so the raw training weights the moments belong to are
    kept here too. Across processes: call on every rank; `dims` names the
    --tensor_parallel shards of {"optimizer", "ema", "raw"}; rank 0 writes.
    """
    dims = dims or {}
    state = _host_tree({"optimizer": optimizer_state, "ema": ema_params, "raw": raw_params},
                       mesh, dims)
    if mesh_mod.rank() != 0:
        return
    state["epoch"] = None if epoch is None else int(epoch)
    state["best_val"] = (float(best_val) if best_val is not None and np.isfinite(best_val)
                         else None)
    os.makedirs(run_dir, exist_ok=True)
    torch.save(state, os.path.join(run_dir, TRAIN_STATE))


def load_train_state(run_dir: str, device="cpu", data: Optional[bytes] = None) -> Optional[dict]:
    """The dict `save_train_state` wrote (tensors on `device`), or None if
    absent. `data`: the file's bytes (from `broadcast_file`) in place of the
    file, so that every rank parses rank 0's copy."""
    if data is not None:
        return torch.load(io.BytesIO(data), map_location=device, weights_only=True)
    path = os.path.join(run_dir, TRAIN_STATE)
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=device, weights_only=True)
