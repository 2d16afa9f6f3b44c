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
flax Dense `kernel [in, out]` becomes torch `weight [out, in]`, and the flax
names `positional_net_{i}` / `directional_net_0` become the reference's
`positional_net.{i}` / `directional_net.0`; a leaf that is no Dense layer
(`arm_angle_l`, `arm_angle_r`) and the `constants` collection (`goal_poses`,
a buffer in the port) keep their names.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch import config as config_mod

MODEL_NAMES = ("model_coarse", "model_fine", "model_warp_field", "smpl_estimator",
               "vertex_embedder")


def _torch_layer_name(flax_name: str) -> str:
    for prefix in ("positional_net_", "directional_net_"):
        if flax_name.startswith(prefix):
            return f"{prefix[:-1]}.{flax_name[len(prefix):]}"
    return flax_name


def params_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"model_coarse": {"params": {layer: {"kernel", "bias"}}}, "smpl_estimator":
    {"constants": {"goal_poses": ...}}, ...} -> state dicts."""
    state_dicts = {}
    for model_name, variables in tree.items():
        collections = ([variables[c] for c in ("params", "constants") if c in variables]
                       if "params" in variables or "constants" in variables else [variables])
        sd = {}
        for layers in collections:
            for layer, leaves in layers.items():
                if not isinstance(leaves, Mapping):          # a bare leaf, kept by name
                    sd[layer] = torch.tensor(np.asarray(leaves, np.float32))
                    continue
                name = _torch_layer_name(layer)
                sd[f"{name}.weight"] = torch.tensor(np.asarray(leaves["kernel"], np.float32).T)
                sd[f"{name}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))
        state_dicts[model_name] = sd
    return state_dicts


def weights_file(name: str) -> str:
    """model_coarse -> model_coarse.pt; smpl_estimator -> model_smpl_estimator.pt."""
    return f"{name if name.startswith('model_') else 'model_' + name}.pt"


def save_run(run_dir: str, state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
             args=None, parser=None, dataset_dir: Optional[str] = None) -> None:
    """Write model_<name>.pt (CPU tensors), given args and parser config.txt,
    and copy create_dataset_config.txt from the dataset directory
    (`dataset_dir`, else `args.dataset_dir`) when it has one, as the JAX
    package's save_run does."""
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


def load_run(run_dir: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model name: state_dict} for each model_*.pt present in run_dir."""
    state_dicts = {}
    for name in MODEL_NAMES:
        path = os.path.join(run_dir, weights_file(name))
        if os.path.exists(path):
            state_dicts[name] = torch.load(path, map_location="cpu", weights_only=True)
    if "model_coarse" not in state_dicts:
        raise FileNotFoundError(f"no model_coarse.pt in {run_dir}")
    return state_dicts


def save_train_state(run_dir: str, optimizer_state: Mapping, ema_params=None,
                     epoch: Optional[int] = None, raw_params=None,
                     best_val: Optional[float] = None) -> None:
    """Full-fidelity resume state: optimizer moments (+ EMA shadow + RAW weights + epoch).

    `save_run` persists weights only, so a run cut mid-way would restart
    Adam's moments cold. With --param_ema, `save_run` stores the EMA shadow as
    the run's weights, so the raw training weights the moments belong to are
    kept here too.
    """
    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu()
        if isinstance(tree, Mapping):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [cpu(v) for v in tree]
        return tree

    state = {"optimizer": cpu(optimizer_state), "ema": cpu(ema_params), "raw": cpu(raw_params),
             "epoch": None if epoch is None else int(epoch),
             "best_val": (float(best_val) if best_val is not None and np.isfinite(best_val)
                          else None)}
    os.makedirs(run_dir, exist_ok=True)
    torch.save(state, os.path.join(run_dir, "train_state.pt"))


def load_train_state(run_dir: str, device="cpu") -> Optional[dict]:
    """The dict `save_train_state` wrote (tensors on `device`), or None if absent."""
    path = os.path.join(run_dir, "train_state.pt")
    if not os.path.exists(path):
        return None
    return torch.load(path, map_location=device, weights_only=True)
