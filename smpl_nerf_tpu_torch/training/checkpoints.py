"""Run directories (counterpart of smpl_nerf_tpu/training/checkpoints.py).

A run directory holds the fully resolved `config.txt` and one reference-layout
torch state_dict per model: `model_coarse.pt`, `model_fine.pt`,
`model_warp_field.pt` — exactly what the JAX package's
`checkpoints.export_torch_run` writes next to its msgpack weights.

`params_from_jax` carries weights over from a JAX params tree of numpy arrays:
flax Dense `kernel [in, out]` becomes torch `weight [out, in]`, and the flax
names `positional_net_{i}` / `directional_net_0` become the reference's
`positional_net.{i}` / `directional_net.0`.
"""
from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

from smpl_nerf_tpu_torch import config as config_mod

MODEL_NAMES = ("model_coarse", "model_fine", "model_warp_field")


def _torch_layer_name(flax_name: str) -> str:
    for prefix in ("positional_net_", "directional_net_"):
        if flax_name.startswith(prefix):
            return f"{prefix[:-1]}.{flax_name[len(prefix):]}"
    return flax_name


def params_from_jax(tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"model_coarse": {"params": {layer: {"kernel", "bias"}}}, ...} -> state dicts."""
    state_dicts = {}
    for model_name, params in tree.items():
        layers = params.get("params", params)
        sd = {}
        for layer, leaves in layers.items():
            name = _torch_layer_name(layer)
            sd[f"{name}.weight"] = torch.tensor(np.asarray(leaves["kernel"], np.float32).T)
            sd[f"{name}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))
        state_dicts[model_name] = sd
    return state_dicts


def save_run(run_dir: str, state_dicts: Mapping[str, Mapping[str, torch.Tensor]],
             args=None, parser=None) -> None:
    """Write model_<name>.pt (CPU tensors) and, given args and parser, config.txt."""
    os.makedirs(run_dir, exist_ok=True)
    for name, sd in state_dicts.items():
        torch.save({k: v.detach().cpu() for k, v in sd.items()},
                   os.path.join(run_dir, f"{name}.pt"))
    if parser is not None and args is not None:
        parser.write_config_file(args, [os.path.join(run_dir, "config.txt")])


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
        path = os.path.join(run_dir, f"{name}.pt")
        if os.path.exists(path):
            state_dicts[name] = torch.load(path, map_location="cpu", weights_only=True)
    if "model_coarse" not in state_dicts:
        raise FileNotFoundError(f"no model_coarse.pt in {run_dir}")
    return state_dicts
