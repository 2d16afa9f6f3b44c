"""Model factory (counterpart of smpl_nerf_tpu/training/factory.py:build_models_and_params).

The nerf / smpl_nerf subset: model_type -> nn.Modules with weights drawn from
a seeded torch.Generator (flax's Dense init: lecun-normal kernels, zero
biases). Every other family, SIREN nets and grid encoders are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.models import RenderRayNet, WarpFieldNet
from smpl_nerf_tpu_torch.pipelines import PORTED_MODEL_TYPES, _not_ported, build_encoders


def compute_dtype(args) -> torch.dtype:
    return (torch.bfloat16 if getattr(args, "compute_dtype", "float32") == "bfloat16"
            else torch.float32)


def build_models_and_params(args, seed: int = 0, device=DEFAULT_DEVICE
                            ) -> Tuple[Dict[str, torch.nn.Module], Dict[str, PositionalEncoder]]:
    """Returns (models, encoders). The parameters live inside the modules,
    which are in eval mode on `device`."""
    device = resolve_device(device)
    if args.model_type not in PORTED_MODEL_TYPES:
        raise _not_ported(f"model_type {args.model_type!r}")
    if int(getattr(args, "siren", 0)):
        raise _not_ported("--siren (SirenRenderRayNet)")
    if int(getattr(args, "grid_encoding", 0) or 0):
        raise _not_ported("--grid_encoding (GridNerf)")
    encoders = build_encoders(args)
    pos_dim = encoders["position"].output_dim * 3
    dir_dim = encoders["direction"].output_dim * 3
    human_pose_dim = (encoders["human_pose"].output_dim
                      if int(args.human_pose_encoding) else 1)
    dtype = compute_dtype(args)
    generator = torch.Generator().manual_seed(int(seed))
    common = dict(positions_dim=pos_dim, directions_dim=dir_dim,
                  use_directional_input=bool(int(args.use_directional_input)),
                  compute_dtype=dtype, device=device, generator=generator)
    models: Dict[str, torch.nn.Module] = {
        "model_coarse": RenderRayNet(n_layers=int(args.netdepth), width=int(args.netwidth),
                                     skips=tuple(int(s) for s in args.skips), **common),
        "model_fine": RenderRayNet(n_layers=int(args.netdepth_fine),
                                   width=int(args.netwidth_fine),
                                   skips=tuple(int(s) for s in args.skips_fine), **common),
    }
    if args.model_type == "smpl_nerf":
        warp_pos_dim = (encoders["position"].output_dim
                        if int(args.human_pose_encoding) else 1) * 3
        models["model_warp_field"] = WarpFieldNet(
            width=int(args.netwidth_warp), positions_dim=warp_pos_dim,
            pose_dim=human_pose_dim * 2, compute_dtype=dtype, device=device,
            generator=generator)
    for m in models.values():
        m.eval()
    return models, encoders
