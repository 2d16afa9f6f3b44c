"""Model factory (counterpart of smpl_nerf_tpu/training/factory.py:build_models_and_params).

model_type -> nn.Modules with weights drawn from a seeded torch.Generator
(flax's Dense init: lecun-normal kernels, zero biases), for every model type:
the coarse and fine nets, plus the warp field (smpl_nerf, warp), the
estimators of the SMPL-driven families (dummy_dynamic, image_wise_dynamic,
append_vertex_locations_to_nerf), the vertex embedder of
append_vertex_locations_to_nerf, and the CNN `SmplEstimator` of
smpl_estimator, sized to the dataset's images. `--siren 1` builds both nets
as `SirenRenderRayNet`s, `--grid_encoding 1` as `GridNerf`s (--grid_levels /
features / width / depth / bound; the direction encoding has
--number_frequencies_directional frequencies), as the JAX factory does;
`--grid_encoding 2` (the port's own) as `HashGridNerf`s at Instant-NGP's
published sizes (`grid_nerf.NGP_SIZES`; --grid_features / width / bound).
`smpl_model_for` and `dataset_extras` give the SMPL-driven families and
vertex_sphere the SMPL model and the per-dataset constants.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.config import MODEL_TYPES
from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.models import RenderRayNet, WarpFieldNet
from smpl_nerf_tpu_torch.models import grid_nerf
from smpl_nerf_tpu_torch.models.grid_nerf import GridNerf, HashGridNerf, HashGridSpec
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.models.dummy_estimators import (DummyImageWiseEstimator,
                                                          DummySmplEstimatorModel)
from smpl_nerf_tpu_torch.models.render_ray_net import (SirenRenderRayNet, _linear,
                                                      init_linear_)
from smpl_nerf_tpu_torch.models.smpl_estimator import SmplEstimator
from smpl_nerf_tpu_torch.pipelines import SMPL_MODEL_FAMILIES, build_encoders

VERTEX_EMBEDDING_DIM = 64


class VertexEmbedder(nn.Module):
    """Embeds the flattened goal-mesh vertex cloud [V*3] into a 64-wide
    conditioning prefix: Linear + ReLU (`embed_0`), Linear + ReLU
    (`embed_out`), in float32."""

    def __init__(self, in_dim: int, width: int = 256,
                 embedding_dim: int = VERTEX_EMBEDDING_DIM, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_0 = _linear(in_dim, width, device)
        self.embed_out = _linear(width, embedding_dim, device)
        for layer in (self.embed_0, self.embed_out):
            init_linear_(layer, generator)

    def forward(self, verts_flat: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.embed_out(torch.relu(self.embed_0(verts_flat.float()))))


def compute_dtype(args) -> torch.dtype:
    return (torch.bfloat16 if getattr(args, "compute_dtype", "float32") == "bfloat16"
            else torch.float32)


def smpl_model_for(args) -> smpl_mod.SmplModel:
    """The SMPL model of a run: the pkl that --smpl_model_path names, else
    (None) the procedural human, as the JAX package's cli/train.py chooses it.
    A path that names no file raises. Kept on `args._smpl_model`, so a run
    builds it once."""
    if getattr(args, "_smpl_model", None) is None:
        path = getattr(args, "smpl_model_path", None)
        if path and not os.path.isfile(path):
            raise FileNotFoundError(f"--smpl_model_path {path!r} names no file")
        args._smpl_model = (smpl_mod.load_smpl_pkl(path) if path
                            else smpl_mod.procedural_human())
    return args._smpl_model


def dataset_extras(args, data) -> Dict[str, Any]:
    """The per-dataset constants the factory and the pipeline read: betas, the
    split's pose table (`goal_poses`), the image size (the CNN estimator's
    input) and, for the SMPL-driven families and vertex_sphere, the SMPL model
    and its vertex count."""
    extras: Dict[str, Any] = {
        "betas": data.betas if data.betas is not None else np.zeros(10, np.float32),
        "image_size": (data.h, data.w)}
    if data.human_poses is not None:
        extras["goal_poses"] = data.human_poses
    if args.model_type in SMPL_MODEL_FAMILIES:
        extras["smpl_model"] = smpl_model_for(args)
        extras["num_vertices"] = extras["smpl_model"].num_vertices
    return extras


def build_models_and_params(args, seed: int = 0, device=DEFAULT_DEVICE,
                            extras: Optional[Dict[str, Any]] = None
                            ) -> Tuple[Dict[str, torch.nn.Module], Dict[str, PositionalEncoder]]:
    """Returns (models, encoders). The parameters live inside the modules,
    which are in eval mode on `device`.

    extras (`dataset_extras`): 'goal_poses' [N_img, 69] for the dummy
    estimator, 'num_vertices' for the vertex embedder, 'canonical_pose' for
    the image-wise one, 'image_size' (h, w) for the CNN estimator.
    """
    device = resolve_device(device)
    extras = extras or {}
    if args.model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {args.model_type!r}")
    encoders = build_encoders(args)
    pos_dim = encoders["position"].output_dim * 3
    dir_dim = encoders["direction"].output_dim * 3
    human_pose_dim = (encoders["human_pose"].output_dim
                      if int(args.human_pose_encoding) else 1)
    dtype = compute_dtype(args)
    generator = torch.Generator().manual_seed(int(seed))
    # the append families feed the (encoded) pose of two joints, or of all 69,
    # or the embedded vertex cloud, to both nets as a conditioning prefix
    additional = {"append_to_nerf": human_pose_dim * 2,
                  "append_smpl_params": human_pose_dim * 69,
                  "append_vertex_locations_to_nerf": VERTEX_EMBEDDING_DIM}.get(args.model_type, 0)
    models: Dict[str, torch.nn.Module] = {}
    grid = int(getattr(args, "grid_encoding", 0) or 0)
    if grid == 2:
        spec = HashGridSpec.published(features=int(args.grid_features), **grid_nerf.NGP_SIZES)
        hash_kw = dict(spec=spec, width=int(args.grid_width), additional_input_dim=additional,
                       bound=float(args.grid_bound), compute_dtype=dtype, device=device,
                       generator=generator)
        models["model_coarse"] = HashGridNerf(**hash_kw)
        models["model_fine"] = HashGridNerf(**hash_kw)
    elif grid:
        grid_kw = dict(levels=tuple(int(r) for r in str(args.grid_levels).split(",")),
                       features=int(args.grid_features), width=int(args.grid_width),
                       n_layers=int(args.grid_depth),
                       dir_freqs=int(args.number_frequencies_directional),
                       additional_input_dim=additional, bound=float(args.grid_bound),
                       compute_dtype=dtype, device=device, generator=generator)
        models["model_coarse"] = GridNerf(**grid_kw)
        models["model_fine"] = GridNerf(**grid_kw)
    else:
        cls = SirenRenderRayNet if int(getattr(args, "siren", 0)) else RenderRayNet
        common = dict(positions_dim=pos_dim, directions_dim=dir_dim,
                      additional_input_dim=additional,
                      use_directional_input=bool(int(args.use_directional_input)),
                      compute_dtype=dtype, device=device, generator=generator)
        models["model_coarse"] = cls(n_layers=int(args.netdepth), width=int(args.netwidth),
                                     skips=tuple(int(s) for s in args.skips), **common)
        models["model_fine"] = cls(n_layers=int(args.netdepth_fine),
                                   width=int(args.netwidth_fine),
                                   skips=tuple(int(s) for s in args.skips_fine), **common)
    if args.model_type in ("smpl_nerf", "warp"):
        warp_pos_dim = (encoders["position"].output_dim
                        if int(args.human_pose_encoding) else 1) * 3
        models["model_warp_field"] = WarpFieldNet(
            width=int(args.netwidth_warp), positions_dim=warp_pos_dim,
            pose_dim=human_pose_dim * 2, compute_dtype=dtype, device=device,
            generator=generator)
    if args.model_type in ("dummy_dynamic", "append_vertex_locations_to_nerf"):
        models["smpl_estimator"] = DummySmplEstimatorModel(extras["goal_poses"], device=device)
    if args.model_type == "smpl_estimator":
        size = extras.get("image_size", 128)        # five max-pools: at least 32 a side
        models["smpl_estimator"] = SmplEstimator(
            len(args.human_joints), (size, size) if np.isscalar(size) else tuple(size),
            device=device, generator=generator)
    if args.model_type == "image_wise_dynamic":
        models["smpl_estimator"] = DummyImageWiseEstimator(extras.get("canonical_pose"),
                                                           device=device)
    if args.model_type == "append_vertex_locations_to_nerf":
        models["vertex_embedder"] = VertexEmbedder(
            int(extras["num_vertices"]) * 3, width=int(args.netwidth), device=device,
            generator=generator)
    for m in models.values():
        m.eval()
    return models, encoders
