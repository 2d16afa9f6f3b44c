"""Batched rendering of a whole ray dataset from a run directory.

Counterparts of smpl_nerf_tpu/training/solver.py:Solver.render_rays_batched
and smpl_nerf_tpu/cli/inference.py:render_dataset (the full renderer; the
`--fast` foreground-culled and occupancy renderers are not ported yet).

Rays are cut into chunks of `batch_size`; the last chunk is padded with its
LAST ray (never ray 0), and each ray's `human_pose` is gathered from the
per-image pose table through its image index.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data.datasets import RayData
from smpl_nerf_tpu_torch.pipelines import Pipeline, RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params


@torch.no_grad()
def render_rays_batched(pipeline: Pipeline, data: RayData, batch_size: int,
                        device: torch.device) -> np.ndarray:
    """rgb_fine [N, 3] of every ray of `data`, on the host."""
    n = data.num_rays
    arrays = {"ray_translation": torch.as_tensor(data.origins, dtype=torch.float32,
                                                 device=device),
              "ray_direction": torch.as_tensor(data.directions, dtype=torch.float32,
                                               device=device)}
    image_indices = torch.as_tensor(data.image_indices, dtype=torch.long, device=device)
    pose_table = (torch.as_tensor(data.human_poses, dtype=torch.float32, device=device)
                  if data.human_poses is not None else None)
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    for lo in range(0, n, batch_size):
        idx = torch.arange(lo, min(lo + batch_size, n), device=device)
        real = idx.shape[0]
        if real < batch_size:
            idx = torch.cat([idx, idx[-1:].expand(batch_size - real)])
        batch = {k: v[idx] for k, v in arrays.items()}
        if pose_table is not None:
            batch["human_pose"] = pose_table[image_indices[idx]]
        out[lo:lo + real] = pipeline(batch)["rgb_fine"][:real]
    return out.cpu().numpy()


def build_from_run(run_dir: str, args, device: torch.device) -> Pipeline:
    """The run's pipeline with its weights loaded from model_*.pt."""
    models, encoders = build_models_and_params(args, device=device)
    state_dicts = checkpoints.load_run(run_dir)
    for name, model in models.items():
        if name not in state_dicts:
            raise FileNotFoundError(f"{run_dir} has no {name}.pt")
        model.load_state_dict(state_dicts[name])
    return build_pipeline(RenderConfig.from_args(args), models, encoders)


def render_dataset(args, run_dir: str, data: RayData, batch_size: Optional[int] = None,
                   device=DEFAULT_DEVICE) -> np.ndarray:
    """Render every image of `data` through the run's weights -> [N, h, w, 3]."""
    dev = resolve_device(device)
    pipeline = build_from_run(run_dir, args, dev)
    rgb = render_rays_batched(pipeline, data, int(batch_size or args.batchsize_val), dev)
    return rgb.reshape(data.num_images, data.h, data.w, 3)
