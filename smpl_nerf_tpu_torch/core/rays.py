"""Pinhole ray generation (counterpart of smpl_nerf_tpu/core/rays.py).

Pixel grid in 'xy' indexing, camera looking down -z, directions rotated by the
camera-to-world rotation block, origins broadcast from the translation column.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _pixel_dirs(h: int, w: int, focal: float, device) -> torch.Tensor:
    i, j = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=device),
                          torch.arange(h, dtype=torch.float32, device=device),
                          indexing="xy")
    return torch.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal,
                        -torch.ones_like(i)], -1)                   # [h, w, 3]


def get_rays(h: int, w: int, focal: float, camera_transform: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rays_translation [h,w,3], rays_direction [h,w,3]) of one camera."""
    camera_transform = torch.as_tensor(camera_transform, dtype=torch.float32)
    dirs = _pixel_dirs(h, w, focal, camera_transform.device)
    rays_direction = torch.sum(dirs[..., None, :] * camera_transform[:3, :3], -1)
    rays_translation = camera_transform[:3, -1].expand(rays_direction.shape)
    return rays_translation, rays_direction


def get_rays_batch(h: int, w: int, focal: float, camera_transforms: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """get_rays over [N,4,4] cameras -> (origins [N,h,w,3], directions [N,h,w,3])."""
    camera_transforms = torch.as_tensor(camera_transforms, dtype=torch.float32)
    dirs = _pixel_dirs(h, w, focal, camera_transforms.device)
    rays_direction = torch.einsum("hwc,nrc->nhwr", dirs, camera_transforms[:, :3, :3])
    rays_translation = camera_transforms[:, None, None, :3, -1].expand(rays_direction.shape)
    return rays_translation, rays_direction


def get_rays_batch_np(h: int, w: int, focal: float, camera_transforms
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side numpy get_rays_batch, for building a dataset's ray arrays."""
    camera_transforms = np.asarray(camera_transforms, np.float32)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - w * 0.5) / focal, -(j - h * 0.5) / focal, -np.ones_like(i)], -1)
    rays_direction = np.einsum("hwc,nrc->nhwr", dirs, camera_transforms[:, :3, :3])
    rays_translation = np.broadcast_to(camera_transforms[:, None, None, :3, -1],
                                       rays_direction.shape)
    return rays_translation.copy(), rays_direction


def focal_from_fov(w: int, camera_angle_x: float) -> float:
    """focal = 0.5*w / tan(0.5*fov_x) — the transforms.json camera contract."""
    return 0.5 * w / float(np.tan(0.5 * camera_angle_x))
