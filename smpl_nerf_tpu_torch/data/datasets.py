"""Ray datasets (counterpart of smpl_nerf_tpu/data/datasets.py), rays-from-cameras only.

`RayData` is a bundle of dense numpy ray arrays for one split; a render
moves it to the device once and batches are index gathers. Loading
transforms.json + PNG directories is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from smpl_nerf_tpu_torch.core import rays as rays_mod


@dataclasses.dataclass
class RayData:
    """Dense ray arrays for one split (numpy)."""
    origins: np.ndarray          # [N, 3]
    directions: np.ndarray       # [N, 3]
    image_indices: np.ndarray    # [N] int32
    h: int
    w: int
    focal: float
    num_images: int
    camera_transforms: np.ndarray            # [N_img, 4, 4]
    human_poses: Optional[np.ndarray] = None  # [N_img, 69]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]


def rays_from_cameras(camera_transforms: np.ndarray, h: int, w: int,
                      camera_angle_x: float) -> RayData:
    """Rays from camera poses only (inference without ground truth)."""
    focal = rays_mod.focal_from_fov(w, camera_angle_x)
    cams = np.asarray(camera_transforms, np.float32)
    origins, dirs = rays_mod.get_rays_batch_np(h, w, focal, cams)
    n = cams.shape[0]
    idx = np.repeat(np.arange(n, dtype=np.int32), h * w)
    return RayData(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                   idx, h, w, focal, n, cams)
