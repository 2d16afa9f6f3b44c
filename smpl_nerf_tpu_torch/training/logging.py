"""Per-epoch observability (counterpart of smpl_nerf_tpu/training/logging.py).

  * tensorboard_rerenders: one image per epoch, a row per validation image
    with the panels [ground truth, rerender, |warp|?], handed to
    `writer.add_image` as HWC float32 in [0, 1]. The JAX package draws these
    panels with matplotlib (titles, a colorbar) and logs the rasterised
    figure; the port composes the same panels in numpy, with no matplotlib:
    the images are BGR in the pipeline and flipped to RGB for display, clipped
    to [0, 1], and the warp magnitude (the norm over the last axis where a warp
    has one) is scaled by its largest value and shown in grey,
  * tensorboard_warps: the sample positions as a point cloud coloured by warp
    magnitude, through `writer.add_mesh`,
  * vedo_data: density (and warp) samples as <log_dir>/vedo_data/
    epoch_<e>_img_<i>.npz, with the keys tools/visualize_log_data.py reads.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


def rerender_panels(number_validation_images: int, rerenders: np.ndarray,
                    ground_truths: np.ndarray,
                    ray_warps: Optional[np.ndarray] = None) -> List[List[np.ndarray]]:
    """The grid's panels, a row per image: [ground truth, rerender, |warp|?],
    each [h, w, 3] float32 RGB in [0, 1]."""
    rows = []
    for i in range(min(number_validation_images, len(rerenders))):
        row = [np.clip(ground_truths[i][..., ::-1], 0, 1),
               np.clip(rerenders[i][..., ::-1], 0, 1)]
        if ray_warps is not None:
            mag = (np.linalg.norm(ray_warps[i], axis=-1) if ray_warps[i].ndim == 3
                   else ray_warps[i])
            grey = mag / max(float(mag.max()), 1e-8)
            row.append(np.repeat(grey[..., None], 3, -1))
        rows.append([np.asarray(p, np.float32) for p in row])
    return rows


def tensorboard_rerenders(writer, number_validation_images: int,
                          rerenders: np.ndarray, ground_truths: np.ndarray,
                          step: int, ray_warps: Optional[np.ndarray] = None,
                          tag: str = "val/rerenders") -> Optional[np.ndarray]:
    """Log the panels of `rerender_panels` as one HWC image; returns it (None
    when there is no writer or no image)."""
    rows = rerender_panels(number_validation_images, rerenders, ground_truths, ray_warps)
    if not rows or writer is None:
        return None
    grid = np.concatenate([np.concatenate(row, axis=1) for row in rows], axis=0)
    writer.add_image(tag, grid, step, dataformats="HWC")
    return grid


def tensorboard_warps(writer, step: int, points: np.ndarray, warps: np.ndarray,
                      tag: str = "warp_cloud") -> None:
    """3D point cloud of sample positions coloured by warp magnitude (red:
    the largest, blue: none)."""
    if writer is None or not hasattr(writer, "add_mesh"):
        return
    pts = points.reshape(1, -1, 3)
    mag = np.linalg.norm(warps.reshape(-1, 3), axis=-1)
    mag = mag / max(float(mag.max()), 1e-8)
    colors = np.stack([mag, np.zeros_like(mag), 1.0 - mag], -1)
    colors = (colors * 255).astype(np.int32).reshape(1, -1, 3)
    writer.add_mesh(tag, vertices=pts, colors=colors, global_step=step)


def vedo_data(log_dir: str, densities: np.ndarray, samples: np.ndarray,
              warps: Optional[np.ndarray] = None, epoch: int = 0,
              image_idx: int = 0) -> str:
    """Dump density-weighted point samples for the offline 3D viewer; returns
    the file's path."""
    out_dir = os.path.join(log_dir, "vedo_data")
    os.makedirs(out_dir, exist_ok=True)
    payload = {"density_samples": samples.reshape(-1, 3),
               "densities": densities.reshape(-1)}
    if warps is not None:
        payload["warp_samples"] = samples.reshape(-1, 3)
        payload["warps"] = warps.reshape(-1, 3)
    path = os.path.join(out_dir, f"epoch_{epoch}_img_{image_idx}.npz")
    np.savez(path, **payload)
    return path
