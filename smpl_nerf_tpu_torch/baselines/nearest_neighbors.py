"""Nearest-training-image baseline (numpy copy of
smpl_nerf_tpu/baselines/nearest_neighbors.py).

For each query (camera pose, human pose), the training image whose (camera,
pose) is closest is the "render". Distance: euclidean over [camera
x, y, z, -phi, theta, psi || pose_weight * human pose]. A cheap lower bound on
what any learned model must beat.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from smpl_nerf_tpu_torch.core import cameras


def _features(camera_transforms: np.ndarray,
              human_poses: Optional[np.ndarray], pose_weight: float) -> np.ndarray:
    cam_feats = np.stack([cameras.get_xyzphitheta(c) for c in camera_transforms])
    if human_poses is None:
        return cam_feats
    return np.concatenate([cam_feats, pose_weight * human_poses.reshape(
        len(human_poses), -1)], -1)


def nearest_neighbor_indices(train_cams: np.ndarray, query_cams: np.ndarray,
                             train_poses: Optional[np.ndarray] = None,
                             query_poses: Optional[np.ndarray] = None,
                             pose_weight: float = 1.0) -> np.ndarray:
    """Index of the nearest training example for each query. [N_query]"""
    tf = _features(train_cams, train_poses, pose_weight)
    qf = _features(query_cams, query_poses, pose_weight)
    d = np.linalg.norm(qf[:, None, :] - tf[None, :, :], axis=-1)
    return np.argmin(d, axis=1)


def evaluate_nearest_neighbors(train_data, val_data, pose_weight: float = 1.0,
                               device=None) -> Tuple[np.ndarray, dict]:
    """Render val by nearest training image; return (renders [N, h, w, 3] BGR,
    scores). The scores run on `device` (evaluation/scores.print_scores)."""
    from smpl_nerf_tpu_torch.evaluation.scores import print_scores

    idx = nearest_neighbor_indices(
        train_data.camera_transforms, val_data.camera_transforms,
        train_data.human_poses, val_data.human_poses, pose_weight)
    h, w = train_data.h, train_data.w
    renders = train_data.rgb.reshape(train_data.num_images, h, w, 3)[idx]
    truths = val_data.rgb.reshape(val_data.num_images, h, w, 3)
    return renders, print_scores(renders, truths, device=device)
