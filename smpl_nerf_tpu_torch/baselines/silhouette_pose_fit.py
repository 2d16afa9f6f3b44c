"""Silhouette-based SMPL pose fit (counterpart of
smpl_nerf_tpu/baselines/silhouette_pose_fit.py).

Optimises a 69-dim body pose so that the mesh's vertices, projected through
the camera, match the target silhouette's pixels (a symmetric 2D chamfer),
with an l2 pose prior and SMPLify's angle prior on knees and elbows.
Gradients flow through the projection and the port's LBS (`smpl_forward`)
by torch autograd; `torch.optim.Adam` takes optax.adam's place (the same
update for eps = 1e-8 and no eps_root). Runs on `device` (the card unless the
caller passes "cpu").
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.core.rays import focal_from_fov
from smpl_nerf_tpu_torch.models import smpl as smpl_mod

# SMPLify angle-prior entries: knees / elbows bend one way. Indices into the
# 69-dim body pose, (joint - 1) * 3 + axis.
_ANGLE_PRIOR_IDX = np.array([3 * (4 - 1), 3 * (5 - 1), 3 * (18 - 1) + 2, 3 * (19 - 1) + 2])
_ANGLE_PRIOR_SIGN = np.array([1.0, 1.0, -1.0, 1.0], np.float32)


def project_vertices(vertices: torch.Tensor, camera_pose: np.ndarray,
                     h: int, w: int, focal: float) -> torch.Tensor:
    """World-space vertices [V, 3] -> pixel coordinates [V, 2] (x, y); the
    camera pose is camera-to-world."""
    cam = torch.as_tensor(np.asarray(camera_pose, np.float32), device=vertices.device)
    R, t = cam[:3, :3], cam[:3, 3]
    vc = (vertices - t) @ R                      # R^T applied from the right
    x = -vc[:, 0] / vc[:, 2] * focal + w * 0.5
    y = vc[:, 1] / vc[:, 2] * focal + h * 0.5
    return torch.stack([x, y], -1)


def silhouette_pixels(mask: np.ndarray, max_points: int = 2048) -> np.ndarray:
    """Foreground pixel coordinates [P, 2] (x, y), subsampled to max_points by
    the same seeded draw as the JAX package."""
    ys, xs = np.where(mask)
    pts = np.stack([xs, ys], -1).astype(np.float32)
    if len(pts) > max_points:
        sel = np.random.RandomState(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
    return pts


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric chamfer distance between 2D point sets."""
    d = torch.sum((a[:, None, :] - b[None, :, :]) ** 2, -1)
    return torch.mean(torch.min(d, 1).values) + torch.mean(torch.min(d, 0).values)


def angle_prior(pose: torch.Tensor) -> torch.Tensor:
    """sum exp(sign * pose[i])^2 over the four bend entries of a [69] pose."""
    idx = torch.as_tensor(_ANGLE_PRIOR_IDX, device=pose.device)
    sign = torch.as_tensor(_ANGLE_PRIOR_SIGN, device=pose.device)
    return torch.sum(torch.exp(pose[idx] * sign) ** 2)


def l2_prior(pose: torch.Tensor) -> torch.Tensor:
    return torch.sum(pose ** 2)


def fit_pose_to_silhouette(model: smpl_mod.SmplModel, target_mask: np.ndarray,
                           camera_pose: np.ndarray, camera_angle_x: float,
                           betas: Optional[np.ndarray] = None,
                           init_pose: Optional[np.ndarray] = None,
                           steps: int = 200, lr: float = 0.05,
                           weight_l2: float = 1e-3, weight_angle: float = 1e-2,
                           free_joints: Optional[np.ndarray] = None,
                           device=DEFAULT_DEVICE) -> Tuple[np.ndarray, list]:
    """Optimise a 69-dim body pose to match a binary silhouette. Returns
    (pose, losses); only the `free_joints` entries move when it is given."""
    device = resolve_device(device)
    h, w = target_mask.shape
    focal = focal_from_fov(w, camera_angle_x)
    target = torch.as_tensor(silhouette_pixels(target_mask), device=device)
    betas = torch.as_tensor(np.zeros(10, np.float32) if betas is None
                            else np.asarray(betas, np.float32).reshape(-1), device=device)
    pose0 = torch.as_tensor(np.zeros(69, np.float32) if init_pose is None
                            else np.asarray(init_pose, np.float32).reshape(-1), device=device)
    mask_free = torch.ones(69, device=device)
    if free_joints is not None:
        mask_free = torch.zeros(69, device=device)
        mask_free[torch.as_tensor(np.asarray(free_joints), device=device)] = 1.0

    pose = pose0.clone().requires_grad_(True)
    optimizer = torch.optim.Adam([pose], lr=lr, eps=1e-8)
    losses = []
    for _ in range(steps):
        optimizer.zero_grad()
        p = pose0 + mask_free * (pose - pose0)
        verts = smpl_mod.smpl_forward(model, betas, p)
        pix = project_vertices(verts, camera_pose, h, w, focal)
        loss = chamfer(pix, target) + weight_l2 * l2_prior(p) + weight_angle * angle_prior(p)
        loss.backward()
        optimizer.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        final = pose0 + mask_free * (pose - pose0)
    return final.cpu().numpy(), losses
