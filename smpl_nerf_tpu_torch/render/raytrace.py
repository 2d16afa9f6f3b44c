"""Ray-traced mesh renderer for synthetic dataset generation (counterpart of
smpl_nerf_tpu/render/raytrace.py).

One closest-hit query per pixel (`ops/raymesh.intersect_rays`), barycentric
attribute interpolation (vertex colours, or a bilinear UV texture lookup with
the UV origin at the bottom left), Lambertian shading under a headlight (the
light comes from the camera: ambient 0.45 + diffuse 0.65 * |n . d|, two-sided)
over a white background. `get_warp` gives the `smpl` dataset type's per-pixel
companions from the same intersection: the goal -> canonical warp of each
pixel's hit (carried onto the canonical mesh through the hit face's
barycentric coordinates) and the hit's distance. Plain PyTorch on whichever
device the caller names: the JAX package runs this as plain XLA, no Pallas.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.core import rays as rays_mod
from smpl_nerf_tpu_torch.ops import raymesh

_AMBIENT = 0.45
_DIFFUSE = 0.65


def pixel_rays(camera_pose, h: int, w: int, fov: float, device):
    """(origins [h*w, 3], unit directions [h*w, 3]) of a camera's pixels."""
    focal = rays_mod.focal_from_fov(w, fov)      # aspect 1: fov_x == fov_y
    cam = torch.as_tensor(np.asarray(camera_pose, np.float32), device=device)
    origins, dirs = rays_mod.get_rays(h, w, focal, cam)
    origins, dirs = origins.reshape(-1, 3), dirs.reshape(-1, 3)
    return origins, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def _shade(vertices: torch.Tensor, faces: torch.Tensor, hits: raymesh.RayHits,
           base_color: torch.Tensor, view_dir: torch.Tensor, bg_color) -> torch.Tensor:
    """Lambertian headlight shading of per-ray base colours; bg_color on misses."""
    tri = vertices[faces[hits.face_idx.clamp(min=0)]]
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    lambert = torch.abs(torch.sum(n * view_dir, -1))
    rgb = torch.clamp(base_color * (_AMBIENT + _DIFFUSE * lambert)[:, None], 0.0, 1.0)
    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=rgb.device)
    return torch.where(hits.hit[:, None], rgb, bg)


@torch.no_grad()
def render_scene(vertices, faces, camera_pose, h: int, w: int, yfov: float,
                 vertex_colors: Optional[np.ndarray] = None, uv: Optional[np.ndarray] = None,
                 texture: Optional[np.ndarray] = None, return_depth: bool = False,
                 bg_color=(1.0, 1.0, 1.0), device="cpu"):
    """A posed mesh seen from `camera_pose` (vertical fov `yfov`, aspect 1):
    uint8 RGB [h, w, 3], and with return_depth the hit distance [h, w]
    (0 on misses), both numpy."""
    origins, dirs = pixel_rays(camera_pose, h, w, yfov, device)
    verts = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)
    hits = raymesh.intersect_rays(origins, dirs, verts, faces_t)
    face_verts_idx = faces_t[hits.face_idx.clamp(min=0)]                      # [N, 3]
    if texture is not None and uv is not None:
        uv_t = torch.as_tensor(np.asarray(uv, np.float32), device=device)
        uv_hit = torch.sum(hits.bary[..., None] * uv_t[face_verts_idx], -2)
        th, tw = texture.shape[:2]
        x = torch.clamp(uv_hit[:, 0], 0.0, 1.0) * (tw - 1)
        y = (1.0 - torch.clamp(uv_hit[:, 1], 0.0, 1.0)) * (th - 1)
        x0, y0 = torch.floor(x).long(), torch.floor(y).long()
        x1, y1 = torch.clamp(x0 + 1, max=tw - 1), torch.clamp(y0 + 1, max=th - 1)
        tex = torch.as_tensor(np.asarray(texture, np.float32), device=device) / 255.0
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        base = ((1 - fx) * (1 - fy) * tex[y0, x0] + fx * (1 - fy) * tex[y0, x1]
                + (1 - fx) * fy * tex[y1, x0] + fx * fy * tex[y1, x1])
    elif vertex_colors is not None:
        vc = torch.as_tensor(np.asarray(vertex_colors, np.float32), device=device)
        base = torch.sum(hits.bary[..., None] * vc[face_verts_idx], -2)
    else:
        base = torch.full((origins.shape[0], 3), 0.7, dtype=torch.float32, device=device)
    rgb = _shade(verts, faces_t, hits, base, dirs, bg_color)
    img = torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8).reshape(h, w, 3).cpu().numpy()
    if return_depth:
        depth = torch.where(hits.hit, hits.t, torch.zeros_like(hits.t))
        return img, depth.reshape(h, w).cpu().numpy()
    return img


@torch.no_grad()
def get_warp(canonical_vertices, goal_vertices, faces, camera_transform, h: int, w: int,
             camera_angle_x: float, device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """(warp [h, w, 3], depth [h, w]) float32 numpy: for each pixel's closest
    goal-mesh hit, the canonical point minus the goal point, and the hit's
    distance from the camera along the unit ray; zeros where the ray misses."""
    origins, dirs = pixel_rays(camera_transform, h, w, camera_angle_x, device)
    faces_t = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)
    goal = torch.as_tensor(np.asarray(goal_vertices, np.float32), device=device)
    canonical = torch.as_tensor(np.asarray(canonical_vertices, np.float32), device=device)
    hits = raymesh.intersect_rays(origins, dirs, goal, faces_t)
    t = torch.where(hits.hit, hits.t, torch.zeros_like(hits.t))
    goal_pts = origins + dirs * t[:, None]
    canon_pts = raymesh.barycentric_transfer(hits, faces_t, canonical)
    warp = torch.where(hits.hit[:, None], canon_pts - goal_pts, torch.zeros_like(goal_pts))
    return (warp.reshape(h, w, 3).cpu().numpy().astype(np.float32),
            t.reshape(h, w).cpu().numpy().astype(np.float32))
