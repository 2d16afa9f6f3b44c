"""Batched ray-mesh intersection, Möller–Trumbore (counterpart of
smpl_nerf_tpu/ops/raymesh.py).

Four users: image-wise training intersects every ray of an image with the
mesh at the currently estimated pose to place its coarse samples; the dataset
generator (render/raytrace.py) shades, and computes depth and ground-truth
warps from, one closest hit per pixel (`barycentric_transfer` maps a hit onto
the canonical mesh); the vertex_sphere loader's z-prior places samples around
every entry and exit point of the body (`intersect_rays_multi`); and
`dependent_pixels` maps a pixel's canonical hit to the pixel it lands on under
the goal pose. The SMPL-sized meshes (6,000-14,000 faces) are brute-forced:
rays in chunks of `chunk_size` against all faces, so the [C, F] work tensor
stays bounded.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-9


class RayHits(NamedTuple):
    t: torch.Tensor          # [R] distance to the closest hit (inf if none)
    face_idx: torch.Tensor   # [R] index of the closest face hit (-1 if none)
    bary: torch.Tensor       # [R, 3] barycentric coordinates (w0, w1, w2) of the hit
    hit: torch.Tensor        # [R] bool


def _intersect_chunk(origins, dirs, v0, e1, e2):
    """Möller–Trumbore for a chunk of rays [C, 3] against all faces [F, 3]."""
    pvec = torch.linalg.cross(dirs[:, None, :].expand(-1, e2.shape[0], -1),
                              e2[None].expand(dirs.shape[0], -1, -1))        # [C, F, 3]
    det = torch.sum(e1[None] * pvec, -1)                                       # [C, F]
    ok = torch.abs(det) > _EPS
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = origins[:, None, :] - v0[None]                                      # [C, F, 3]
    u = torch.sum(tvec * pvec, -1) * inv_det
    qvec = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
    v = torch.sum(dirs[:, None, :] * qvec, -1) * inv_det
    t = torch.sum(e2[None] * qvec, -1) * inv_det
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-6)
    t = torch.where(valid, t, torch.full_like(t, float("inf")))
    t_best, best = torch.min(t, -1)
    u_best = torch.gather(u, 1, best[:, None])[:, 0]
    v_best = torch.gather(v, 1, best[:, None])[:, 0]
    hit = torch.isfinite(t_best)
    face_idx = torch.where(hit, best, torch.full_like(best, -1))
    bary = torch.stack([1.0 - u_best - v_best, u_best, v_best], -1)
    return t_best, face_idx, bary, hit


@torch.no_grad()
def intersect_rays(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
                   faces, chunk_size: int = 1024) -> RayHits:
    """Closest-hit intersection of R rays with a triangle mesh.

    origins / dirs [R, 3]; vertices [V, 3]; faces [F, 3] int. No gradient
    (image-wise training uses the hits as fixed sample positions).
    """
    faces = torch.as_tensor(faces, dtype=torch.long, device=vertices.device)
    tri = vertices[faces]                                                      # [F, 3, 3]
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    parts = [_intersect_chunk(origins[lo:lo + chunk_size], dirs[lo:lo + chunk_size],
                              v0, e1, e2) for lo in range(0, origins.shape[0], chunk_size)]
    return RayHits(*(torch.cat(p) for p in zip(*parts)))


def intersect_rays_multi(origins: torch.Tensor, dirs: torch.Tensor, vertices: torch.Tensor,
                         faces, max_hits: int = 4, chunk_size: int = 1024):
    """(t [R, max_hits], hit [R, max_hits] bool): up to `max_hits` hits per
    ray, nearest first, as distances along the original ray with the unit
    direction; misses are inf. Iterated closest hit, the origin advanced 1e-4
    past each hit."""
    dirs_unit = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    offset = torch.zeros(origins.shape[0], dtype=origins.dtype, device=origins.device)
    cur = origins
    ts, flags = [], []
    for _ in range(max_hits):
        hits = intersect_rays(cur, dirs_unit, vertices, faces,
                              chunk_size=min(chunk_size, origins.shape[0]))
        ts.append(torch.where(hits.hit, offset + hits.t, torch.full_like(hits.t, float("inf"))))
        flags.append(hits.hit)
        step = torch.where(hits.hit, hits.t + 1e-4, torch.zeros_like(hits.t))
        cur = cur + dirs_unit * step[:, None]
        offset = offset + step
    return torch.stack(ts, -1), torch.stack(flags, -1)


def barycentric_transfer(hits: RayHits, faces, target_vertices: torch.Tensor) -> torch.Tensor:
    """[R, 3] hit points carried onto another mesh of the same topology through
    each hit face's barycentric coordinates; zeros where a ray missed."""
    faces = torch.as_tensor(faces, dtype=torch.long, device=target_vertices.device)
    face_verts = target_vertices[faces[hits.face_idx.clamp(min=0)]]          # [R, 3, 3]
    pts = torch.sum(hits.bary[..., None] * face_verts, -2)
    return torch.where(hits.hit[:, None], pts, torch.zeros_like(pts))


def dependent_pixels(origins: torch.Tensor, dirs: torch.Tensor,
                     canonical_vertices: torch.Tensor, goal_vertices: torch.Tensor, faces,
                     camera_transform, h: int, w: int, focal: float):
    """(pixel_xy [R, 2] int32, in_frame [R] bool): the pixel each ray's
    canonical-mesh hit lands on when carried onto the goal mesh and projected
    through `camera_transform`; (-1, -1) where the ray misses or the point
    leaves the frame."""
    hits = intersect_rays(origins, dirs, canonical_vertices, faces,
                          chunk_size=min(1024, origins.shape[0]))
    goal_pts = barycentric_transfer(hits, faces, goal_vertices)
    cam = torch.as_tensor(camera_transform, dtype=torch.float32, device=goal_pts.device)
    vc = (goal_pts - cam[:3, 3]) @ cam[:3, :3]                                 # world -> camera
    x = -vc[:, 0] / vc[:, 2] * focal + w * 0.5
    y = vc[:, 1] / vc[:, 2] * focal + h * 0.5
    px = torch.stack([torch.round(x), torch.round(y)], -1).to(torch.int32)
    in_frame = ((px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0) & (px[:, 1] < h)
                & hits.hit)
    return torch.where(in_frame[:, None], px, torch.full_like(px, -1)), in_frame
