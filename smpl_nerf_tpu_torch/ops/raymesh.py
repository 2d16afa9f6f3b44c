"""Batched ray-mesh intersection, Möller–Trumbore (counterpart of
smpl_nerf_tpu/ops/raymesh.py: `RayHits` and `intersect_rays`).

Image-wise training intersects every ray of an image with the mesh at the
currently estimated pose to place its coarse samples. The SMPL-sized meshes
(6,000-14,000 faces) are brute-forced: rays in chunks of `chunk_size` against
all faces, so the [C, F] work tensor stays bounded. The rest of the JAX file
serves dataset generation, which is not ported yet.
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
