"""Ground-truth per-sample warps by vertex-sphere assignment (counterpart of
smpl_nerf_tpu/ops/vertex_sphere.py).

For each ray sample, the nearest goal-mesh vertex: when it lies strictly
within `radius`, the sample warps like that vertex (canonical - goal), else by
0. With `by_mean` the warp is instead the mean of the warps of every vertex
whose sphere holds the sample (strict `<` again).

Two functions, with two nearest-vertex rules that differ in the JAX package
and stay different here:
  * `sample_warps_by_vertex_sphere` (the loader's precompute path, one mesh):
    the nearest vertex by argmin, the first index among equal distances;
  * `sample_warps_by_vertex_sphere_rays` (the in-step path, a mesh per ray):
    the mean of the warps of every vertex at the smallest distance (a one-hot
    matrix product in JAX).
Both run the vertex axis in chunks of `chunk_size`, padded with vertices at
1e6, and an earlier chunk keeps a tie with a later one (strict `<`). Memory is
O(rows * chunk): the precompute path also cuts the samples into blocks of
`row_block`; the in-step path holds [R, S, chunk, 3] differences, as
ops/vertex_attention.py does. Plain PyTorch: the JAX package runs this as
plain XLA, no Pallas.
"""
from __future__ import annotations

import torch

PAD_COORD = 1e6


def _padded_chunks(goal_vertices: torch.Tensor, warp_vectors: torch.Tensor, chunk_size: int):
    """[(verts [.., C, 3], warps [.., C, 3])] over the vertex axis (-2), the
    last chunk padded to C with vertices at PAD_COORD and zero warps."""
    V = goal_vertices.shape[-2]
    pad = (-V) % chunk_size
    if pad:
        shape = goal_vertices.shape[:-2] + (pad, 3)
        goal_vertices = torch.cat([goal_vertices, goal_vertices.new_full(shape, PAD_COORD)], -2)
        warp_vectors = torch.cat([warp_vectors, warp_vectors.new_zeros(shape)], -2)
    return [(goal_vertices[..., lo:lo + chunk_size, :], warp_vectors[..., lo:lo + chunk_size, :])
            for lo in range(0, V + pad, chunk_size)]


def _norm(diff: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(diff * diff, -1))


@torch.no_grad()
def sample_warps_by_vertex_sphere(samples: torch.Tensor, goal_vertices: torch.Tensor,
                                  warp_vectors: torch.Tensor, radius: float,
                                  by_mean: bool = False, chunk_size: int = 512,
                                  row_block: int = 65536) -> torch.Tensor:
    """samples [R, S, 3], goal_vertices [V, 3], warp_vectors [V, 3] -> [R, S, 3]."""
    R, S, _ = samples.shape
    flat = samples.reshape(R * S, 3)
    chunks = _padded_chunks(goal_vertices, warp_vectors, chunk_size)
    out = torch.empty_like(flat)
    for lo in range(0, R * S, row_block):
        rows = flat[lo:lo + row_block]
        n = rows.shape[0]
        if by_mean:
            s_warp = rows.new_zeros((n, 3))
            s_count = rows.new_zeros((n,))
            for verts, warps in chunks:
                inside = (_norm(rows[:, None, :] - verts[None]) < radius).float()    # [n, C]
                s_warp = s_warp + inside @ warps
                s_count = s_count + inside.sum(-1)
            out[lo:lo + n] = s_warp / (s_count[:, None] + 1e-10)
            continue
        best_d = rows.new_full((n,), float("inf"))
        best_w = rows.new_zeros((n, 3))
        for verts, warps in chunks:
            dmin, arg = torch.min(_norm(rows[:, None, :] - verts[None]), -1)   # first index
            better = dmin < best_d
            best_w = torch.where(better[:, None], warps[arg], best_w)
            best_d = torch.minimum(best_d, dmin)
        out[lo:lo + n] = torch.where((best_d < radius)[:, None], best_w, torch.zeros_like(best_w))
    return out.reshape(R, S, 3)


@torch.no_grad()
def sample_warps_by_vertex_sphere_rays(samples: torch.Tensor, goal_vertices: torch.Tensor,
                                       warp_vectors: torch.Tensor, radius: float,
                                       by_mean: bool = False,
                                       chunk_size: int = 512) -> torch.Tensor:
    """A goal mesh per ray: samples [R, S, 3], goal_vertices [R, V, 3],
    warp_vectors [R, V, 3] -> [R, S, 3]."""
    R, S, _ = samples.shape
    chunks = _padded_chunks(goal_vertices, warp_vectors, chunk_size)

    def dist(verts):
        return _norm(samples[:, :, None, :] - verts[:, None, :, :])              # [R, S, C]

    if by_mean:
        s_warp = samples.new_zeros((R, S, 3))
        s_count = samples.new_zeros((R, S))
        for verts, warps in chunks:
            inside = (dist(verts) < radius).float()
            s_warp = s_warp + torch.bmm(inside, warps)
            s_count = s_count + inside.sum(-1)
        return s_warp / (s_count[..., None] + 1e-10)
    best_d = samples.new_full((R, S), float("inf"))
    best_w = samples.new_zeros((R, S, 3))
    for verts, warps in chunks:
        d = dist(verts)
        dmin = d.min(-1).values
        sel = (d == dmin[..., None]).float()
        sel = sel / sel.sum(-1, keepdim=True)                     # the mean over ties
        wmin = torch.bmm(sel, warps)
        better = dmin < best_d
        best_w = torch.where(better[..., None], wmin, best_w)
        best_d = torch.minimum(best_d, dmin)
    return torch.where((best_d < radius)[..., None], best_w, torch.zeros_like(best_w))
