"""Vertex-distance attention warps of the dynamic families (counterpart of
smpl_nerf_tpu/ops/vertex_attention.py).

  dist[r,s,v] = || sample[r,s] - goal_vertex[r,v] ||
  att[r,s,v]  = relu(warp_radius - dist) * warp_temperature
  w[r,s,:]    = modified_softmax(att)      (the max is GLOBAL over the whole
                                            batch; a zero activation maps to
                                            exactly zero weight)
  warp[r,s,:] = sum_v w[r,s,v] * warp_vec[r,v]

The V axis runs in chunks of `chunk_size`, as the JAX package's `lax.scan`
does, so memory stays O(R*S*chunk) instead of O(R*S*V). The global max M
comes from a first, distance-only pass; the second pass accumulates
sum_v exp(att - M) and sum_v exp(att - M) * warp_v, and the -exp(-M) term of
the modified softmax is applied once at the end. A per-chunk or per-row max
would change the numbers: at the default temperature (1e4) an attention logit
is a distance times 1e4.

This runs outside any kernel in the JAX package too; plain PyTorch is its port.
`calls` counts the calls of `vertex_attention_warp`, `pairs` the (sample,
vertex) pairs R*S*V they took, from the shapes (no device sync).
"""
from __future__ import annotations

import torch

calls = 0             # vertex_attention_warp calls
pairs = 0             # (sample, vertex) pairs they attended over


def _dist(samples: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """[R, S, 3] x [R | 1, C, 3] -> [R, S, C] euclidean distances (floored
    at 1e-12, so the gradient stays finite on a vertex)."""
    diff = samples[:, :, None, :] - verts[:, None, :, :]
    return torch.sqrt(torch.clamp(torch.sum(diff * diff, -1), min=1e-24))


def vertex_attention_warp(samples: torch.Tensor, goal_vertices: torch.Tensor,
                          warp_vectors: torch.Tensor, warp_radius: float,
                          warp_temperature: float, chunk_size: int = 512) -> torch.Tensor:
    """Per-sample warp by modified-softmax attention over the goal-mesh vertices.

    samples [R, S, 3]; goal_vertices [R, V, 3] (each ray's goal mesh);
    warp_vectors [R, V, 3] (canonical - goal, per vertex). Returns [R, S, 3].
    """
    global calls, pairs
    R, S, _ = samples.shape
    V = goal_vertices.shape[1]
    calls += 1
    pairs += R * S * V
    chunks = [slice(lo, min(lo + chunk_size, V)) for lo in range(0, V, chunk_size)]

    def att(c):
        return torch.relu(warp_radius - _dist(samples, goal_vertices[:, c])) * warp_temperature

    # pass 1: the global max (att >= 0, so the max starts at 0)
    m = torch.zeros((), device=samples.device)
    for c in chunks:
        m = torch.maximum(m, att(c).max())
    # pass 2: sum(exp(att - m)) and sum(exp(att - m) * warp)
    s_exp = torch.zeros((R, S), device=samples.device)
    s_warp = torch.zeros((R, S, 3), device=samples.device)
    for c in chunks:
        e = torch.exp(att(c) - m)                                       # [R, S, C]
        s_exp = s_exp + e.sum(-1)
        s_warp = s_warp + torch.bmm(e, warp_vectors[:, c])
    # modified softmax: the -exp(-m) per vertex, on the weighted sum only
    # (the normaliser is sum(exp(att - m)) as it stands)
    corr = torch.exp(-m)
    numer = s_warp - corr * warp_vectors.sum(1)[:, None, :]
    # outside every vertex sphere with a large m, exp(-m) underflows and the
    # 0/0 of the formula becomes 0 warp, its limit
    return numer / torch.clamp(s_exp[..., None], min=1e-30)


def relu_attention_warp(samples: torch.Tensor, goal_vertices: torch.Tensor,
                        warp_vectors: torch.Tensor, warp_radius,
                        chunk_size: int = 512) -> torch.Tensor:
    """Normalised-ReLU vertex attention (the image-wise family's variant):
    att = relu(warp_radius - dist), w = att / (sum_v att + 1e-5).

    samples [R, S, 3]; goal_vertices [V, 3] and warp_vectors [V, 3] (one mesh).
    Differentiable in the vertices, so the gradient reaches the estimated pose
    through LBS.
    """
    R, S, _ = samples.shape
    V = goal_vertices.shape[0]
    s_att = torch.zeros((R, S), device=samples.device)
    s_warp = torch.zeros((R, S, 3), device=samples.device)
    for lo in range(0, V, chunk_size):
        c = slice(lo, min(lo + chunk_size, V))
        a = torch.relu(warp_radius - _dist(samples, goal_vertices[None, c]))   # [R, S, C]
        s_att = s_att + a.sum(-1)
        s_warp = s_warp + a @ warp_vectors[c]
    return s_warp / (s_att[..., None] + 1e-5)
