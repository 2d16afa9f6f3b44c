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

The JAX package runs this outside any kernel. On the card, a call with no
gradient to keep launches csrc/vertex_attention.cu (a grid-wide max pass, then
one fused pass over the vertices; see the source); a call whose inputs need
autograd (image_wise_dynamic's arm angles reach the goal vertices through
LBS), and every call on the CPU, takes the eager version below, which the CPU
tests hold against the JAX package. A CUDA call in another dtype than float32
raises: nothing falls back.

`relu_attention_warp` is image_wise_dynamic's normalised-ReLU attention: one
mesh for every ray, eager and differentiable on every device (its backward
carries the pose gradient through the goal vertices).

`calls` counts the calls of `vertex_attention_warp`, `pairs` the (sample,
vertex) pairs R*S*V they took, from the shapes (no device sync); `launches`
the calls the kernel took; `relu_calls` and `relu_pairs` the same two counts
of `relu_attention_warp` (R*S*V with its one mesh's V).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from smpl_nerf_tpu_torch.ops import _build

calls = 0             # vertex_attention_warp calls
pairs = 0             # (sample, vertex) pairs they attended over
launches = 0          # calls the kernel took
relu_calls = 0        # relu_attention_warp calls
relu_pairs = 0        # (sample, vertex) pairs they attended over


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
    CUDA inputs with no gradient to keep take the kernel, the rest the eager
    version (`chunk_size` is the eager version's).
    """
    global calls, pairs
    calls += 1
    pairs += samples.shape[0] * samples.shape[1] * goal_vertices.shape[1]
    inputs = (samples, goal_vertices, warp_vectors)
    if samples.is_cuda and not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return vertex_attention_cuda(*inputs, warp_radius, warp_temperature)
    return vertex_attention_eager(*inputs, warp_radius, warp_temperature, chunk_size)


def vertex_attention_eager(samples: torch.Tensor, goal_vertices: torch.Tensor,
                           warp_vectors: torch.Tensor, warp_radius: float,
                           warp_temperature: float, chunk_size: int = 512) -> torch.Tensor:
    """The plain PyTorch version, differentiable: two passes over chunks of
    `chunk_size` vertices."""
    R, S, _ = samples.shape
    V = goal_vertices.shape[1]
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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("vertex_attention")
    lib.vertex_attention_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    lib.vertex_attention_launch.restype = ctypes.c_int
    return lib


def vertex_attention_cuda(samples: torch.Tensor, goal_vertices: torch.Tensor,
                          warp_vectors: torch.Tensor, warp_radius: float,
                          warp_temperature: float) -> torch.Tensor:
    """Launch the kernel pair: samples [R, S, 3], goal_vertices and
    warp_vectors [R, V, 3] (float32, one CUDA device; strided inputs are
    copied contiguous) -> warps [R, S, 3]. No autograd."""
    global launches
    inputs = (samples, goal_vertices, warp_vectors)
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError(f"vertex_attention_cuda takes float32, got "
                        f"{[str(t.dtype) for t in inputs]}")
    device = samples.device
    if device.type != "cuda" or any(t.device != device for t in inputs):
        raise ValueError(f"vertex_attention_cuda needs its inputs on one CUDA device, got "
                         f"{[str(t.device) for t in inputs]}")
    R, V = goal_vertices.shape[:2]
    if (samples.dim() != 3 or samples.shape[0] != R or samples.shape[2] != 3
            or goal_vertices.shape != (R, V, 3) or warp_vectors.shape != (R, V, 3)):
        raise ValueError(f"vertex_attention_cuda takes samples [R, S, 3] and goal_vertices, "
                         f"warp_vectors [R, V, 3], got {[tuple(t.shape) for t in inputs]}")
    radius, temperature = float(warp_radius), float(warp_temperature)
    if not (math.isfinite(radius) and math.isfinite(temperature)):
        raise ValueError(f"vertex_attention_cuda takes a finite radius and temperature, got "
                         f"{radius}, {temperature}")
    S = samples.shape[1]
    out = torch.empty((R, S, 3), dtype=torch.float32, device=device)
    if R == 0 or S == 0:
        return out
    s, g, w = (t.contiguous() for t in inputs)
    word = torch.empty(1, dtype=torch.int32, device=device)
    lib = _lib()
    err = lib.vertex_attention_launch(s.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
                                      word.data_ptr(), R, S, V, radius, temperature,
                                      _build.current_stream(device))
    _build.check(lib, err, "vertex_attention")
    launches += 1
    return out


def relu_attention_warp(samples: torch.Tensor, goal_vertices: torch.Tensor,
                        warp_vectors: torch.Tensor, warp_radius,
                        chunk_size: int = 512) -> torch.Tensor:
    """Normalised-ReLU vertex attention (the image-wise family's variant):
    att = relu(warp_radius - dist), w = att / (sum_v att + 1e-5).

    samples [R, S, 3]; goal_vertices [V, 3] and warp_vectors [V, 3] (one mesh).
    Differentiable in the vertices, so the gradient reaches the estimated pose
    through LBS. Counted in `relu_calls` / `relu_pairs` (from the shapes).
    """
    global relu_calls, relu_pairs
    R, S, _ = samples.shape
    V = goal_vertices.shape[0]
    relu_calls += 1
    relu_pairs += R * S * V
    s_att = torch.zeros((R, S), device=samples.device)
    s_warp = torch.zeros((R, S, 3), device=samples.device)
    for lo in range(0, V, chunk_size):
        c = slice(lo, min(lo + chunk_size, V))
        a = torch.relu(warp_radius - _dist(samples, goal_vertices[None, c]))   # [R, S, C]
        s_att = s_att + a.sum(-1)
        s_warp = s_warp + a @ warp_vectors[c]
    return s_warp / (s_att[..., None] + 1e-5)
