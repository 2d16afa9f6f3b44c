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
mesh for every ray, differentiable in all three inputs (its backward carries
the pose gradient through the goal vertices). CPU tensors take
`relu_attention_eager`, the plain chunked version the CPU tests hold against
the JAX package; CUDA tensors take `relu_attention_cuda`, an autograd.Function
over csrc/relu_attention.cu (kernel H: a sample-major forward, a vertex-major
backward; see the source), float32 only and with no fallback.
`relu_attention_backward_plain` states H's closed-form backward in plain
PyTorch: the gradient's oracle.

`calls` counts the calls of `vertex_attention_warp`, `pairs` the (sample,
vertex) pairs R*S*V they took, from the shapes (no device sync); `launches`
the calls the kernel took; `relu_calls` and `relu_pairs` the same two counts
of `relu_attention_warp` (R*S*V with its one mesh's V), `relu_launches` the
calls kernel H's forward took.
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
relu_launches = 0     # relu_attention_warp calls kernel H's forward took


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
    through LBS. Counted in `relu_calls` / `relu_pairs` (from the shapes). CUDA
    tensors take kernel H (`relu_attention_cuda`), CPU tensors the eager
    version (`chunk_size` is its).
    """
    global relu_calls, relu_pairs
    R, S, _ = samples.shape
    V = goal_vertices.shape[0]
    relu_calls += 1
    relu_pairs += R * S * V
    if samples.is_cuda:
        return relu_attention_cuda(samples, goal_vertices, warp_vectors, warp_radius)
    return relu_attention_eager(samples, goal_vertices, warp_vectors, warp_radius, chunk_size)


def relu_attention_eager(samples: torch.Tensor, goal_vertices: torch.Tensor,
                         warp_vectors: torch.Tensor, warp_radius,
                         chunk_size: int = 512) -> torch.Tensor:
    """The plain PyTorch version, differentiable: one pass over chunks of
    `chunk_size` vertices."""
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


def relu_attention_backward_plain(samples: torch.Tensor, goal_vertices: torch.Tensor,
                                  warp_vectors: torch.Tensor, warp_radius,
                                  grad_out: torch.Tensor, chunk_size: int = 512) -> tuple:
    """Kernel H's closed-form backward in plain PyTorch, in chunks of vertices:
    (dL/dsamples [R, S, 3], dL/dgoal [V, 3], dL/dwarps [V, 3]) given
    grad_out = dL/dout [R, S, 3]. With D = sum_v a + 1e-5, gw = g / D,
    ga = -(g . out) / D and, over the pairs with a > 0, c = gw . w_v + ga:
    dL/dw_v = sum_n a gw_n, dL/dv = sum_n c (s_n - v) / d, dL/ds_n = -sum_v
    c (s_n - v) / d, the last two 0 where d^2 < 1e-24 (the clamp's gradient)."""
    V = goal_vertices.shape[0]
    chunks = [slice(lo, min(lo + chunk_size, V)) for lo in range(0, V, chunk_size)]

    def pairs(c):
        diff = samples[:, :, None, :] - goal_vertices[c]                     # s - v
        d2 = torch.sum(diff * diff, -1)
        d = torch.sqrt(torch.clamp(d2, min=1e-24))
        return diff, d2, d, torch.relu(warp_radius - d)

    s_att = torch.zeros(samples.shape[:2], dtype=samples.dtype, device=samples.device)
    s_warp = torch.zeros_like(samples)
    for c in chunks:
        a = pairs(c)[3]
        s_att = s_att + a.sum(-1)
        s_warp = s_warp + a @ warp_vectors[c]
    D = s_att + 1e-5
    out = s_warp / D[..., None]
    gw = grad_out / D[..., None]
    ga = -(grad_out * out).sum(-1) / D
    d_samples = torch.zeros_like(samples)
    d_goal = torch.zeros_like(goal_vertices)
    d_warps = torch.zeros_like(warp_vectors)
    for c in chunks:
        diff, d2, d, a = pairs(c)
        d_warps[c] = torch.einsum("rsv,rsk->vk", a, gw)
        coef = torch.where(a > 0, gw @ warp_vectors[c].T + ga[..., None], 0.0)
        f = torch.where(d2 >= 1e-24, coef / d, 0.0)
        term = f[..., None] * diff                                             # [R, S, C, 3]
        d_goal[c] = term.sum((0, 1))
        d_samples = d_samples - term.sum(2)
    return d_samples, d_goal, d_warps


@functools.cache
def _relu_lib() -> ctypes.CDLL:
    lib = _build.load("relu_attention")
    lib.relu_attention_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.relu_attention_workspace_floats.restype = ctypes.c_longlong
    lib.relu_attention_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.relu_attention_forward.restype = ctypes.c_int
    lib.relu_attention_backward.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.relu_attention_backward.restype = ctypes.c_int
    return lib


class _ReluAttention(torch.autograd.Function):
    """Kernel H: the forward saves the inputs, out and sum_v a ([N] floats),
    no [N, V] array; the backward launches the vertex-major kernel and its
    reduction for the vertices' gradients, and the sample-major one for the
    samples' only when they need one."""

    @staticmethod
    def forward(ctx, samples, goal_vertices, warp_vectors, radius):
        s, g, w = (t.contiguous() for t in (samples, goal_vertices, warp_vectors))
        R, S, _ = s.shape
        out = torch.empty((R, S, 3), dtype=torch.float32, device=s.device)
        s_att = torch.empty((R, S), dtype=torch.float32, device=s.device)
        lib = _relu_lib()
        err = lib.relu_attention_forward(s.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
                                         s_att.data_ptr(), R * S, g.shape[0], radius,
                                         _build.current_stream(s.device))
        _build.check(lib, err, "relu_attention forward")
        ctx.save_for_backward(s, g, w, out, s_att)
        ctx.radius = radius
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        s, g, w, out, s_att = ctx.saved_tensors
        need_s, need_g, need_w = ctx.needs_input_grad[:3]
        N, V = s.shape[0] * s.shape[1], g.shape[0]
        grad_s = torch.empty_like(s) if need_s else None
        grad_g = torch.empty_like(g) if need_g else None
        grad_w = torch.empty_like(w) if need_w else None
        lib = _relu_lib()
        workspace = None
        if need_g or need_w:
            workspace = torch.empty(lib.relu_attention_workspace_floats(N, V),
                                    dtype=torch.float32, device=s.device)
        go = grad_out.contiguous()
        ptr = lambda t: 0 if t is None else t.data_ptr()
        err = lib.relu_attention_backward(s.data_ptr(), g.data_ptr(), w.data_ptr(),
                                          go.data_ptr(), out.data_ptr(),
                                          s_att.data_ptr(), ptr(grad_s), ptr(grad_g), ptr(grad_w),
                                          ptr(workspace), N, V, ctx.radius,
                                          _build.current_stream(s.device))
        _build.check(lib, err, "relu_attention backward")
        return grad_s, grad_g, grad_w, None


def relu_attention_cuda(samples: torch.Tensor, goal_vertices: torch.Tensor,
                        warp_vectors: torch.Tensor, warp_radius) -> torch.Tensor:
    """Kernel H: samples [R, S, 3], goal_vertices and warp_vectors [V, 3]
    (float32, one CUDA device; strided inputs are copied contiguous) -> warps
    [R, S, 3], differentiable in all three. `warp_radius`: a number, or a
    tensor that needs no gradient."""
    global relu_launches
    inputs = (samples, goal_vertices, warp_vectors)
    if any(t.dtype != torch.float32 for t in inputs):
        raise TypeError(f"relu_attention_cuda takes float32, got "
                        f"{[str(t.dtype) for t in inputs]}")
    V = goal_vertices.shape[0] if goal_vertices.dim() == 2 else -1
    if (samples.dim() != 3 or samples.shape[2] != 3 or goal_vertices.shape != (V, 3)
            or warp_vectors.shape != (V, 3)):
        raise ValueError(f"relu_attention_cuda takes samples [R, S, 3] and goal_vertices, "
                         f"warp_vectors [V, 3], got {[tuple(t.shape) for t in inputs]}")
    if isinstance(warp_radius, torch.Tensor) and warp_radius.requires_grad:
        raise ValueError("relu_attention_cuda takes no gradient in the radius: pass a number "
                         "or a tensor that needs none")
    radius = float(warp_radius)
    if not math.isfinite(radius):
        raise ValueError(f"relu_attention_cuda takes a finite radius, got {radius}")
    device = samples.device
    if device.type != "cuda" or any(t.device != device for t in inputs):
        raise ValueError(f"relu_attention_cuda needs its inputs on one CUDA device, got "
                         f"{[str(t.device) for t in inputs]}")
    out = _ReluAttention.apply(samples, goal_vertices, warp_vectors, radius)
    relu_launches += 1
    return out
