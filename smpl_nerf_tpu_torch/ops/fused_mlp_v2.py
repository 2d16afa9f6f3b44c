"""Fused RenderRayNet v2: encoding inside the kernel (csrc/fused_mlp_v2_fwd.cu).

Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_forward.
The kernel reads raw rows [prefix (add) || xyz(3) || unit dir(3)] (24 B per
sample without a prefix), builds both encodings as

    enc(x) = sin(x @ M + P),  M[d, 2L*d] with 2^k on the (j mod d) row,
    P = 0 for sin blocks, pi/2 for cos blocks   (cos(t) == sin(t + pi/2))

in the reference block order [sin f0 | cos f0 | sin f1 | ...], puts the bf16
prefix ahead of the position encoding (the first layer's and every skip
layer's input), runs the whole RenderRayNet in bf16 with float32
accumulation, and writes [N, 4] = rgb || sigma. `reference_forward_raw` is
its plain PyTorch version (same math as the JAX `_tile_forward`).

What bounds it on the H100: tensor-core operations. The W=256 net costs
607,872 multiply-adds per sample against 40 bytes of input and output, far
above the ~295 operations per byte where bf16 matmuls stop being memory-bound.

Design (csrc/render_net.cuh, the mainloop kernel D runs too): the TPU kernel
keeps every weight resident in a 16 MB VMEM; an H100 SM has 227 KB of shared
memory, so a persistent block walks 128-row tiles and streams the weights
from L2 as the 64-row chunk images of `pack_weights_d` through an mbarrier
ring, while two consumer warpgroups run wgmma with the activations in
registers. The producer warpgroup encodes each tile's raw rows into the A
chunks of the layers that read the encodings, and rounds the prefix columns
into the leading chunks of the prefix+pos block (kernel D's pack: one pack
for B, C and D). The pack is built once per model and cached on the module.

`FusedMlpV2` is the autograd Function of `--use_fused_mlp=2` on the card:
forward kernel B, backward kernel C (csrc/fused_mlp_v2_bwd.cu, replacing the
TPU kernel `_pallas_backward`): per 128-row tile it recomputes the forward
and runs the dH chain on wgmma (Wᵀ is the same chunk images through wgmma's
transpose bit), writing dX and every layer's bf16 input and cotangent to a
scratch (dX's prefix columns are the bf16 sum of the first and skip layers'
cotangents on them, as float32); a split-K wgmma GEMM over the rows then
forms dW (rounded to bf16
per 256-row slice, as the JAX kernel's tiles round) and db, and a last pass
sums the splits in a fixed order. No atomics: the gradients are the same
bits on every run. `reference_backward_raw` is its plain version:
`torch.autograd.grad` through `reference_forward_raw`. `launches` counts
launches of B, `launches_bwd` of C; `rows` the rows B's launches took.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.ops import _build
from smpl_nerf_tpu_torch.ops.fused_mlp import (D_CHUNK, D_TILE_ROWS, MlpSpec, flatten_params,
                                               grad_count_d, packed, pack_weights_d,
                                               padded_width, round_through, skip_mask,
                                               topology_reason, trunk_forward, unpack_grads_d)

launches = 0          # kernel B (forward)
launches_bwd = 0      # kernel C (backward)
rows = 0              # rows kernel B took


def encoding_matrices(d: int, n_freqs: int) -> Tuple[np.ndarray, np.ndarray]:
    """(M [d, 2L*d], P [2L*d]) with enc(x) = sin(x @ M + P) in reference order
    [sin f0 | cos f0 | sin f1 | cos f1 | ...], each block spanning d dims."""
    M = np.zeros((d, 2 * n_freqs * d), np.float32)
    P = np.zeros((2 * n_freqs * d,), np.float32)
    for k in range(n_freqs):
        f = 2.0 ** k
        for trig in range(2):  # 0 = sin, 1 = cos
            base = (2 * k + trig) * d
            for j in range(d):
                M[j, base + j] = f
            if trig == 1:
                P[base:base + d] = np.pi / 2
    return M, P


def _spec_freqs(spec: MlpSpec) -> Tuple[int, int]:
    """Frequency counts implied by the encoded dims (3 coords, no identity)."""
    if spec.positions_dim % 6 or spec.directions_dim % 6:
        raise ValueError("v2 supports 3-coord sin/cos encodings without identity")
    return spec.positions_dim // 6, spec.directions_dim // 6


def raw_in_dim(spec: MlpSpec) -> int:
    return spec.additional_input_dim + 6


def _tile_forward(spec: MlpSpec, enc_mats, flat, x_raw: torch.Tensor,
                  exact: bool = False) -> torch.Tensor:
    """Forward on raw rows [N, add+6]: encode, then the RenderRayNet body
    (exact: see `trunk_forward`)."""
    cdt = spec.torch_dtype
    Mp, Pp, Md, Pd = enc_mats
    add = spec.additional_input_dim
    pos_e = torch.sin(x_raw[:, add:add + 3] @ Mp + Pp)
    dir_e = torch.sin(x_raw[:, add + 3:add + 6] @ Md + Pd)
    if exact:
        pos, dirs = round_through(pos_e, cdt), round_through(dir_e, cdt)
        if add:
            pos = torch.cat([round_through(x_raw[:, :add], cdt), pos], -1)
        return trunk_forward(spec, flat, pos, dirs, exact=True)
    pos = pos_e.to(cdt)
    if add:
        pos = torch.cat([x_raw[:, :add].to(cdt), pos], -1)
    return trunk_forward(spec, flat, pos, dir_e.to(cdt))


def _encoding_mats(spec: MlpSpec, device, dtype=torch.float32):
    pos_f, dir_f = _spec_freqs(spec)
    return tuple(torch.as_tensor(m, device=device, dtype=dtype)
                 for m in (*encoding_matrices(3, pos_f), *encoding_matrices(3, dir_f)))


def reference_forward_raw(spec: MlpSpec, flat, x_raw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the v2 kernel: raw rows [N, add+6] -> [N, 4]."""
    return _tile_forward(spec, _encoding_mats(spec, x_raw.device), flat, x_raw)


def supports(spec: MlpSpec, pos_encoder, dir_encoder) -> bool:
    """v2 handles 3-coord sin/cos encoders without identity blocks."""
    return (not pos_encoder.include_identity
            and not dir_encoder.include_identity
            and pos_encoder.number_frequencies * 6 == spec.positions_dim
            and dir_encoder.number_frequencies * 6 == spec.directions_dim)


def reference_backward_raw(spec: MlpSpec, flat, x_raw: torch.Tensor, g: torch.Tensor):
    """Plain PyTorch version of the v2 backward kernel: (dflat, dx) for the
    output cotangent g [N, 4], by autograd through `reference_forward_raw`.

    dflat follows `flat` ((d kernel [in, out], d bias) pairs), dx is [N, add+6].
    """
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x_raw, *flat)]
        y = reference_forward_raw(spec, leaves[1:], leaves[0])
        dx, *dflat = torch.autograd.grad(y, leaves, g)
    return tuple(dflat), dx


def exact_backward_dx(spec: MlpSpec, flat, x_raw: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx [N, add+6] of the plain forward's values in float64, every bf16
    rounding passed straight through (`trunk_forward(exact=True)`): the
    gradient that kernel C and `reference_backward_raw` both approximate,
    each rounding the cotangents to bf16 in its own order. Through the
    encoding's 2^9 frequencies one such rounding can move a row's dx by a
    good part of the largest row's, in either approximation."""
    with torch.enable_grad():
        x = x_raw.detach().double().requires_grad_(True)
        y = _tile_forward(spec, _encoding_mats(spec, x.device, torch.float64), flat, x,
                          exact=True)
        return torch.autograd.grad(y, x, g.double())[0]


def shared_bytes(spec: MlpSpec, backward: bool = False) -> int:
    """Dynamic shared memory of one block of kernel B, or of C's first phase
    (render_net.cuh's Cfg): a ring of 3 (padded width 256) or 4 (128) stages
    of a weight chunk and a 128 x 64 bf16 A chunk, the mbarriers and 1024 B of
    alignment slack; C adds a 64 x W bf16 staging tile per consumer
    warpgroup. The depth, the prefix and the encodings do not enter: every
    block of K streams, and the producer rounds prefix columns straight from
    device memory into the A chunk."""
    WP = padded_width(spec)
    stages = 3 if WP == 256 else 4
    staging = 2 * 64 * WP * 2 if backward else 0
    return stages * (D_CHUNK * WP * 2 + D_TILE_ROWS * D_CHUNK * 2) + staging + 2 * stages * 8 + 1024


def kernel_supports(spec: MlpSpec) -> str:
    """'' if the CUDA kernels B and C take this net, else the reason they do not."""
    reason = topology_reason(spec)
    if reason:
        return reason
    if spec.positions_dim <= 0 or spec.directions_dim <= 0:
        return "the kernel needs positional and directional encodings"
    return ""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_v2_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_v2_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_uint, i, p]
    lib.fused_mlp_v2_fwd_launch.restype = ctypes.c_int
    lib.fused_mlp_v2_fwd_shared_bytes.argtypes = [i]
    lib.fused_mlp_v2_fwd_shared_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_v2_bwd")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.fused_mlp_v2_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, u, i, p]
    lib.fused_mlp_v2_bwd_launch.restype = ctypes.c_int
    lib.fused_mlp_v2_bwd_sizes.argtypes = [i, i, i, i, i, i, u, i,
                                           ctypes.POINTER(ctypes.c_longlong)]
    lib.fused_mlp_v2_bwd_sizes.restype = ctypes.c_int
    lib.fused_mlp_v2_bwd_shared_bytes.argtypes = [i]
    lib.fused_mlp_v2_bwd_shared_bytes.restype = ctypes.c_int
    return lib


def _check_rows(spec: MlpSpec, x_raw: torch.Tensor) -> None:
    reason = kernel_supports(spec)
    if reason:
        raise ValueError(reason)
    if x_raw.device.type != "cuda" or x_raw.dtype != torch.float32:
        raise ValueError(f"fused v2 kernel takes float32 CUDA rows, got {x_raw.dtype} "
                         f"on {x_raw.device}")
    if x_raw.dim() != 2 or x_raw.shape[1] != raw_in_dim(spec) or not x_raw.is_contiguous():
        raise ValueError(f"fused v2 kernel takes contiguous [N, {raw_in_dim(spec)}] rows, "
                         f"got {tuple(x_raw.shape)}")


def _net_args(spec: MlpSpec):
    pos_f, dir_f = _spec_freqs(spec)
    return (spec.n_layers, spec.width, spec.additional_input_dim, pos_f, dir_f,
            skip_mask(spec), int(spec.use_directional_input))


def fused_forward_cuda(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor) -> torch.Tensor:
    """Launch kernel B on raw rows [N, add + 6] (float32, CUDA) -> [N, 4] float32."""
    global launches, rows
    _check_rows(spec, x_raw)
    w, b, heads = packed(spec, net, x_raw.device, pack_weights_d)
    N = x_raw.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x_raw.device)
    if N == 0:
        return out
    lib = _lib()
    stream = _build.current_stream(x_raw.device)
    err = lib.fused_mlp_v2_fwd_launch(x_raw.data_ptr(), out.data_ptr(), w.data_ptr(),
                                      b.data_ptr(), heads.data_ptr(), N, *_net_args(spec),
                                      stream)
    _build.check(lib, err, "fused_mlp_v2_fwd")
    launches += 1
    rows += N
    return out


def workspace_bytes(spec: MlpSpec, N: int) -> int:
    """Device memory kernel C borrows for N rows (the wrapper's torch.empty):
    the bf16 scratch [N, ld] of every layer's input and cotangent (and of
    the prefix+pos and dir blocks), the per-block ReLU bits and d-encoding
    buffers, the per-split partial sums."""
    sizes = (ctypes.c_longlong * 2)()
    lib = _lib_bwd()
    _build.check(lib, lib.fused_mlp_v2_bwd_sizes(N, *_net_args(spec), sizes), "fused_mlp_v2_bwd")
    if sizes[1] != grad_count_d(spec):
        raise RuntimeError(f"kernel C counts {sizes[1]} gradients, grad_count_d "
                           f"{grad_count_d(spec)}")
    return int(sizes[0])


def fused_backward_cuda(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor,
                        g: torch.Tensor):
    """Launch kernel C: (dflat, dx) for raw rows [N, add + 6] and cotangent g [N, 4].

    dflat are float32 (d kernel [in, out], d bias) pairs in `_param_order`
    (views of one gradient buffer), dx is [N, add + 6] float32.
    """
    global launches_bwd
    _check_rows(spec, x_raw)
    N = x_raw.shape[0]
    if (g.device != x_raw.device or g.dtype != torch.float32 or tuple(g.shape) != (N, 4)
            or not g.is_contiguous()):
        raise ValueError(f"fused v2 backward takes a contiguous float32 [N, 4] cotangent on "
                         f"{x_raw.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    device = x_raw.device
    w, b, heads = packed(spec, net, device, pack_weights_d)
    dx = torch.empty((N, raw_in_dim(spec)), dtype=torch.float32, device=device)
    if N == 0:
        grads = torch.zeros(grad_count_d(spec), dtype=torch.float32, device=device)
        return unpack_grads_d(spec, grads), dx
    grads = torch.empty(grad_count_d(spec), dtype=torch.float32, device=device)
    workspace = torch.empty(workspace_bytes(spec, N), dtype=torch.uint8, device=device)
    lib = _lib_bwd()
    stream = _build.current_stream(device)
    err = lib.fused_mlp_v2_bwd_launch(
        x_raw.data_ptr(), g.data_ptr(), dx.data_ptr(), grads.data_ptr(), workspace.data_ptr(),
        w.data_ptr(), b.data_ptr(), heads.data_ptr(), N, *_net_args(spec), stream)
    _build.check(lib, err, "fused_mlp_v2_bwd")
    launches_bwd += 1
    return unpack_grads_d(spec, grads), dx


class FusedMlpV2(torch.autograd.Function):
    """Forward: kernel B. Backward: kernel C, which returns the gradient of
    every kernel and bias and of the raw rows, prefix columns included (an
    embedding that makes the prefix trains through them)."""

    @staticmethod
    def forward(ctx, spec, net, x_raw, *flat):
        ctx.spec, ctx.net = spec, net
        ctx.save_for_backward(x_raw)
        return fused_forward_cuda(spec, net, x_raw.detach())

    @staticmethod
    def backward(ctx, g):
        (x_raw,) = ctx.saved_tensors
        dflat, dx = fused_backward_cuda(ctx.spec, ctx.net, x_raw.detach(), g.contiguous())
        needs = ctx.needs_input_grad[2:]
        return (None, None, *[t if need else None for t, need in zip((dx, *dflat), needs)])


def fused_apply_raw(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor) -> torch.Tensor:
    """Apply the net to RAW rows [N, additional || xyz(3) || unit dir(3)].

    CPU rows take the plain version; CUDA rows take the kernels (B forward,
    and C backward where a gradient is asked for).
    """
    flat = flatten_params(spec, net)
    if x_raw.device.type == "cpu":
        return reference_forward_raw(spec, flat, x_raw)
    return FusedMlpV2.apply(spec, net, x_raw, *flat)
