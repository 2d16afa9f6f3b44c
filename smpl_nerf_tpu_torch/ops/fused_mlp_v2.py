"""Fused RenderRayNet v2 forward: encoding inside the kernel (csrc/fused_mlp_v2_fwd.cu).

Replaces the TPU kernel smpl_nerf_tpu/ops/fused_mlp_v2.py:_pallas_forward.
The kernel reads raw rows [xyz(3) || unit dir(3)] (24 B per sample), builds
both encodings in shared memory as

    enc(x) = sin(x @ M + P),  M[d, 2L*d] with 2^k on the (j mod d) row,
    P = 0 for sin blocks, pi/2 for cos blocks   (cos(t) == sin(t + pi/2))

in the reference block order [sin f0 | cos f0 | sin f1 | ...], runs the whole
RenderRayNet in bf16 with float32 accumulation, and writes [N, 4] = rgb || sigma.
`reference_forward_raw` is its plain PyTorch version (same math as the JAX
`_tile_forward`).

What bounds it on the H100: tensor-core operations. The W=256 net costs
607,872 multiply-adds per sample against 40 bytes of input and output, far
above the ~295 operations per byte where bf16 matmuls stop being memory-bound.

Why the weights stream: the TPU kernel keeps every weight resident in a 16 MB
VMEM. An H100 SM has 227 KB of shared memory and the W=256 net is ~1.2 MB in
bf16, so here a block owns a 64-row tile, keeps only its activations in shared
memory, and streams each layer's weights through shared memory in 32-row
K-chunks (they stay hot in the 50 MB L2 across blocks). The wrapper packs the
weights once per model (transposed to [K, N] bf16, K zero-padded to a
multiple of 16) and caches the pack on the module.

`FusedMlpV2` is the autograd Function of `--use_fused_mlp=2` on the card:
forward kernel B, backward kernel C (csrc/fused_mlp_v2_bwd.cu, replacing the
TPU kernel `_pallas_backward`): per tile it rebuilds the forward, walks the
layers backwards on tensor cores, writes dX (the warp field of smpl_nerf
trains through the rows) and adds every dW and db into global memory with
float32 atomics, so those sums are not bit-identical from run to run.
`reference_backward_raw` is its plain version: `torch.autograd.grad` through
`reference_forward_raw`. `launches` counts launches of B, `launches_bwd` of C.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.ops import _build
from smpl_nerf_tpu_torch.ops.fused_mlp import (TILE_ROWS, MlpSpec, flatten_params,
                                               packed, skip_mask,
                                               topology_reason, trunk_forward, unpack_grads)

launches = 0          # kernel B (forward)
launches_bwd = 0      # kernel C (backward)


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


def _tile_forward(spec: MlpSpec, enc_mats, flat, x_raw: torch.Tensor) -> torch.Tensor:
    """Forward on raw rows [N, add+6]: encode, then the RenderRayNet body."""
    cdt = spec.torch_dtype
    Mp, Pp, Md, Pd = enc_mats
    add = spec.additional_input_dim
    pos_e = torch.sin(x_raw[:, add:add + 3] @ Mp + Pp)
    dir_e = torch.sin(x_raw[:, add + 3:add + 6] @ Md + Pd)
    pos = pos_e.to(cdt)
    if add:
        pos = torch.cat([x_raw[:, :add].to(cdt), pos], -1)
    return trunk_forward(spec, flat, pos, dir_e.to(cdt))


def reference_forward_raw(spec: MlpSpec, flat, x_raw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the v2 kernel: raw rows [N, add+6] -> [N, 4]."""
    pos_f, dir_f = _spec_freqs(spec)
    mats = [torch.as_tensor(m, device=x_raw.device)
            for m in (*encoding_matrices(3, pos_f), *encoding_matrices(3, dir_f))]
    return _tile_forward(spec, tuple(mats), flat, x_raw)


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


def kernel_supports(spec: MlpSpec) -> str:
    """'' if the CUDA kernels B and C take this net, else the reason they do not."""
    reason = topology_reason(spec)
    if reason:
        return reason
    if spec.additional_input_dim:
        return ("prefix rows are not ported yet in the fused v2 CUDA kernels; a net with a "
                "conditioning prefix runs through --use_fused_mlp=1 (the v1 kernel) or 0")
    if spec.positions_dim <= 0 or spec.directions_dim <= 0:
        return "the kernel needs positional and directional encodings"
    return ""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_v2_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_v2_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_uint, i, p]
    lib.fused_mlp_v2_fwd_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_v2_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_v2_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                                            ctypes.c_uint, i, i, p]
    lib.fused_mlp_v2_bwd_launch.restype = ctypes.c_int
    lib.fused_mlp_v2_bwd_scratch_elems.argtypes = [i, i]
    lib.fused_mlp_v2_bwd_scratch_elems.restype = ctypes.c_int
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


def fused_forward_cuda(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor) -> torch.Tensor:
    """Launch kernel B on raw rows [N, 6] (float32, CUDA) -> [N, 4] float32."""
    global launches
    _check_rows(spec, x_raw)
    w, b, table = packed(spec, net, x_raw.device)
    N = x_raw.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x_raw.device)
    if N == 0:
        return out
    pos_f, dir_f = _spec_freqs(spec)
    lib = _lib()
    stream = torch.cuda.current_stream(x_raw.device).cuda_stream
    err = lib.fused_mlp_v2_fwd_launch(
        x_raw.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), table.data_ptr(),
        N, spec.n_layers, spec.width, pos_f, dir_f, skip_mask(spec),
        int(spec.use_directional_input), stream)
    _build.check(lib, err, "fused_mlp_v2_fwd")
    launches += 1
    return out


def fused_backward_cuda(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor,
                        g: torch.Tensor):
    """Launch kernel C: (dflat, dx) for raw rows [N, 6] and cotangent g [N, 4].

    dflat are float32 (d kernel [in, out], d bias) pairs in `_param_order`
    (views of two buffers the kernel adds into), dx is [N, 6] float32.
    """
    global launches_bwd
    _check_rows(spec, x_raw)
    N = x_raw.shape[0]
    if (g.device != x_raw.device or g.dtype != torch.float32 or tuple(g.shape) != (N, 4)
            or not g.is_contiguous()):
        raise ValueError(f"fused v2 backward takes a contiguous float32 [N, 4] cotangent on "
                         f"{x_raw.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    device = x_raw.device
    w, b, table = packed(spec, net, device)
    dw = torch.zeros(w.numel(), dtype=torch.float32, device=device)
    db = torch.zeros(b.numel(), dtype=torch.float32, device=device)
    dx = torch.empty((N, 6), dtype=torch.float32, device=device)
    if N:
        pos_f, dir_f = _spec_freqs(spec)
        lib = _lib_bwd()
        # a persistent grid: one block per SM, each looping over 64-row tiles
        # with its own slice of the activation scratch
        n_tiles = -(-N // TILE_ROWS)
        grid = min(n_tiles, torch.cuda.get_device_properties(device).multi_processor_count)
        acts = torch.empty(grid * lib.fused_mlp_v2_bwd_scratch_elems(spec.n_layers, spec.width),
                           dtype=torch.bfloat16, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_mlp_v2_bwd_launch(
            x_raw.data_ptr(), g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
            acts.data_ptr(), w.data_ptr(), b.data_ptr(), table.data_ptr(),
            N, spec.n_layers, spec.width, pos_f, dir_f, skip_mask(spec),
            int(spec.use_directional_input), grid, stream)
        _build.check(lib, err, "fused_mlp_v2_bwd")
        launches_bwd += 1
    return unpack_grads(spec, dw, db), dx


class FusedMlpV2(torch.autograd.Function):
    """Forward: kernel B. Backward: kernel C, which returns the gradient of
    every kernel and bias and of the raw rows."""

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
