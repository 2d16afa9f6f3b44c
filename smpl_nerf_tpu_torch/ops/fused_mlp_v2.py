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

Forward only: the backward kernel (`_pallas_backward`) belongs to the training
slice, so the CUDA path raises if a gradient is required. `launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from smpl_nerf_tpu_torch.ops import _build
from smpl_nerf_tpu_torch.ops.fused_mlp import (MlpSpec, _param_order, flatten_params,
                                               trunk_forward)

TILE_ROWS = 64        # rows per block; must match kTile in the source
MAX_WIDTH = 256       # 16 n-tiles of 16 over 8 warps
launches = 0


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


def kernel_supports(spec: MlpSpec) -> str:
    """'' if the CUDA kernel takes this net, else the reason it does not."""
    if spec.dtype != "bfloat16":
        return "the fused v2 CUDA kernel computes in bfloat16 (--compute_dtype=bfloat16)"
    if spec.additional_input_dim:
        return "nets with a conditioning prefix are not ported yet on CUDA (kernel v1/D)"
    if spec.width % 32 or not 32 <= spec.width <= MAX_WIDTH:
        return f"width must be a multiple of 32 in [32, {MAX_WIDTH}], got {spec.width}"
    if spec.positions_dim <= 0 or spec.directions_dim <= 0:
        return "the kernel needs positional and directional encodings"
    if not 1 <= spec.n_layers <= 32 or any(not 0 <= s < 32 for s in spec.skips):
        return "the kernel takes 1 to 32 layers with skip indices in [0, 32)"
    return ""


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def pack_weights(spec: MlpSpec, flat, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights bf16 [total], biases f32 [total], table int32 [L, 4]).

    Layers in kernel order: positions_pose_input, positional_net_0..n-2,
    additional_linear_layer, directional_input, directional_net_0, then the
    heads sigma_out_layer and rgb_out_layer. Each kernel is [K, N] row-major,
    its input segments ([activation W] and the encoded block it concatenates)
    each zero-padded to a multiple of 16 rows; table row = (weight offset,
    bias offset, K, N) in elements.
    """
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}
    W, P, D = spec.width, spec.positions_dim, spec.directions_dim
    act, pos, dirs, half = (W, W), (P, _round16(P)), (D, _round16(D)), (W // 2, W // 2)
    order = [("positions_pose_input", [pos])]
    order += [(f"positional_net_{i}", [act] + ([pos] if i in spec.skips else []))
              for i in range(spec.n_layers - 1)]
    order += [("additional_linear_layer", [act]),
              ("directional_input", [act] + ([dirs] if spec.use_directional_input else [])),
              ("directional_net_0", [half]),
              ("sigma_out_layer", [act]),
              ("rgb_out_layer", [half])]
    w_parts, b_parts, table = [], [], []
    w_off = b_off = 0
    for name, segments in order:
        k, b = layers[name]
        k = k.detach().float().cpu()
        rows, r = [], 0
        for real, padded in segments:
            rows.append(k[r:r + real])
            rows.append(torch.zeros(padded - real, k.shape[1]))
            r += real
        if r != k.shape[0]:
            raise ValueError(f"{name}: kernel has {k.shape[0]} input rows, expected {r}")
        kp = torch.cat(rows).to(torch.bfloat16)
        table.append((w_off, b_off, kp.shape[0], kp.shape[1]))
        w_parts.append(kp.reshape(-1))
        b_parts.append(b.detach().float().cpu().reshape(-1))
        w_off += kp.numel()
        b_off += b.numel()
    return (torch.cat(w_parts).to(device), torch.cat(b_parts).to(device),
            torch.tensor(table, dtype=torch.int32, device=device))


def _packed(spec: MlpSpec, net: torch.nn.Module, device):
    """The module's weight pack on `device`, rebuilt when a parameter changes."""
    key = (spec, str(device), tuple((p.data_ptr(), p._version) for p in net.parameters()))
    cached = getattr(net, "_fused_v2_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(spec, flatten_params(spec, net), device))
        net._fused_v2_pack = cached
    return cached[1]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_v2_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_v2_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_uint, i, p]
    lib.fused_mlp_v2_fwd_launch.restype = ctypes.c_int
    return lib


def fused_forward_cuda(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on raw rows [N, 6] (float32, CUDA) -> [N, 4] float32."""
    global launches
    reason = kernel_supports(spec)
    if reason:
        raise ValueError(reason)
    if x_raw.device.type != "cuda" or x_raw.dtype != torch.float32:
        raise ValueError(f"fused v2 kernel takes float32 CUDA rows, got {x_raw.dtype} "
                         f"on {x_raw.device}")
    if x_raw.dim() != 2 or x_raw.shape[1] != raw_in_dim(spec) or not x_raw.is_contiguous():
        raise ValueError(f"fused v2 kernel takes contiguous [N, {raw_in_dim(spec)}] rows, "
                         f"got {tuple(x_raw.shape)}")
    if torch.is_grad_enabled() and (x_raw.requires_grad
                                    or any(p.requires_grad for p in net.parameters())):
        raise RuntimeError("the fused v2 CUDA kernel is forward only (its backward kernel "
                           "is not ported yet): run it under torch.no_grad()")
    w, b, table = _packed(spec, net, x_raw.device)
    N = x_raw.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x_raw.device)
    if N == 0:
        return out
    pos_f, dir_f = _spec_freqs(spec)
    skip_mask = sum(1 << s for s in spec.skips if s < spec.n_layers - 1)
    lib = _lib()
    stream = torch.cuda.current_stream(x_raw.device).cuda_stream
    err = lib.fused_mlp_v2_fwd_launch(
        x_raw.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), table.data_ptr(),
        N, spec.n_layers, spec.width, pos_f, dir_f, skip_mask,
        int(spec.use_directional_input), stream)
    _build.check(lib, err, "fused_mlp_v2_fwd")
    launches += 1
    return out


def fused_apply_raw(spec: MlpSpec, net: torch.nn.Module, x_raw: torch.Tensor) -> torch.Tensor:
    """Apply the net to RAW rows [N, additional || xyz(3) || unit dir(3)].

    CPU rows take the plain version; CUDA rows take the kernel.
    """
    if x_raw.device.type == "cpu":
        return reference_forward_raw(spec, flatten_params(spec, net), x_raw)
    return fused_forward_cuda(spec, net, x_raw)
