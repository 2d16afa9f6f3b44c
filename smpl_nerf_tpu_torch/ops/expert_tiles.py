"""Fused sorted-tile expert forward (kernel E, csrc/expert_tiles.cu).

Replaces the TPU kernel smpl_nerf_tpu/ops/expert_tiles_pallas.py:
expert_tiles_forward. For every slot of a sorted-tile plan
(parallel/ep.sorted_tile_plan) it builds the positional encoding of the
cell-local position and of the direction and runs the slot's expert MLP:

    enc = [local | sin(local 2^k) cos(local 2^k) ... | dirs | sin(dirs 2^k) ...]
    out = (relu(enc @ w0[e] + b0[e]) @ w1[e] + b1[e]) * valid,   e = tile_expert[slot // tile]

`expert_tiles_reference` is the plain PyTorch version. It follows the
kernel's rounding, which is the TPU kernel's `_tile_math` and NOT
`ep.tiles_apply`: the encoding is float32; with `compute_dtype` bf16 the
encoding, w0, the hidden activations and w1 are rounded to bf16, every
product accumulates in float32, both biases are added in float32.
(`ep.tiles_apply` in bf16 also rounds the products and the bias adds.)

What bounds it on the H100: bytes (25 B in, 16 B out per slot, ~6 KB of
weights per tile), with the 36 sines of a row close behind. In bf16 the
kernel stages each tile's expert once, in the order of `mma.sync`'s B
fragments, encodes straight into its A fragments and runs both layers on
tensor cores; in float32 it keeps exact float32 FMAs. The source says how.

`expert_tiles_forward` takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back from CUDA to the plain
version. It is forward-only, as the TPU kernel is (fine-tuning trains through
`ep.tiles_apply`): asked for a gradient, it raises. `launches` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch.ops import _build
from smpl_nerf_tpu_torch.ops.fused_mlp import MAX_SHARED_BYTES

MAX_OUT = 4      # kOutPad in csrc/expert_tiles.cu
# the bf16 kernel keeps a row's encoding in registers as D/16 k16 steps, at
# most 8 (the launcher's switch in csrc/expert_tiles.cu): l_pos + l_dir <= 20
MAX_BF16_INPUTS = 128
launches = 0


def encoded_dim(l_pos: int, l_dir: int) -> int:
    return (3 + 6 * l_pos) + (3 + 6 * l_dir)


def _encode_block(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x | sin(x f0) | cos(x f0) | sin(x f1) | ...] with cos(t) = sin(t + pi/2)
    and the float32 pi/2 of the kernel; x 2^k is exact."""
    if n_freqs == 0:
        return x
    freqs = torch.as_tensor(2.0 ** np.arange(n_freqs, dtype=np.float32), device=x.device)
    phase = torch.as_tensor(np.array([0.0, np.pi / 2], np.float32), device=x.device)
    arg = x[:, None, None, :] * freqs[:, None, None] + phase[:, None]     # [L, F, 2, 3]
    return torch.cat([x, torch.sin(arg).reshape(x.shape[0], -1)], -1)


def expert_tiles_reference(experts, local: torch.Tensor, dirs: torch.Tensor,
                           valid: torch.Tensor, tile_expert: torch.Tensor, *, l_pos: int,
                           l_dir: int, tile: int = 256,
                           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel E: local/dirs [L, 3] float32 in plan
    order, valid [L] bool, tile_expert [L // tile] -> raw [L, O] float32."""
    L = local.shape[0]
    if L % tile:
        raise ValueError(f"L={L} must be a multiple of tile={tile}")
    cdt = torch.float32 if compute_dtype is None else compute_dtype

    def rounded(t):
        return t.to(cdt).float()

    w0, b0, w1, b1 = experts
    te = torch.clamp(tile_expert.long(), 0, w0.shape[0] - 1)
    enc = torch.cat([_encode_block(local.float(), l_pos), _encode_block(dirs.float(), l_dir)], -1)
    xt = rounded(enc).reshape(L // tile, tile, -1)
    h = torch.relu(xt @ rounded(w0)[te] + b0.float()[te][:, None, :])
    o = rounded(h) @ rounded(w1)[te] + b1.float()[te][:, None, :]
    o = o.reshape(L, -1)
    return torch.where(valid[:, None], o, torch.zeros_like(o))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("expert_tiles")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.expert_tiles_launch.argtypes = [p] * 9 + [i] * 9 + [p]
    lib.expert_tiles_launch.restype = ctypes.c_int
    lib.expert_tiles_shared_bytes.argtypes = [i, i, i]
    lib.expert_tiles_shared_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _shared_bytes(D: int, H: int, use_bf16: int) -> int:
    return _lib().expert_tiles_shared_bytes(D, H, use_bf16)


def expert_tiles_cuda(experts, local: torch.Tensor, dirs: torch.Tensor, valid: torch.Tensor,
                      tile_expert: torch.Tensor, *, l_pos: int, l_dir: int, tile: int = 256,
                      compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch kernel E (all tensors on one CUDA device) -> raw [L, O] float32."""
    global launches
    w0, b0, w1, b1 = experts
    device = local.device
    if device.type != "cuda":
        raise ValueError(f"expert_tiles_cuda takes CUDA tensors, got {device}")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be None, float32 or bfloat16, got {compute_dtype}")
    L = local.shape[0]
    if L % tile or tile < 1:
        raise ValueError(f"L={L} must be a multiple of tile={tile}")
    E, D, H = w0.shape
    O = w1.shape[-1]
    if D != encoded_dim(l_pos, l_dir):
        raise ValueError(f"experts take {D} inputs, the encoding of l_pos={l_pos}, "
                         f"l_dir={l_dir} has {encoded_dim(l_pos, l_dir)}")
    if not 1 <= O <= MAX_OUT:
        raise ValueError(f"the kernel writes 1 to {MAX_OUT} outputs per slot, got {O}")
    use_bf16 = int(compute_dtype == torch.bfloat16)
    if use_bf16 and D > MAX_BF16_INPUTS:
        raise ValueError(f"the bf16 kernel keeps a row's encoding in registers and takes at "
                         f"most {MAX_BF16_INPUTS} inputs (l_pos + l_dir <= 20), got {D}")
    shapes = {"local": (local, (L, 3), torch.float32), "dirs": (dirs, (L, 3), torch.float32),
              "valid": (valid, (L,), torch.bool),
              "tile_expert": (tile_expert, (L // tile,), torch.int32),
              "w0": (w0, (E, D, H), torch.float32), "b0": (b0, (E, H), torch.float32),
              "w1": (w1, (E, H, O), torch.float32), "b1": (b1, (E, O), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if (t.device != device or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"expert_tiles_cuda takes {name} as a contiguous {dtype} "
                             f"{shape} tensor on {device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*experts, local, dirs)):
        raise RuntimeError("the fused expert kernel is forward-only (the TPU kernel has no "
                           "gradient either): train through ep.tiles_apply, or call it "
                           "under torch.no_grad()")
    out = torch.empty((L, O), dtype=torch.float32, device=device)
    if L == 0:
        return out
    lib = _lib()
    need = _shared_bytes(D, H, use_bf16)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"experts with D={D}, H={H} need {need} bytes of shared memory per "
                         f"block, over the {MAX_SHARED_BYTES} a block can have")
    stream = _build.current_stream(device)
    err = lib.expert_tiles_launch(
        local.data_ptr(), dirs.data_ptr(), valid.data_ptr(), tile_expert.data_ptr(),
        w0.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), out.data_ptr(),
        L, int(tile), E, D, H, O, int(l_pos), int(l_dir), use_bf16, stream)
    _build.check(lib, err, "expert_tiles")
    launches += 1
    return out


def expert_tiles_forward(experts, local: torch.Tensor, dirs: torch.Tensor, valid: torch.Tensor,
                         tile_expert: torch.Tensor, *, l_pos: int, l_dir: int, tile: int = 256,
                         compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Fused `ep.tiles_apply` on un-encoded slots: local (cell-local position)
    and dirs [L, 3] in plan order, valid [L] bool, tile_expert [L // tile]
    int32 -> raw [L, O] float32, zero in invalid slots.

    CPU tensors take the plain version; CUDA tensors take the kernel.
    """
    args = (experts, local, dirs, valid, tile_expert)
    kwargs = dict(l_pos=l_pos, l_dir=l_dir, tile=tile, compute_dtype=compute_dtype)
    if local.device.type == "cpu":
        return expert_tiles_reference(*args, **kwargs)
    return expert_tiles_cuda(*args, **kwargs)
