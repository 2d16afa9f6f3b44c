"""RenderRayNet as one flat parameter list, and the fused v1 forward (kernel D).

Counterpart of smpl_nerf_tpu/ops/fused_mlp.py. `MlpSpec` is the static
topology of a RenderRayNet; `flatten_params` turns a net into (kernel
[in, out], bias) pairs in `_param_order`, the layout both fused forwards read.

`fused_apply(spec, net, x)` applies the net to pre-encoded rows
[prefix || pos_enc || dir_enc] -> [N, 4]. It replaces the TPU kernel
`fused_mlp._pallas_forward`: CUDA rows launch csrc/fused_mlp_fwd.cu (the
whole MLP per 64-row tile, bf16 tensor cores, weights streamed through shared
memory; see the source for the design and what bounds it), CPU rows take the
plain PyTorch version `reference_forward`. It never falls back from CUDA to
the plain version. `launches` counts kernel launches.

The gradient follows the JAX package, whose v1 backward is no kernel but
`jax.vjp` of `reference_forward` (recompute in backward): an autograd
Function whose forward launches the kernel and whose backward differentiates
`reference_forward` with torch ops.

`pack_weights` builds the weight pack all three fused MLP kernels read; it is
cached on the module and rebuilt when a parameter changes (an optimizer step
bumps the parameters' `_version`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from smpl_nerf_tpu_torch.ops import _build

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

TILE_ROWS = 64            # rows per block; kTile in csrc/fused_mlp_common.cuh
MAX_WIDTH = 256           # 16 n-tiles of 16 over 8 warps
MAX_SHARED_BYTES = 232448  # dynamic shared memory one Hopper block can ask for
launches = 0


@dataclasses.dataclass(frozen=True)
class MlpSpec:
    """Static topology of a RenderRayNet."""
    n_layers: int = 8
    width: int = 256
    positions_dim: int = 60
    directions_dim: int = 24
    additional_input_dim: int = 0
    skips: Tuple[int, ...] = (4,)
    use_directional_input: bool = True
    dtype: str = "bfloat16"   # compute precision

    @property
    def pos_block(self) -> int:
        return self.positions_dim + self.additional_input_dim

    @property
    def in_dim(self) -> int:
        return self.pos_block + self.directions_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def _param_order(spec: MlpSpec) -> Sequence[str]:
    names = ["positions_pose_input"]
    names += [f"positional_net_{i}" for i in range(spec.n_layers - 1)]
    names += ["additional_linear_layer", "sigma_out_layer", "directional_input",
              "directional_net_0", "rgb_out_layer"]
    return names


def _module_layer(net: torch.nn.Module, name: str) -> torch.nn.Linear:
    if name.startswith("positional_net_"):
        return net.positional_net[int(name[len("positional_net_"):])]
    if name == "directional_net_0":
        return net.directional_net[0]
    return getattr(net, name)


def flatten_params(spec: MlpSpec, net: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    """RenderRayNet -> flat (kernel [in, out], bias) * layers, in _param_order."""
    flat = []
    for name in _param_order(spec):
        layer = _module_layer(net, name)
        flat.append(layer.weight.t())
        flat.append(layer.bias)
    return tuple(flat)


def dense_f32(layers, name: str, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h @ kernel in `dtype` operands with float32 accumulation, + f32 bias.

    Products of bf16 values are exact in float32, so an f32 product of the
    bf16-rounded operands is the `preferred_element_type=float32` dot.
    """
    k, b = layers[name]
    return torch.matmul(h.float(), k.to(dtype).float()) + b.float()


def trunk_forward(spec: MlpSpec, flat, pos: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The RenderRayNet body on encoded inputs, rounding to spec.dtype after
    each ReLU, after additional_linear_layer and after directional_input."""
    cdt = spec.torch_dtype
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}

    def dense(name, h):
        return dense_f32(layers, name, h, cdt)

    o = torch.relu(dense("positions_pose_input", pos)).to(cdt)
    for i in range(spec.n_layers - 1):
        if i in spec.skips:
            o = torch.cat([o, pos], -1)
        o = torch.relu(dense(f"positional_net_{i}", o)).to(cdt)
    o = dense("additional_linear_layer", o).to(cdt)
    sigma = dense("sigma_out_layer", o)
    if spec.use_directional_input:
        o = torch.cat([o, dirs], -1)
    o = dense("directional_input", o).to(cdt)
    o = torch.relu(dense("directional_net_0", o)).to(cdt)
    rgb = dense("rgb_out_layer", o)
    return torch.cat([rgb, sigma], -1).float()


def reference_forward(spec: MlpSpec, flat, x: torch.Tensor) -> torch.Tensor:
    """Plain version of the v1 fused forward: pre-encoded rows [N, in_dim] -> [N, 4]."""
    cdt = spec.torch_dtype
    pos = x[..., :spec.pos_block].to(cdt)
    dirs = x[..., spec.in_dim - spec.directions_dim:].to(cdt)
    return trunk_forward(spec, flat, pos, dirs)


def spec_from_model(model) -> MlpSpec:
    """MlpSpec of a models.RenderRayNet."""
    dtype = {v: k for k, v in _DTYPES.items()}[model.compute_dtype]
    return MlpSpec(
        n_layers=model.n_layers, width=model.width,
        positions_dim=model.positions_dim, directions_dim=model.directions_dim,
        additional_input_dim=model.additional_input_dim,
        skips=tuple(model.skips),
        use_directional_input=bool(model.use_directional_input),
        dtype=dtype)


# ------------------------------------------------------------ the weight pack

def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def pack_layout(spec: MlpSpec) -> List[tuple]:
    """[(name, segments, weight offset, bias offset, K, N)] in kernel order.

    Layers in kernel order: positions_pose_input, positional_net_0..n-2,
    additional_linear_layer, directional_input, directional_net_0, then the
    heads sigma_out_layer and rgb_out_layer. `segments` are the (real, padded)
    row counts of a kernel's input blocks ([activation W] and the prefix+pos or
    direction block it concatenates), each padded to a multiple of 16; K is
    the padded row count, offsets are in elements.
    """
    W, PB, D = spec.width, spec.pos_block, spec.directions_dim
    act, pos, dirs, half = (W, W), (PB, _round16(PB)), (D, _round16(D)), (W // 2, W // 2)
    order = [("positions_pose_input", [pos], W)]
    order += [(f"positional_net_{i}", [act] + ([pos] if i in spec.skips else []), W)
              for i in range(spec.n_layers - 1)]
    order += [("additional_linear_layer", [act], W),
              ("directional_input", [act] + ([dirs] if spec.use_directional_input else []),
               W // 2),
              ("directional_net_0", [half], W // 2),
              ("sigma_out_layer", [act], 1),
              ("rgb_out_layer", [half], 3)]
    layout, w_off, b_off = [], 0, 0
    for name, segments, n_out in order:
        k_pad = sum(padded for _, padded in segments)
        layout.append((name, segments, w_off, b_off, k_pad, n_out))
        w_off += k_pad * n_out
        b_off += n_out
    return layout


def pack_weights(spec: MlpSpec, flat, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights bf16 [total], biases f32 [total], table int32 [L, 4]) on `device`.

    Each kernel is [K, N] row-major with the rows of `pack_layout`; table row
    = (weight offset, bias offset, K, N) in elements. The padding and casts
    run where the parameters lie, so repacking after an optimizer step moves
    nothing through the host.
    """
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}
    w_parts, b_parts, table = [], [], []
    for name, segments, w_off, b_off, k_pad, n_out in pack_layout(spec):
        k, b = layers[name]
        k = k.detach().float()
        rows, r = [], 0
        for real, padded in segments:
            rows.append(k[r:r + real])
            if padded > real:
                rows.append(k.new_zeros(padded - real, k.shape[1]))
            r += real
        if r != k.shape[0] or k.shape[1] != n_out:
            raise ValueError(f"{name}: kernel is {tuple(k.shape)}, expected ({r}, {n_out})")
        table.append((w_off, b_off, k_pad, n_out))
        w_parts.append(torch.cat(rows).to(torch.bfloat16).reshape(-1))
        b_parts.append(b.detach().float().reshape(-1))
    return (torch.cat(w_parts).to(device), torch.cat(b_parts).to(device),
            torch.tensor(table, dtype=torch.int32, device=device))


def unpack_grads(spec: MlpSpec, dw: torch.Tensor, db: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients in the pack's layout (float32 [total] each) -> flat
    (d kernel [in, out], d bias) pairs in `_param_order`, padding rows dropped."""
    grads = {}
    for name, segments, w_off, b_off, k_pad, n_out in pack_layout(spec):
        block = dw[w_off:w_off + k_pad * n_out].view(k_pad, n_out)
        rows, r = [], 0
        for real, padded in segments:
            rows.append(block[r:r + real])
            r += padded
        grads[name] = (rows[0] if len(rows) == 1 else torch.cat(rows), db[b_off:b_off + n_out])
    return tuple(t for name in _param_order(spec) for t in grads[name])


def packed(spec: MlpSpec, net: torch.nn.Module, device):
    """The module's weight pack on `device`, rebuilt when a parameter changes."""
    key = (spec, str(device), tuple((p.data_ptr(), p._version) for p in net.parameters()))
    cached = getattr(net, "_fused_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(spec, flatten_params(spec, net), device))
        net._fused_pack = cached
    return cached[1]


def skip_mask(spec: MlpSpec) -> int:
    return sum(1 << s for s in spec.skips if s < spec.n_layers - 1)


def topology_reason(spec: MlpSpec) -> str:
    """'' if the fused CUDA kernels take this topology, else why not."""
    if spec.dtype != "bfloat16":
        return "the fused MLP CUDA kernels compute in bfloat16 (--compute_dtype=bfloat16)"
    if spec.width % 32 or not 32 <= spec.width <= MAX_WIDTH:
        return f"width must be a multiple of 32 in [32, {MAX_WIDTH}], got {spec.width}"
    if not 1 <= spec.n_layers <= 32 or any(not 0 <= s < 32 for s in spec.skips):
        return "the kernel takes 1 to 32 layers with skip indices in [0, 32)"
    return ""


# ------------------------------------------------------------------- kernel D

def shared_bytes(spec: MlpSpec) -> int:
    """Dynamic shared memory of one block of csrc/fused_mlp_fwd.cu (its make_dims)."""
    def align128(n):
        return (n + 127) // 128 * 128

    pad, chunk, warps = 8, 32, 8
    lda = spec.width + pad
    total = 2 * align128(2 * TILE_ROWS * lda)                                  # activations
    total += align128(2 * TILE_ROWS * (_round16(spec.pos_block) + pad))         # prefix + pos
    total += align128(2 * TILE_ROWS * (_round16(spec.directions_dim) + pad))    # directions
    total += align128(2 * chunk * lda)                                          # weight chunk
    total += align128(4 * warps * 256) + align128(4 * TILE_ROWS * 4)            # scratch, out
    return total


def kernel_supports(spec: MlpSpec) -> str:
    """'' if the v1 CUDA kernel takes this net, else the reason it does not."""
    reason = topology_reason(spec)
    if reason:
        return reason
    if spec.pos_block <= 0:
        return "the kernel needs a positional input block"
    if spec.use_directional_input and spec.directions_dim <= 0:
        return "directional input needs a directional encoding"
    if shared_bytes(spec) > MAX_SHARED_BYTES:
        return (f"a {TILE_ROWS}-row tile with a {spec.pos_block}-wide prefix+position block "
                f"needs {shared_bytes(spec)} bytes of shared memory, over the "
                f"{MAX_SHARED_BYTES} a block can have")
    return ""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_uint, i, p]
    lib.fused_mlp_fwd_launch.restype = ctypes.c_int
    return lib


def fused_forward_cuda(spec: MlpSpec, net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on pre-encoded rows [N, in_dim] (float32, CUDA) -> [N, 4]."""
    global launches
    reason = kernel_supports(spec)
    if reason:
        raise ValueError(reason)
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"fused v1 kernel takes float32 CUDA rows, got {x.dtype} on {x.device}")
    if x.dim() != 2 or x.shape[1] != spec.in_dim or not x.is_contiguous():
        raise ValueError(f"fused v1 kernel takes contiguous [N, {spec.in_dim}] rows, "
                         f"got {tuple(x.shape)}")
    w, b, table = packed(spec, net, x.device)
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.fused_mlp_fwd_launch(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), table.data_ptr(),
        N, spec.n_layers, spec.width, spec.pos_block, spec.directions_dim, spec.in_dim,
        skip_mask(spec), int(spec.use_directional_input), stream)
    _build.check(lib, err, "fused_mlp_fwd")
    launches += 1
    return out


class FusedMlpV1(torch.autograd.Function):
    """Forward: kernel D. Backward: the gradient of `reference_forward` on the
    saved rows (recompute in backward, as the JAX package's v1 VJP does)."""

    @staticmethod
    def forward(ctx, spec, net, x, *flat):
        ctx.spec = spec
        ctx.save_for_backward(x, *flat)
        return fused_forward_cuda(spec, net, x.detach())

    @staticmethod
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in zip([x, *flat], needs)]
            y = reference_forward(ctx.spec, leaves[1:], leaves[0])
            wanted = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, g.contiguous(), allow_unused=True))
        return (None, None, *[next(got) if t.requires_grad else None for t in leaves])


def fused_apply(spec: MlpSpec, net: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply the net to pre-encoded rows [N, prefix || pos_enc || dir_enc].

    CPU rows take the plain version; CUDA rows take the kernel.
    """
    flat = flatten_params(spec, net)
    if x.device.type == "cpu":
        return reference_forward(spec, flat, x)
    return FusedMlpV1.apply(spec, net, x, *flat)
