"""RenderRayNet as one flat parameter list, and the fused v1 forward (kernel D).

Counterpart of smpl_nerf_tpu/ops/fused_mlp.py. `MlpSpec` is the static
topology of a RenderRayNet; `flatten_params` turns a net into (kernel
[in, out], bias) pairs in `_param_order`, the layout both fused forwards read.

`fused_apply(spec, net, x)` applies the net to pre-encoded rows
[prefix || pos_enc || dir_enc] -> [N, 4]. It replaces the TPU kernel
`fused_mlp._pallas_forward`: CUDA rows launch csrc/fused_mlp_fwd.cu, CPU rows
take the plain PyTorch version `reference_forward`. It never falls back from
CUDA to the plain version. `launches` counts kernel launches.

What bounds the kernel on the H100: tensor-core operations (~650 per byte
at the 705-wide append_smpl_params rows). Beside them every row tile streams
the whole weight set from L2, and the 621-wide prefix cannot stay in shared
memory. The design (in the source): 128-row tiles on a persistent grid, a
producer warpgroup that streams 64-row weight chunks of `pack_weights_d`
with `cp.async.bulk` through an mbarrier ring and builds the bf16 A chunks of
the prefix+pos and dir blocks from float32 x, two consumer warpgroups that
run wgmma with the activations kept in registers from layer to layer. The
prefix streams, so neither it nor the directions bound the net's shape.

The gradient follows the JAX package, whose v1 backward is no kernel but
`jax.vjp` of `reference_forward` (recompute in backward): an autograd
Function whose forward launches the kernel and whose backward differentiates
`reference_forward` with torch ops.

`pack_weights_d` builds the weight pack kernels B, C and D read (64-row chunk
images in the byte order wgmma reads); `pack_weights` the plain [K, N]
layout (`pack_layout`) that the tests hold it against. Packs are cached on
the module by `packed` and rebuilt when a parameter changes (an optimizer
step bumps the parameters' `_version`). `unpack_grads_d` turns kernel C's
gradient buffer back into flat pairs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch

from smpl_nerf_tpu_torch.ops import _build

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

MAX_WIDTH = 256           # the widest padded width of csrc/render_net.cuh
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
    """RenderRayNet -> flat (kernel [in, out], bias) * layers, in _param_order.

    Each layer gives its whole weight (`Dense.full_weight`: a layer that
    --tensor_parallel split gathers it, and its gradient goes back to the
    shard), since the kernels take the whole net."""
    flat = []
    for name in _param_order(spec):
        layer = _module_layer(net, name)
        flat.append(layer.full_weight().t())
        flat.append(layer.full_bias())
    return tuple(flat)


def dense_f32(layers, name: str, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h @ kernel in `dtype` operands with float32 accumulation, + f32 bias.

    Products of bf16 values are exact in float32, so an f32 product of the
    bf16-rounded operands is the `preferred_element_type=float32` dot.
    """
    k, b = layers[name]
    return torch.matmul(h.float(), k.to(dtype).float()) + b.float()


def round_through(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """h rounded to `dtype` in the forward, with its gradient passed through
    unrounded in h's own type."""
    return h + (h.to(dtype).to(h.dtype) - h).detach()


def trunk_forward(spec: MlpSpec, flat, pos: torch.Tensor, dirs: torch.Tensor,
                  exact: bool = False) -> torch.Tensor:
    """The RenderRayNet body on encoded inputs, rounding to spec.dtype after
    each ReLU, after additional_linear_layer and after directional_input.

    exact=True gives the same forward values in float64 (float64 `pos` and
    `dirs`, the weights rounded to spec.dtype, the same roundings of the
    activations) with every rounding passed straight through by autograd: a
    witness of the gradient that no bf16 rounding of a cotangent disturbs."""
    cdt = spec.torch_dtype
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}

    def dense(name, h):
        if not exact:
            return dense_f32(layers, name, h, cdt)
        k, b = layers[name]
        return h @ k.to(cdt).double() + b.float().double()

    def rnd(h):
        return round_through(h, cdt) if exact else h.to(cdt)

    o = rnd(torch.relu(dense("positions_pose_input", pos)))
    for i in range(spec.n_layers - 1):
        if i in spec.skips:
            o = torch.cat([o, pos], -1)
        o = rnd(torch.relu(dense(f"positional_net_{i}", o)))
    o = rnd(dense("additional_linear_layer", o))
    sigma = dense("sigma_out_layer", o)
    if spec.use_directional_input:
        o = torch.cat([o, dirs], -1)
    o = rnd(dense("directional_input", o))
    o = rnd(torch.relu(dense("directional_net_0", o)))
    rgb = dense("rgb_out_layer", o)
    out = torch.cat([rgb, sigma], -1)
    return out if exact else out.float()


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
    """(weights bf16 [total], biases f32 [total], table int32 [L, 4]) on `device`:
    the plain layout `pack_weights_d` is checked against.

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


def packed(spec: MlpSpec, net: torch.nn.Module, device, builder=None):
    """The module's weight pack on `device` (`pack_weights`, or `builder`'s),
    rebuilt when a parameter changes."""
    builder = builder or pack_weights
    key = (spec, str(device), tuple((p.data_ptr(), p._version) for p in net.parameters()))
    packs = net.__dict__.setdefault("_fused_packs", {})
    cached = packs.get(builder.__name__)
    if cached is None or cached[0] != key:
        cached = (key, builder(spec, flatten_params(spec, net), device))
        packs[builder.__name__] = cached
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

D_TILE_ROWS = 128          # rows per tile of csrc/render_net.cuh (two warpgroups of 64)
D_CHUNK = 64               # weight rows per streamed chunk, x columns per A chunk


def padded_width(spec: MlpSpec) -> int:
    """The width kernel D computes at: W padded to 128 or 256 with zero weights."""
    return 128 if spec.width <= 128 else 256


def _round64(n: int) -> int:
    return -(-n // D_CHUNK) * D_CHUNK


def d_layout(spec: MlpSpec) -> List[tuple]:
    """[(name, segments, N, N padded)] of the dense layers in the order of
    csrc/render_net.cuh (kernels B, C and D).

    `segments` are (source, real rows, padded rows) of the layer's K in the
    order the kernel streams them: "act" (the previous layer's activations,
    W real of the padded width), "pos" (the prefix+pos block) and "dir" (the
    direction block), each padded to a multiple of 64 rows.
    """
    W, WP, PB, D = spec.width, padded_width(spec), spec.pos_block, spec.directions_dim
    act, half = ("act", W, WP), ("act", W // 2, WP // 2)
    pos, dirs = ("pos", PB, _round64(PB)), ("dir", D, _round64(D))
    layout = [("positions_pose_input", [pos], W, WP)]
    layout += [(f"positional_net_{i}", [act] + ([pos] if i in spec.skips else []), W, WP)
               for i in range(spec.n_layers - 1)]
    layout += [("additional_linear_layer", [act], W, WP),
               ("directional_input", [act] + ([dirs] if spec.use_directional_input else []),
                W // 2, WP // 2),
               ("directional_net_0", [half], W // 2, WP // 2)]
    return layout


def _swizzle_index(chunks: int, n: int, device) -> torch.Tensor:
    """Gather index over the 16-byte groups of each line: g <-> g ^ (n % 8)."""
    groups = torch.arange(8, device=device)[None, :] ^ (torch.arange(n, device=device)[:, None] % 8)
    return groups[None, :, :, None].expand(chunks, n, 8, 8)


def swizzle_chunks(k: torch.Tensor) -> torch.Tensor:
    """[K, N] (K a multiple of 64) -> the chunk images kernel D copies, [K // 64, N, 64].

    Chunk c holds rows [64 c, 64 c + 64) as wgmma's K-major operand with the
    128-byte swizzle: one 128-byte line per output column n (its 64 k values),
    16-byte group g of line n at position g ^ (n % 8).
    """
    K, N = k.shape
    C = K // D_CHUNK
    lines = k.reshape(C, D_CHUNK, N).transpose(1, 2).reshape(C, N, 8, 8)
    return lines.gather(2, _swizzle_index(C, N, k.device)).reshape(C, N, D_CHUNK)


def swizzle_chunks_inverse(images: torch.Tensor) -> torch.Tensor:
    """[C, N, 64] chunk images -> [64 C, N] (the swizzle is its own inverse)."""
    C, N, _ = images.shape
    lines = images.reshape(C, N, 8, 8).gather(2, _swizzle_index(C, N, images.device))
    return lines.reshape(C, N, D_CHUNK).transpose(1, 2).reshape(C * D_CHUNK, N)


def pack_weights_d(spec: MlpSpec, flat, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pack of kernels B, C and D: (chunk images bf16 [total], biases f32
    [total], heads f32 [WP + 3 WP / 2 + 4]) on `device`. Without a prefix, the
    "pos" block is the positional encoding and "dir" the directional one.

    Every dense layer of `d_layout`, in order, as `swizzle_chunks` images of
    its zero-padded [K, N padded] kernel, so one bulk copy lands a chunk in
    the layout wgmma reads; biases zero-padded to N padded. Heads: the
    sigma_out_layer column [WP], rgb_out_layer [WP / 2, 3] (both rounded to
    bf16, as the plain version rounds them), then the rgb and sigma biases.
    Built from the same `flatten_params` as `pack_weights`.
    """
    it = iter(flat)
    layers = {name: (next(it), next(it)) for name in _param_order(spec)}
    WP = padded_width(spec)
    w_parts, b_parts = [], []
    for name, segments, n_real, n_pad in d_layout(spec):
        k, b = layers[name]
        k = k.detach().float()
        rows, r = [], 0
        for _, real, padded in segments:
            block = k.new_zeros(padded, n_pad)
            block[:real, :n_real] = k[r:r + real]
            rows.append(block)
            r += real
        if r != k.shape[0] or k.shape[1] != n_real:
            raise ValueError(f"{name}: kernel is {tuple(k.shape)}, expected ({r}, {n_real})")
        w_parts.append(swizzle_chunks(torch.cat(rows).to(torch.bfloat16)).reshape(-1))
        bias = b.detach().float().new_zeros(n_pad)
        bias[:n_real] = b.detach().float()
        b_parts.append(bias)
    sig_k, sig_b = layers["sigma_out_layer"]
    rgb_k, rgb_b = layers["rgb_out_layer"]
    sig = sig_k.detach().float().new_zeros(WP)
    sig[:spec.width] = sig_k.detach().float()[:, 0]
    rgb = rgb_k.detach().float().new_zeros(WP // 2, 3)
    rgb[:spec.width // 2] = rgb_k.detach().float()
    heads = torch.cat([sig.to(torch.bfloat16).float(), rgb.to(torch.bfloat16).float().reshape(-1),
                       rgb_b.detach().float().reshape(-1), sig_b.detach().float().reshape(-1)])
    return (torch.cat(w_parts).to(device), torch.cat(b_parts).to(device), heads.to(device))


def unpack_grads_d(spec: MlpSpec, grads: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel C's gradient buffer (float32: every dense layer of `d_layout` as
    a plain [K padded, N padded] block, then each layer's padded db, then the
    heads as in `pack_weights_d`) -> flat (d kernel [in, out], d bias) pairs
    in `_param_order`, padding dropped."""
    WP, W = padded_width(spec), spec.width
    layout = d_layout(spec)
    grads_by_name, blocks, off = {}, [], 0
    for name, segments, n_real, n_pad in layout:
        k_pad = sum(padded for _, _, padded in segments)
        blocks.append(grads[off:off + k_pad * n_pad].view(k_pad, n_pad))
        off += k_pad * n_pad
    for (name, segments, n_real, n_pad), block in zip(layout, blocks):
        rows, r = [], 0
        for _, real, padded in segments:
            rows.append(block[r:r + real, :n_real])
            r += padded
        grads_by_name[name] = (rows[0] if len(rows) == 1 else torch.cat(rows),
                               grads[off:off + n_real])
        off += n_pad
    heads = grads[off:]
    grads_by_name["sigma_out_layer"] = (heads[:W, None], heads[-1:])
    grads_by_name["rgb_out_layer"] = (heads[WP:WP + 3 * (WP // 2)].view(WP // 2, 3)[:W // 2],
                                      heads[WP + 3 * (WP // 2):WP + 3 * (WP // 2) + 3])
    return tuple(t for name in _param_order(spec) for t in grads_by_name[name])


@functools.lru_cache(maxsize=None)
def grad_count_d(spec: MlpSpec) -> int:
    """Length of kernel C's float32 gradient buffer (see `unpack_grads_d`)."""
    WP = padded_width(spec)
    dense = sum(sum(padded for _, _, padded in segments) * n_pad + n_pad
                for _, segments, _, n_pad in d_layout(spec))
    return dense + WP + 3 * (WP // 2) + 4


def shared_bytes(spec: MlpSpec) -> int:
    """Dynamic shared memory of one block of kernel D (render_net.cuh's Cfg):
    a ring of 3 (padded width 256) or 4 (128) stages of one weight chunk and
    one 128 x 64 bf16 A chunk of x, two 128 x 64 float32 landing slots for x,
    the mbarriers and 1024 B of alignment slack. The prefix, the directions
    and the depth do not enter: every block of K is streamed."""
    WP = padded_width(spec)
    stages = 3 if WP == 256 else 4
    stage = D_CHUNK * WP * 2 + D_TILE_ROWS * D_CHUNK * 2
    return stages * stage + 2 * D_TILE_ROWS * D_CHUNK * 4 + 2 * stages * 8 + 1024


def kernel_supports(spec: MlpSpec) -> str:
    """'' if the v1 CUDA kernel takes this net, else the reason it does not.

    Limits: bf16, W a multiple of 32 in [32, 256], 1 to 32 layers, a
    positional block; any prefix and direction width (both stream through the
    ring in 64-column chunks, so shared memory no longer bounds them)."""
    reason = topology_reason(spec)
    if reason:
        return reason
    if spec.pos_block <= 0:
        return "the kernel needs a positional input block"
    if spec.use_directional_input and spec.directions_dim <= 0:
        return "directional input needs a directional encoding"
    return ""


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mlp_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_mlp_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_uint, i, p]
    lib.fused_mlp_fwd_launch.restype = ctypes.c_int
    lib.fused_mlp_fwd_shared_bytes.argtypes = [i]
    lib.fused_mlp_fwd_shared_bytes.restype = ctypes.c_int
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
    w, b, heads = packed(spec, net, x.device, pack_weights_d)
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    if N == 0:
        return out
    lib = _lib()
    stream = _build.current_stream(x.device)
    err = lib.fused_mlp_fwd_launch(
        x.data_ptr(), out.data_ptr(), w.data_ptr(), b.data_ptr(), heads.data_ptr(),
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
