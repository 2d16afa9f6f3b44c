"""Kernels B and C (the fused v2 forward and backward) as they are scheduled on
the card, emulated step by step on the CPU, against the plain versions and
the JAX package's Pallas kernels in interpret mode.

The emulations read what the kernels read: the chunk images of
`pack_weights_d`, the encodings the producer builds (x * 2^k exactly, + pi/2
for the cos blocks, sin, bf16), and they round where the kernels round. B's
is kernel D's schedule with encoded A chunks. C's is its two phases: the
recompute and the dH chain per row (bf16 dY, bf16 adds into d pos / d dir,
ReLU bits), then dW as 256-row slices each rounded to bf16, summed in
float32 within a split of slices and over the splits in order (the heads'
dW per slice, then over the slices); db and the heads' db in float32.
Sizes: 2-3 layers, W <= 64, <= 300 rows; weights drawn by JAX and carried
over with `params_from_jax`, inputs from seeded numpy.

Tolerances (as the card tests hold the kernels): forwards 2e-2 of the largest
output (max) and 2e-3 (mean): the same roundings in another summation order
can flip one bf16 rounding downstream. Backward: dX max 0.25 and mean 5e-3
of the reference's (a ReLU mask flip moves a row's dX by a whole term), every
dW and db by relative norm 3e-2 (JAX rounds dW per 256-row tile, torch's
autograd once over all rows).
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu.models import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.ops import fused_mlp as jax_fused
from smpl_nerf_tpu.ops import fused_mlp_v2 as jax_v2
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2
from smpl_nerf_tpu_torch.training import checkpoints

FWD_MAX, FWD_MEAN = 2e-2, 2e-3
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2
SLICE = 256
HALF_PI = np.float32(np.pi / 2)


def _nets(width=32, n_layers=3, skips=(1,), use_dir=True, pos_f=4, dir_f=2, seed=0, add=0):
    common = dict(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                  directions_dim=6 * dir_f, additional_input_dim=add, skips=tuple(skips),
                  use_directional_input=use_dir)
    params = JaxRenderRayNet(**common).init(jax.random.PRNGKey(seed),
                                             jnp.zeros((2, add + 6 * (pos_f + dir_f))))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rs.randn(*p.shape), jnp.float32) if p.ndim == 1 else p,
        params)
    net = RenderRayNet(**common, compute_dtype=torch.bfloat16)
    net.load_state_dict(checkpoints.params_from_jax({"m": params})["m"])
    return (jax_fused.MlpSpec(**common, dtype="bfloat16"), params,
            fused_mlp.MlpSpec(**common, dtype="bfloat16"), net)


def _raw_rows(rng, n, add=0):
    prefix = rng.uniform(-1, 1, (n, add)).astype(np.float32)
    p3 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d3 = rng.randn(n, 3).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    return np.concatenate([prefix, p3, d3], -1)


def _encode(coords, cols, chunks):
    """The producer's A chunks of one block: bf16(sin(x * 2^k (+ pi/2))) of
    64 * chunks columns, zero past the block's `cols`."""
    c = torch.arange(64 * chunks)
    k, within = c // 6, c % 6
    t = coords[:, within % 3] * (2.0 ** k).float()          # exact, as __fmul_rn
    t = torch.where(within >= 3, t + torch.tensor(HALF_PI), t)
    return torch.where(c < cols, torch.sin(t), torch.zeros(())).to(torch.bfloat16)


def _blocks(spec, x):
    """The producer's A chunks: the prefix+pos block ([bf16 prefix | pos
    encoding], zero-padded to its chunks: a chunk can hold both) and the dir
    block."""
    add = spec.additional_input_dim
    P, Dc = -(-spec.pos_block // 64), -(-spec.directions_dim // 64)
    pos = _encode(x[:, add:add + 3], spec.positions_dim, P)[:, :64 * P - add]
    return {"pos": torch.cat([x[:, :add].to(torch.bfloat16), pos], -1),
            "dir": _encode(x[:, add + 3:add + 6], spec.directions_dim, Dc)}


def _layer_weights(spec, w):
    """Each dense layer of `d_layout` as float32 [K padded, N padded], put back
    together from its chunk images."""
    out, off = [], 0
    for _, segments, _, n_pad in fused_mlp.d_layout(spec):
        k_pad = sum(padded for _, _, padded in segments)
        images = w[off:off + k_pad * n_pad].view(k_pad // 64, n_pad, 64)
        out.append(fused_mlp.swizzle_chunks_inverse(images).float())
        off += k_pad * n_pad
    assert off == w.numel()
    return out


def _inputs(spec, layer, H, blocks):
    """Layer `layer`'s bf16 input rows: the previous output, then its encoding block."""
    _, segments, _, _ = fused_mlp.d_layout(spec)[layer]
    parts = [H[layer - 1] if src == "act" else blocks[src] for src, _, _ in segments]
    return torch.cat(parts, -1)


def _emulate_forward(spec, w, b, heads, x):
    """B's schedule: per layer the accumulator starts from the float32 bias and
    takes the chunks in stream order (activations, then encoded A chunks);
    bf16 where the kernel rounds. Returns (out [N, 4], H per layer)."""
    WP = fused_mlp.padded_width(spec)
    blocks, Wm = _blocks(spec, x), _layer_weights(spec, w)
    H, b_off = [], 0
    relu_free = {"additional_linear_layer", "directional_input"}
    for l, (name, segments, _, n_pad) in enumerate(fused_mlp.d_layout(spec)):
        acc = b[b_off:b_off + n_pad].expand(x.shape[0], n_pad)
        b_off += n_pad
        a = _inputs(spec, l, H, blocks).float()
        for c in range(a.shape[1] // 64):
            acc = acc + a[:, 64 * c:64 * c + 64] @ Wm[l][64 * c:64 * c + 64]
        H.append((acc if name in relu_free else torch.relu(acc)).to(torch.bfloat16))
    n = spec.n_layers
    sigma = H[n].float() @ heads[:WP] + heads[-1]
    hw = heads[WP:WP + 3 * (WP // 2)].view(WP // 2, 3)
    rgb = H[n + 2].float() @ hw + heads[WP + 3 * (WP // 2):WP + 3 * (WP // 2) + 3]
    return torch.cat([rgb, sigma[:, None]], -1), H, blocks, Wm


def _emulate_kernel_b(spec, w, b, heads, x):
    return _emulate_forward(spec, w, b, heads, x)[0]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _sliced_sum(a, y, sps):
    """sum over 256-row slices of bf16(a[slice]^T @ y[slice]), float32, summed
    within each split of `sps` slices and then over the splits in order."""
    N = a.shape[0]
    total = None
    for s0 in range(0, -(-N // SLICE), sps):
        part = None
        for sl in range(s0, min(s0 + sps, -(-N // SLICE))):
            rows = slice(sl * SLICE, min(N, (sl + 1) * SLICE))
            v = _bf16(a[rows].float().t() @ y[rows].float())
            part = v if part is None else part + v
        total = part if total is None else total + part
    return total


def _emulate_kernel_c(spec, w, b, heads, x, g, sps=1):
    """C's two phases on the CPU; returns (gradient buffer, dX)."""
    WP, n = fused_mlp.padded_width(spec), spec.n_layers
    _, H, blocks, Wm = _emulate_forward(spec, w, b, heads, x)
    layout = fused_mlp.d_layout(spec)
    dY = [None] * (n + 3)
    d_enc = {"pos": torch.zeros_like(blocks["pos"]), "dir": torch.zeros_like(blocks["dir"])}

    def backward_of(l):
        """bf16(dY_l @ W_l^T): the activation part, and the encoding part added into d enc."""
        dh = _bf16(dY[l].float() @ Wm[l].t())
        _, segments, _, _ = layout[l]
        r = 0
        act = None
        for src, _, padded in segments:
            if src == "act":
                act = dh[:, r:r + padded]
            else:
                d_enc[src] = (d_enc[src].float() + dh[:, r:r + padded]).to(torch.bfloat16)
            r += padded
        return act

    hw_rgb = heads[WP:WP + 3 * (WP // 2)].view(WP // 2, 3)
    dY[n + 2] = (_bf16(g[:, :3] @ hw_rgb.t()) * (H[n + 2].float() > 0)).to(torch.bfloat16)
    dY[n + 1] = backward_of(n + 2).to(torch.bfloat16)
    dh_add = backward_of(n + 1)
    dY[n] = (dh_add + _bf16(g[:, 3:4] * heads[:WP])).to(torch.bfloat16)
    for l in range(n, 0, -1):
        dY[l - 1] = (backward_of(l) * (H[l - 1].float() > 0)).to(torch.bfloat16)
    backward_of(0)

    # dX: the prefix columns are d prefix; d enc * cos(arg) * 2^k per coordinate
    add = spec.additional_input_dim
    dx = torch.zeros(x.shape[0], add + 6)
    dx[:, :add] = d_enc["pos"][:, :add].float()
    for blk, coord0, lead, cols in (("pos", add, add, spec.positions_dim),
                                    ("dir", add + 3, 0, spec.directions_dim)):
        if blk == "dir" and not spec.use_directional_input:
            continue
        c = torch.arange(cols)
        k, within = c // 6, c % 6
        t = x[:, coord0 + within % 3] * (2.0 ** k).float()
        t = torch.where(within >= 3, t + torch.tensor(HALF_PI), t)
        v = d_enc[blk][:, lead:lead + cols].float() * torch.cos(t) * (2.0 ** k).float()
        for j in range(3):
            dx[:, coord0 + j] = v[:, within % 3 == j].sum(-1)

    dws, dbs = [], []
    for l in range(n + 3):
        dws.append(_sliced_sum(_inputs(spec, l, H, blocks), dY[l], sps).reshape(-1))
        dbs.append(dY[l].float().sum(0))
    sig = _sliced_sum(H[n], g[:, 3:4], 1).reshape(-1)      # the heads: a unit per slice
    rgb = _sliced_sum(H[n + 2], g[:, :3], 1).reshape(-1)
    heads_g = torch.cat([sig, rgb, g[:, :3].sum(0), g[:, 3:4].sum(0)])
    return torch.cat(dws + dbs + [heads_g]), dx


def _flat(net, spec):
    return fused_mlp.flatten_params(spec, net)


# ------------------------------------------------------------------ kernel B

@pytest.mark.parametrize("kw", [{}, {"width": 64, "skips": (0, 1)}, {"use_dir": False},
                                {"n_layers": 2, "skips": (), "pos_f": 10, "dir_f": 4},
                                {"pos_f": 12, "width": 32},     # a pos block of two chunks
                                # a prefix: chunk 0 holds 45 prefix and 19 encoded columns
                                {"add": 45}, {"add": 130, "skips": (0, 1)}])
def test_kernel_b_schedule_matches_plain_and_jax_pallas_forward_interpret(rng, kw):
    jspec, params, pspec, net = _nets(**kw)
    w, b, heads = fused_mlp.pack_weights_d(pspec, _flat(net, pspec), "cpu")
    x = _raw_rows(rng, 300, pspec.additional_input_dim)
    got = _emulate_kernel_b(pspec, w, b, heads, torch.from_numpy(x)).numpy()
    plain = fused_mlp_v2.reference_forward_raw(pspec, _flat(net, pspec),
                                               torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jax_v2._pallas_forward(jspec, jax_v2._enc_mats(jspec),
                                             jax_fused.flatten_params(jspec, params),
                                             jnp.asarray(x), True))
    for ref in (plain, want):
        assert np.abs(got - ref).max() <= FWD_MAX * np.abs(ref).max()
        assert np.abs(got - ref).mean() <= FWD_MEAN * np.abs(ref).mean()


def test_kernel_b_encoding_is_the_plain_versions_bf16_encoding(rng):
    """The producer's x * 2^k (+ pi/2) and sin give the plain version's
    encoding (sin(x @ M + P)) to one bf16 step."""
    _, _, pspec, _ = _nets(pos_f=10, dir_f=4)
    x = torch.from_numpy(_raw_rows(rng, 300))
    blocks = _blocks(pspec, x)
    Mp, Pp = (torch.as_tensor(m) for m in fused_mlp_v2.encoding_matrices(3, 10))
    want = torch.sin(x[:, :3] @ Mp + Pp)
    got = blocks["pos"][:, :60].float()
    assert float((got - want).abs().max()) <= 2.0 ** -8
    assert not blocks["pos"][:, 60:].float().any()


# ------------------------------------------------------------------ kernel C

def _check_backward(dflat, dx, want_flat, want_dx):
    dx, want_dx = np.asarray(dx, np.float32), np.asarray(want_dx, np.float32)
    err = np.abs(dx - want_dx)
    assert err.max() <= BWD_DX_MAX * np.abs(want_dx).max()
    assert err.mean() <= BWD_DX_MEAN * np.abs(want_dx).mean()
    assert len(dflat) == len(want_flat)
    for i, (a, b) in enumerate(zip(dflat, want_flat)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, i
        assert np.linalg.norm(a - b) <= BWD_DW_REL * np.linalg.norm(b) + 1e-12, i


@pytest.mark.parametrize("kw", [{}, {"width": 64, "skips": (0, 1)}, {"use_dir": False},
                                {"n_layers": 2, "skips": (), "pos_f": 10, "dir_f": 4},
                                {"add": 45}])        # chunk 0: 45 prefix, 19 encoded columns
@pytest.mark.parametrize("sps", [1, 2])
def test_kernel_c_schedule_matches_plain_and_jax_pallas_backward_interpret(rng, kw, sps):
    jspec, params, pspec, net = _nets(**kw)
    w, b, heads = fused_mlp.pack_weights_d(pspec, _flat(net, pspec), "cpu")
    # a whole 256-row slice and a ragged one
    x = _raw_rows(rng, 300, pspec.additional_input_dim)
    g = rng.randn(300, 4).astype(np.float32)
    grads, dx = _emulate_kernel_c(pspec, w, b, heads, torch.from_numpy(x),
                                  torch.from_numpy(g), sps)
    assert grads.numel() == fused_mlp.grad_count_d(pspec)
    got = fused_mlp.unpack_grads_d(pspec, grads)
    plain_flat, plain_dx = fused_mlp_v2.reference_backward_raw(
        pspec, _flat(net, pspec), torch.from_numpy(x), torch.from_numpy(g))
    want_flat, want_dx = jax_v2._pallas_backward(jspec, jax_v2._enc_mats(jspec),
                                                 jax_fused.flatten_params(jspec, params),
                                                 jnp.asarray(x), jnp.asarray(g), True)
    _check_backward([t.numpy() for t in got], dx.numpy(),
                    [t.detach().numpy() for t in plain_flat], plain_dx.detach().numpy())
    _check_backward([t.numpy() for t in got], dx.numpy(), want_flat, want_dx)
    add = pspec.additional_input_dim
    if not pspec.use_directional_input:
        assert not dx[:, add + 3:].any()
    if add:                     # the prefix columns apart: no cos * 2^k there
        _check_backward([], dx[:, :add].numpy(), [], plain_dx[:, :add].detach().numpy())
        _check_backward([], dx[:, :add].numpy(), [], np.asarray(want_dx)[:, :add])


@pytest.mark.parametrize("kw", [{}, {"width": 96, "skips": (0, 2), "n_layers": 4},
                                {"width": 160, "use_dir": False, "pos_f": 12},
                                {"width": 256, "n_layers": 8, "skips": (4,), "pos_f": 10,
                                 "dir_f": 4}])
def test_kernel_c_gradient_buffer_round_trips(kw):
    """unpack_grads_d inverts the layout kernel C writes: dense blocks [K
    padded, N padded] per d_layout layer (padding rows and columns left
    out), then padded db, then the heads."""
    _, _, spec, net = _nets(**kw)
    gen = torch.Generator().manual_seed(0)
    flat = [torch.randn(t.shape, generator=gen) for t in _flat(net, spec)]
    names = fused_mlp._param_order(spec)
    by_name = {name: (flat[2 * i], flat[2 * i + 1]) for i, name in enumerate(names)}
    WP = fused_mlp.padded_width(spec)
    dws, dbs = [], []
    for name, segments, n_real, n_pad in fused_mlp.d_layout(spec):
        k, bias = by_name[name]
        rows, r = [], 0
        for _, real, padded in segments:
            block = torch.zeros(padded, n_pad)
            block[:real, :n_real] = k[r:r + real]
            rows.append(block)
            r += real
        dws.append(torch.cat(rows).reshape(-1))
        db = torch.zeros(n_pad)
        db[:n_real] = bias
        dbs.append(db)
    sig_k, sig_b = by_name["sigma_out_layer"]
    rgb_k, rgb_b = by_name["rgb_out_layer"]
    sig = torch.zeros(WP)
    sig[:spec.width] = sig_k[:, 0]
    rgb = torch.zeros(WP // 2, 3)
    rgb[:spec.width // 2] = rgb_k
    buf = torch.cat(dws + dbs + [sig, rgb.reshape(-1), rgb_b, sig_b])
    assert buf.numel() == fused_mlp.grad_count_d(spec)
    back = fused_mlp.unpack_grads_d(spec, buf)
    assert len(back) == len(flat)
    for a, b in zip(back, flat):
        assert torch.equal(a, b)


# --------------------------------------------------- what the kernels take

def _old_v2_supports(spec):
    """What the first kernels B and C took (their kernel_supports)."""
    return (not fused_mlp.topology_reason(spec) and not spec.additional_input_dim
            and spec.positions_dim > 0 and spec.directions_dim > 0)


@pytest.mark.parametrize("width", [32, 64, 96, 128, 160, 192, 224, 256])
@pytest.mark.parametrize("n_layers,skips", [(1, ()), (2, (0,)), (8, (4,)), (32, (0, 15, 30))])
@pytest.mark.parametrize("pos_f,dir_f,use_dir", [(10, 4, True), (1, 1, False), (16, 12, True)])
def test_kernels_b_and_c_take_every_net_the_first_kernels_took(width, n_layers, skips, pos_f,
                                                                dir_f, use_dir):
    spec = fused_mlp.MlpSpec(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                             directions_dim=6 * dir_f, skips=skips,
                             use_directional_input=use_dir)
    assert _old_v2_supports(spec)
    assert fused_mlp_v2.kernel_supports(spec) == ""
    for backward in (False, True):
        assert fused_mlp_v2.shared_bytes(spec, backward) <= fused_mlp.MAX_SHARED_BYTES
    # the gradient buffer holds every parameter of the net once, besides padding
    n_params = sum(t.numel() for t in fused_mlp.pack_weights_d(
        spec, _flat(RenderRayNet(n_layers=n_layers, width=width,
                                 positions_dim=6 * pos_f, directions_dim=6 * dir_f,
                                 skips=skips, use_directional_input=use_dir), spec),
        "cpu")[:2]) + 3 * (fused_mlp.padded_width(spec) // 2) + fused_mlp.padded_width(spec) + 4
    assert fused_mlp.grad_count_d(spec) == n_params


@pytest.mark.parametrize("width", [32, 128, 160, 256])
@pytest.mark.parametrize("add", [5, 18, 45, 64, 621, 1200])
def test_kernels_b_and_c_take_prefixed_nets(width, add):
    """Every net the first kernels took, with a conditioning prefix in front
    of the position encoding: the prefix streams through the A chunks of the
    prefix+pos block, so it changes neither the shared memory nor the pack's
    layers, and the gradient buffer grows by the prefix rows of the first
    and the skip layers."""
    spec = fused_mlp.MlpSpec(width=width, additional_input_dim=add)
    plain = fused_mlp.MlpSpec(width=width)
    assert not _old_v2_supports(spec) and _old_v2_supports(plain)
    assert fused_mlp_v2.kernel_supports(spec) == ""
    for backward in (False, True):
        assert fused_mlp_v2.shared_bytes(spec, backward) == \
            fused_mlp_v2.shared_bytes(plain, backward)
    WP = fused_mlp.padded_width(spec)
    pos_chunks = lambda s: -(-s.pos_block // 64)
    extra_rows = 64 * (pos_chunks(spec) - pos_chunks(plain)) * (1 + len(spec.skips))
    assert fused_mlp.grad_count_d(spec) - fused_mlp.grad_count_d(plain) == extra_rows * WP
