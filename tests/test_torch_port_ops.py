"""The port's kernel modules vs the JAX package, on the CPU.

On the CPU every wrapper takes its kernel's plain PyTorch version; these tests
hold those plain versions (and the weight pack the CUDA kernel reads) against
the JAX oracles and the Pallas kernels in interpret mode. The kernels
themselves run on the card, through chip_smoke.py and
tests/test_torch_port_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu.core import sampling as jax_sampling
from smpl_nerf_tpu.models import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.models import WarpFieldNet as JaxWarpFieldNet
from smpl_nerf_tpu.ops import fused_mlp as jax_fused
from smpl_nerf_tpu.ops import fused_mlp_v2 as jax_v2
from smpl_nerf_tpu.ops.sample_pdf_pallas import sample_pdf_fused as jax_sample_pdf_fused
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.models import RenderRayNet, WarpFieldNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda
from smpl_nerf_tpu_torch.training.checkpoints import params_from_jax

# the inverse-CDF inversion can flip a bin where u equals a cdf entry to float
# precision; the sample then moves by a fraction of a bin (tests/test_ops.py)
PDF_ATOL = 2e-4


def to_np(t):
    return t.detach().float().cpu().numpy()


def _pdf_inputs(rng, R, K, empty=0.0):
    """The inputs of tests/test_ops.py; `empty` zeroes that share of the bins."""
    bins = np.sort(rng.uniform(1, 4, (R, K)).astype(np.float32), -1)
    weights = rng.uniform(0, 1, (R, K - 1)).astype(np.float32)
    weights[rng.uniform(size=weights.shape) < empty] = 0.0
    return bins, weights


# ------------------------------------------------------------- kernel A, plain

@pytest.mark.parametrize("R,K,F", [(7, 63, 128), (300, 63, 128), (5, 15, 16)])
def test_sample_pdf_plain_matches_jax_sample_pdf(rng, R, K, F):
    bins, weights = _pdf_inputs(rng, R, K)
    want = np.asarray(jax_sampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), F))
    got = to_np(sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), F))
    np.testing.assert_allclose(got, want, atol=PDF_ATOL)


@pytest.mark.parametrize("R,K,F", [(7, 63, 128), (5, 15, 16)])
def test_sample_pdf_plain_matches_pallas_interpret(rng, R, K, F):
    bins, weights = _pdf_inputs(rng, R, K)
    want = np.asarray(jax_sample_pdf_fused(jnp.asarray(bins), jnp.asarray(weights), F))
    got = to_np(sample_pdf_cuda.sample_pdf_fused(torch.from_numpy(bins),
                                                 torch.from_numpy(weights), F))
    np.testing.assert_allclose(got, want, atol=PDF_ATOL)


def test_sample_pdf_plain_with_empty_bins_flips_at_most_one_bin(rng):
    # Empty bins (zero weight, as in empty space) leave cdf steps of ~1e-5/sum,
    # so a u within rounding of such a step lands one bin over in one of the
    # two implementations: rare, and bounded by the widest bin.
    bins, weights = _pdf_inputs(rng, 300, 63, empty=0.3)
    want = np.asarray(jax_sampling.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 128))
    got = to_np(sampling.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 128))
    err = np.abs(got - want)
    assert (err > PDF_ATOL).mean() < 5e-3
    assert err.max() <= np.diff(bins, axis=-1).max()


def test_sample_pdf_wrapper_takes_plain_version_on_cpu(rng):
    bins, weights = _pdf_inputs(rng, 9, 63)
    b, w = torch.from_numpy(bins), torch.from_numpy(weights)
    before = sample_pdf_cuda.launches
    np.testing.assert_array_equal(to_np(sample_pdf_cuda.sample_pdf_fused(b, w, 128)),
                                  to_np(sampling.sample_pdf(b, w, 128)))
    assert sample_pdf_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        sample_pdf_cuda.sample_pdf_cuda(b, w, 128)


def test_sample_pdf_concentrated_weights():
    R, K, F = 4, 63, 64
    bins = torch.linspace(1, 4, K).repeat(R, 1)
    weights = torch.full((R, K - 1), 1e-8)
    weights[:, 30] = 1.0
    got = sampling.sample_pdf(bins, weights, F)
    assert abs(float(got.median()) - float(bins[0, 30:32].mean())) < 0.2


# ------------------------------------------------------------- kernel B, plain

def _jax_net(n_layers=3, width=32, pos_f=4, dir_f=2, add=0, skips=(1,), use_dir=True,
             dtype=jnp.float32, seed=0):
    net = JaxRenderRayNet(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                          directions_dim=6 * dir_f, additional_input_dim=add, skips=skips,
                          use_directional_input=use_dir, dtype=dtype)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 6 * (pos_f + dir_f) + add)))
    # non-zero biases, so a bias added in the wrong place shows
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(np.random.RandomState(seed).randn(*p.shape),
                                         jnp.float32) if p.ndim == 1 else p, params)
    return net, params


def _port_net(params, n_layers=3, width=32, pos_f=4, dir_f=2, add=0, skips=(1,),
              use_dir=True, dtype=torch.float32):
    net = RenderRayNet(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                       directions_dim=6 * dir_f, additional_input_dim=add, skips=skips,
                       use_directional_input=use_dir, compute_dtype=dtype)
    net.load_state_dict(params_from_jax({"m": params})["m"])
    return net


def _raw_rows(rng, n, add=0):
    pre = rng.randn(n, add).astype(np.float32)
    p3 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d3 = rng.randn(n, 3).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    return np.concatenate([pre, p3, d3], -1)


def _specs(dtype, **kw):
    kw = dict(dict(n_layers=3, width=32, pos_f=4, dir_f=2, add=0, skips=(1,),
                   use_dir=True), **kw)
    common = dict(n_layers=kw["n_layers"], width=kw["width"],
                  positions_dim=6 * kw["pos_f"], directions_dim=6 * kw["dir_f"],
                  additional_input_dim=kw["add"], skips=tuple(kw["skips"]),
                  use_directional_input=kw["use_dir"], dtype=dtype)
    return jax_fused.MlpSpec(**common), fused_mlp.MlpSpec(**common), kw


@pytest.mark.parametrize("kw", [{}, {"skips": (0, 2), "use_dir": False},
                                {"add": 8}, {"pos_f": 10, "dir_f": 4, "n_layers": 4}])
def test_v2_reference_forward_raw_matches_jax_f32(rng, kw):
    jspec, pspec, kw = _specs("float32", **kw)
    _, params = _jax_net(kw["n_layers"], kw["width"], kw["pos_f"], kw["dir_f"], kw["add"],
                         kw["skips"], kw["use_dir"])
    net = _port_net(params, kw["n_layers"], kw["width"], kw["pos_f"], kw["dir_f"],
                    kw["add"], kw["skips"], kw["use_dir"])
    x = _raw_rows(rng, 70, kw["add"])
    want = np.asarray(jax_v2.reference_forward_raw(
        jspec, jax_fused.flatten_params(jspec, params), jnp.asarray(x)))
    got = to_np(fused_mlp_v2.fused_apply_raw(pspec, net, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_v2_reference_forward_raw_matches_jax_bf16(rng):
    # bf16 activations: one summation-order difference can flip a bf16
    # rounding (2^-8 relative) and carry through later layers
    jspec, pspec, kw = _specs("bfloat16", pos_f=10, dir_f=4, width=64, n_layers=4)
    _, params = _jax_net(4, 64, 10, 4)
    net = _port_net(params, 4, 64, 10, 4, dtype=torch.bfloat16)
    x = _raw_rows(rng, 200)
    want = np.asarray(jax_v2.reference_forward_raw(
        jspec, jax_fused.flatten_params(jspec, params), jnp.asarray(x)))
    got = to_np(fused_mlp_v2.fused_apply_raw(pspec, net, torch.from_numpy(x)))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-2 * scale
    assert np.abs(got - want).mean() <= 2e-3 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v1_reference_forward_matches_jax(rng, dtype):
    jspec, pspec, kw = _specs(dtype, add=5)
    _, params = _jax_net(add=5)
    net = _port_net(params, add=5)
    x = rng.randn(40, jspec.in_dim).astype(np.float32)
    want = np.asarray(jax_fused.reference_forward(
        jspec, jax_fused.flatten_params(jspec, params), jnp.asarray(x)))
    got = to_np(fused_mlp.reference_forward(pspec, fused_mlp.flatten_params(pspec, net),
                                            torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32" else 2e-2)


def test_spec_from_model_and_flatten_match_jax():
    jnet, params = _jax_net(4, 64, 10, 4, skips=(2,))
    net = _port_net(params, 4, 64, 10, 4, skips=(2,), dtype=torch.bfloat16)
    jnet_bf16 = JaxRenderRayNet(n_layers=4, width=64, positions_dim=60, directions_dim=24,
                                skips=(2,), dtype=jnp.bfloat16)
    jspec = jax_fused.spec_from_model(jnet_bf16)
    pspec = fused_mlp.spec_from_model(net)
    assert dataclasses_equal(jspec, pspec)
    for a, b in zip(jax_fused.flatten_params(jspec, params), fused_mlp.flatten_params(pspec, net)):
        np.testing.assert_array_equal(to_np(b), np.asarray(a))


def dataclasses_equal(a, b):
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_encoding_matrices_match_jax():
    for d, L in ((3, 10), (3, 4), (2, 1)):
        for got, want in zip(fused_mlp_v2.encoding_matrices(d, L), jax_v2.encoding_matrices(d, L)):
            np.testing.assert_array_equal(got, want)


def test_supports_and_kernel_gate():
    spec = fused_mlp.MlpSpec(positions_dim=60, directions_dim=24)
    assert fused_mlp_v2.supports(spec, PositionalEncoder(10, False), PositionalEncoder(4, False))
    assert not fused_mlp_v2.supports(spec, PositionalEncoder(10, True), PositionalEncoder(4, False))
    assert fused_mlp_v2.kernel_supports(spec) == ""
    assert "bfloat16" in fused_mlp_v2.kernel_supports(
        fused_mlp.MlpSpec(dtype="float32"))
    assert "prefix" in fused_mlp_v2.kernel_supports(fused_mlp.MlpSpec(additional_input_dim=4))
    assert "width" in fused_mlp_v2.kernel_supports(fused_mlp.MlpSpec(width=512))


def _emulate_packed_kernel(spec, w, b, table, x_raw):
    """The CUDA kernel's algorithm step by step on the CPU, reading the same
    weight pack: padded encodings, segment-wise K, f32 bias, bf16 rounding."""
    Lp, Ld = spec.positions_dim // 6, spec.directions_dim // 6
    r16 = lambda n: (n + 15) // 16 * 16

    def encode(coords, L):
        c = torch.arange(r16(6 * L))
        k, within = c // 6, c % 6
        t = coords[:, within % 3] * (2.0 ** k).float()
        t = torch.where(within >= 3, t + torch.tensor(np.float32(np.pi / 2)), t)
        return torch.where(c < 6 * L, torch.sin(t), torch.zeros(())).to(torch.bfloat16)

    pos, dirs = encode(x_raw[:, :3], Lp), encode(x_raw[:, 3:6], Ld)

    def layer(l, segs, relu):
        wo, bo, K, N = (int(v) for v in table[l])
        a = torch.cat(segs, -1).float()
        assert a.shape[1] == K
        y = a @ w[wo:wo + K * N].view(K, N).float() + b[bo:bo + N]
        return torch.relu(y) if relu else y

    n = spec.n_layers
    o = layer(0, [pos], True).bfloat16()
    for i in range(n - 1):
        o = layer(1 + i, [o] + ([pos] if i in spec.skips else []), True).bfloat16()
    o = layer(n, [o], False).bfloat16()
    sigma = layer(n + 3, [o], False)
    o = layer(n + 1, [o] + ([dirs] if spec.use_directional_input else []), False).bfloat16()
    o = layer(n + 2, [o], True).bfloat16()
    rgb = layer(n + 4, [o], False)
    return torch.cat([rgb, sigma], -1)


@pytest.mark.parametrize("kw", [{"pos_f": 10, "dir_f": 4, "width": 64, "skips": (1,)},
                                {"pos_f": 4, "dir_f": 2, "width": 32, "skips": (0, 2),
                                 "use_dir": False}])
def test_weight_pack_drives_kernel_math_to_plain_version(rng, kw):
    _, pspec, kw = _specs("bfloat16", **kw)
    _, params = _jax_net(kw["n_layers"], kw["width"], kw["pos_f"], kw["dir_f"],
                         skips=kw["skips"], use_dir=kw["use_dir"])
    net = _port_net(params, kw["n_layers"], kw["width"], kw["pos_f"], kw["dir_f"],
                    skips=kw["skips"], use_dir=kw["use_dir"], dtype=torch.bfloat16)
    w, b, table = fused_mlp.pack_weights(pspec, fused_mlp.flatten_params(pspec, net), "cpu")
    assert w.dtype == torch.bfloat16 and table.shape == (pspec.n_layers + 5, 4)
    assert all(int(k) % 16 == 0 for k in table[:-2, 2]) and all(int(o) % 8 == 0 for o in table[:, 0])
    x = torch.from_numpy(_raw_rows(rng, 96))
    got = _emulate_packed_kernel(pspec, w, b, table, x)
    want = fused_mlp_v2.reference_forward_raw(pspec, fused_mlp.flatten_params(pspec, net), x)
    np.testing.assert_allclose(to_np(got), to_np(want),
                               atol=1e-2 * float(want.detach().abs().max()))


def test_weight_pack_is_cached_on_the_module_until_weights_change():
    _, params = _jax_net()
    net = _port_net(params, dtype=torch.bfloat16)
    spec = fused_mlp.spec_from_model(net)
    first = fused_mlp.packed(spec, net, torch.device("cpu"))
    assert fused_mlp.packed(spec, net, torch.device("cpu")) is first
    with torch.no_grad():
        net.rgb_out_layer.bias.add_(1.0)
    assert fused_mlp.packed(spec, net, torch.device("cpu")) is not first


# --------------------------------------------------------------- the modules

@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_render_ray_net_matches_flax_apply(rng, dtype, atol):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jnet, params = _jax_net(4, 32, 4, 2, add=3, skips=(1, 2), dtype=jdt)
    net = _port_net(params, 4, 32, 4, 2, add=3, skips=(1, 2), dtype=tdt)
    x = rng.randn(33, 24 + 3 + 12).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    got = to_np(net(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_warp_field_net_matches_flax_apply(rng, dtype, atol):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jnet = JaxWarpFieldNet(width=16, positions_dim=24, pose_dim=12, dtype=jdt)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((2, 36)))
    net = WarpFieldNet(width=16, positions_dim=24, pose_dim=12, compute_dtype=tdt)
    net.load_state_dict(params_from_jax({"w": params})["w"])
    x = rng.randn(21, 36).astype(np.float32)
    want = np.asarray(jnet.apply(params, jnp.asarray(x)))
    got = to_np(net(torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, np.abs(want).max()))


def test_seeded_init_is_reproducible_and_device_independent():
    a = RenderRayNet(3, 32, 24, 12, skips=(1,), generator=torch.Generator().manual_seed(5))
    b = RenderRayNet(3, 32, 24, 12, skips=(1,), generator=torch.Generator().manual_seed(5))
    c = RenderRayNet(3, 32, 24, 12, skips=(1,), generator=torch.Generator().manual_seed(6))
    for (k, va), vb, vc in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb), k
        if k.endswith("weight"):
            assert not torch.equal(va, vc), k
            std = (1.0 / va.shape[1]) ** 0.5
            assert float(va.abs().max()) <= 2.0 * std / 0.87962566 + 1e-6
