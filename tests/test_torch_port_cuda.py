"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (decided when the
test runs). The module imports neither JAX nor the JAX package, so it also
runs on a machine without them; there the repository's tests/conftest.py,
which imports JAX, is left out:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: kernel A's cumsum adds in another order than torch.cumsum, so a
rare sample flips one bin (bounded by the widest bin); kernels B and D round
to bf16 at the same places as their plain versions but accumulate in another
order, which can flip one bf16 rounding (2^-8 relative) downstream. Kernel C
has the same roundings; besides, a ReLU mask flips where the two forwards put
an activation on either side of 0, which moves one row's dX by a whole term
(bounded by max and by mean), while every dW and db is a sum over all rows
and is held by relative norm (C rounds dW to bf16 per 256-row slice, as the
JAX kernel's tiles do, where the plain version rounds once); C has no
atomics, so two runs agree bit for bit. Kernel E in float32 differs from its plain
version only in summation order (2e-5, the JAX package's bound for its
kernel); in bf16 one rounding can flip and the second layer carries it
(5e-2 absolute on outputs of order 1). Kernel F multiplies bf16 values
exactly and sums in float32 in another order, so an output can land on the
other side of one bf16 rounding (2^-7 relative); next to zero, where relu
cuts, the float32 sums themselves differ by their own rounding (5e-5).
Kernel G (the vertex attention) rounds every logit as the eager path does
((dx^2 + dy^2) + dz^2 with no FMA, the same sqrtf and expf) and takes the
global max from the least squared distance, so each exp(att - M) is the
eager path's; the sums run in another order (16 lanes, then their partials
in lane order, against 512-vertex chunks, sum() and bmm), and exp(-M) is
subtracted per pair rather than as exp(-M) sum_v w after the sums: 1e-5 of
the largest warp. It has no atomics on floats, so two runs agree bit for bit.
Kernel H (the normalised-ReLU attention and its backward) takes every pair's
a = relu(r - d) as the eager path rounds it, so the forward differs only in
the order of its sums (ATT_REL); its gradients sum per pair what autograd
sums per chunk (c (s - v) / d where autograd takes grad / (2 d) times 2 (s -
v)): 1e-4 by norm (RELU_GRAD_REL), far under what a wrong or missing term
moves. Against float64 H must be no further than twice the eager float32
path, or within 1e-5 by norm: its sums over samples are longer chains than
autograd's. It has no float atomics: two runs agree bit for bit. Four
image_wise_dynamic steps through H and through the eager path from one seed:
the losses within 1e-5 (a few float32 ulps of the warps), the arm angles
within 3e-4 rad (Adam moves each by ~3e-3 a step; the gradients after the
first step differ in float32's rounding, by up to ~1e-2 relative where a
sample's attention sum is small, which moves a step by ~3e-5).
The hash-grid field (--grid_encoding 2) in float32: the tables' gradients are
sums over every lookup that hit an entry, in the order the card's atomics
take them; each within 1e-4 by norm, the raw outputs within 1e-6.
"""
import _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch import config
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import (expert_tiles, fused_mlp, fused_mlp_v2, occupancy,
                                     relu_matmul, sample_pdf_cuda, vertex_attention)
from smpl_nerf_tpu_torch.parallel import ep
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.render import experts as ex
from smpl_nerf_tpu_torch.render import fast
from smpl_nerf_tpu_torch.training import factory, solver

PDF_ATOL = 2e-4
MLP_REL = 2e-2
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2
ATT_REL = 1e-5
RELU_GRAD_REL, RELU_F64_FACTOR, RELU_F64_FLOOR = 1e-4, 2.0, 1e-5
IW_STEPS, IW_LOSS_REL, IW_ANGLE_ATOL = 4, 1e-5, 3e-4
HASH_RAW_REL, HASH_LOSS_REL, HASH_GRAD_REL = 1e-6, 1e-5, 1e-4


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (chip_smoke.py runs the kernels)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.RandomState(0)


def _pdf_inputs(gen, R, K, empty):
    bins = np.sort(gen.uniform(1, 4, (R, K)).astype(np.float32), -1)
    weights = gen.uniform(0, 1, (R, K - 1)).astype(np.float32)
    weights[gen.uniform(size=weights.shape) < empty] = 0.0
    return bins, weights


@pytest.mark.parametrize("R,K,F,empty", [(1001, 63, 128, 0.0), (1001, 63, 128, 0.3),
                                         (7, 15, 16, 0.0), (3, 200, 40, 0.0),
                                         (711, 63, 128, 0.3)])   # an auto-cap budget of rays
def test_sample_pdf_kernel_matches_plain(gen, cuda, R, K, F, empty):
    bins, weights = _pdf_inputs(gen, R, K, empty)
    b, w = torch.from_numpy(bins).to(cuda), torch.from_numpy(weights).to(cuda)
    before = sample_pdf_cuda.launches
    got = sample_pdf_cuda.sample_pdf_fused(b, w, F)
    want = sampling.sample_pdf(b, w, F)
    torch.cuda.synchronize()
    assert sample_pdf_cuda.launches == before + 1
    err = (got - want).abs().cpu().numpy()
    if empty:
        assert (err > PDF_ATOL).mean() < 5e-3
        assert err.max() <= np.diff(bins, axis=-1).max()
    else:
        assert err.max() <= PDF_ATOL


@pytest.mark.parametrize("K", [2, 3, 63, 64, 65, 1024])
@pytest.mark.parametrize("F", [1, 2, 31, 128, 257])
def test_sample_pdf_kernel_matches_plain_at_every_lane_run_and_chunk(gen, cuda, K, F):
    """The shapes of the kernel's CPU emulation (tests/test_torch_port_ae_hopper.py):
    one to 32 weights per lane, runs of samples with and without float4 stores."""
    bins, weights = _pdf_inputs(gen, 64, K, 0.0)
    b, w = torch.from_numpy(bins).to(cuda), torch.from_numpy(weights).to(cuda)
    got = sample_pdf_cuda.sample_pdf_fused(b, w, F)
    want = sampling.sample_pdf(b, w, F)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= PDF_ATOL
    bins, weights = _pdf_inputs(gen, 64, K, 0.3)
    b, w = torch.from_numpy(bins).to(cuda), torch.from_numpy(weights).to(cuda)
    err = (sample_pdf_cuda.sample_pdf_fused(b, w, F) - sampling.sample_pdf(b, w, F)).abs()
    assert float(err.max()) <= float(np.diff(bins, axis=-1).max())


def test_sample_pdf_wrapper_checks_its_inputs(cuda):
    bins = torch.rand(4, 9, device=cuda).sort(-1)[0]
    weights = torch.rand(4, 8, device=cuda)
    with pytest.raises(TypeError):
        sample_pdf_cuda.sample_pdf_fused(bins.double(), weights.double(), 8)
    with pytest.raises(ValueError):
        sample_pdf_cuda.sample_pdf_fused(bins, weights[:, :7].contiguous(), 8)
    with pytest.raises(ValueError):
        sample_pdf_cuda.sample_pdf_fused(bins.t().contiguous().t(), weights, 8)
    with pytest.raises(ValueError):
        sample_pdf_cuda.sample_pdf_fused(bins, weights.cpu(), 8)


def _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed, add=0):
    g = torch.Generator().manual_seed(seed)
    net = RenderRayNet(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                       directions_dim=6 * dir_f, additional_input_dim=add, skips=skips,
                       use_directional_input=use_dir, compute_dtype=torch.bfloat16, generator=g)
    with torch.no_grad():
        for layer in net.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.bias.copy_(0.05 * torch.randn(layer.bias.shape, generator=g))
    return net.to(cuda).requires_grad_(False)


def _rows(gen, n, cuda):
    p3 = gen.uniform(-2, 2, (n, 3)).astype(np.float32)
    d3 = gen.randn(n, 3).astype(np.float32)
    d3 /= np.linalg.norm(d3, axis=-1, keepdims=True)
    return torch.from_numpy(np.concatenate([p3, d3], -1)).to(cuda)


@pytest.mark.parametrize("n_layers,width,pos_f,dir_f,skips,use_dir", [
    (8, 256, 10, 4, (4,), True),     # the arm_angles.txt nets
    (3, 64, 4, 2, (0, 2), False),
    (2, 32, 1, 1, (), True),
])
def test_fused_v2_kernel_matches_plain(gen, cuda, n_layers, width, pos_f, dir_f, skips,
                                       use_dir):
    net = _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed=width)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, 1000, cuda)          # 1000 = 15 full 64-row tiles + a ragged one
    before, rows = fused_mlp_v2.launches, fused_mlp_v2.rows
    got = fused_mlp_v2.fused_apply_raw(spec, net, x)
    want = fused_mlp_v2.reference_forward_raw(spec, fused_mlp.flatten_params(spec, net), x)
    torch.cuda.synchronize()
    assert (fused_mlp_v2.launches - before, fused_mlp_v2.rows - rows) == (1, 1000)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())


def test_fused_v2_wrapper_refuses_what_the_kernel_does_not_take(gen, cuda):
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=1)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, 100, cuda)
    with pytest.raises(ValueError):
        fused_mlp_v2.fused_apply_raw(spec, net, x.double())
    with pytest.raises(ValueError):
        fused_mlp_v2.fused_apply_raw(spec, net, x[:, :5].contiguous())
    with pytest.raises(ValueError):
        fused_mlp_v2.fused_backward_cuda(spec, net, x, torch.ones(100, 3, device=cuda))
    # a prefixed net takes rows of add + 6 columns, and no others
    prefixed = _net(cuda, 3, 64, 4, 2, (1,), True, seed=1, add=5)
    pspec = fused_mlp.spec_from_model(prefixed)
    with pytest.raises(ValueError):
        fused_mlp_v2.fused_apply_raw(pspec, prefixed, x)
    before = fused_mlp_v2.launches
    assert fused_mlp_v2.fused_apply_raw(pspec, prefixed,
                                        torch.zeros(10, 11, device=cuda)).shape == (10, 4)
    assert fused_mlp_v2.launches == before + 1


def _smpl_args(*extra):
    return config.config_parser().parse_args([
        "--config=/dev/null", "--model_type=smpl_nerf", "--human_pose_encoding=1",
        "--netdepth=3", "--netwidth=64", "--skips=1", "--netdepth_fine=3",
        "--netwidth_fine=64", "--skips_fine=1", "--netwidth_warp=32",
        "--number_coarse_samples=16", "--number_fine_samples=32",
        "--number_frequencies_postitional=6", "--number_frequencies_directional=2",
        "--number_frequencies_pose=3", "--sigma_noise_std=0", "--use_pallas=1", *extra])


def _smpl_batch(gen, R):
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = gen.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    return {"ray_translation": origins, "ray_direction": dirs,
            "human_pose": gen.uniform(-0.5, 0.5, (R, 69)).astype(np.float32)}


@pytest.mark.parametrize("dtype,want_v2", [("bfloat16", 2), ("float32", 0)])
def test_auto_fused_mode_on_cuda_takes_kernel_b_where_it_can(gen, cuda, dtype, want_v2):
    args = _smpl_args(f"--compute_dtype={dtype}", "--use_fused_mlp=-1")
    models, encoders = factory.build_models_and_params(args, seed=3, device=cuda)
    pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
    before = fused_mlp_v2.launches
    with torch.no_grad():
        out = pipe({k: torch.from_numpy(v).to(cuda) for k, v in _smpl_batch(gen, 64).items()})
    assert fused_mlp_v2.launches - before == want_v2
    assert torch.isfinite(out["rgb_fine"]).all()


def test_explicit_fused_v2_on_cuda_refuses_a_float32_net_when_built(cuda):
    args = _smpl_args("--compute_dtype=float32", "--use_fused_mlp=2")
    models, encoders = factory.build_models_and_params(args, seed=3, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        build_pipeline(RenderConfig.from_args(args), models, encoders)


def test_smpl_nerf_kernel_path_on_cuda_matches_plain_versions_on_cpu(gen, cuda):
    args = _smpl_args("--compute_dtype=bfloat16", "--use_fused_mlp=2")
    batch = _smpl_batch(gen, 300)
    outs = {}
    for device in ("cpu", cuda):
        models, encoders = factory.build_models_and_params(args, seed=3, device=device)
        pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
        a, b = sample_pdf_cuda.launches, fused_mlp_v2.launches
        with torch.no_grad():
            out = pipe({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        launched = (sample_pdf_cuda.launches - a, fused_mlp_v2.launches - b)
        assert launched == ((1, 2) if device == cuda else (0, 0))
        outs[str(device)] = {k: v.float().cpu().numpy() for k, v in out.items()}
    for key in ("rgb_coarse", "rgb_fine"):
        err = np.abs(outs["cuda"][key] - outs["cpu"][key])
        assert np.isfinite(outs["cuda"][key]).all()
        assert err.max() < 5e-2 and err.mean() < 5e-3, key


# ------------------------------------------------------------------ kernel D

@pytest.mark.parametrize("n_layers,width,pos_f,dir_f,add,skips,use_dir,rows", [
    (8, 256, 10, 4, 621, (4,), True, 1000),    # the configs/config.txt nets
    (8, 256, 10, 4, 0, (4,), True, 1000),
    (3, 64, 4, 2, 18, (0, 2), False, 1000),
    (2, 32, 1, 1, 5, (), True, 1000),
    (8, 256, 10, 4, 621, (4,), True, 1),       # ragged rows: one row, and either side of a tile
    (8, 256, 10, 4, 621, (4,), True, 127),
    (3, 256, 10, 4, 621, (1,), True, 129),
    (8, 256, 10, 4, 621, (4,), True, 131072 + 17),   # 1025 tiles: the persistent grid's tail
    (3, 256, 10, 4, 622, (1,), True, 300),     # a prefix wider than the old kernel's limit
    (3, 256, 10, 4, 1200, (0, 1), True, 300),
    (3, 32, 10, 4, 621, (1,), True, 300),      # the narrowest width at the flagship prefix
    (2, 160, 10, 12, 40, (0,), True, 20000),   # padded to 256; 157 tiles; 72 dir columns
    (4, 96, 4, 2, 7, (2,), True, 5000),        # padded to 128
    (8, 256, 10, 4, 621, (4,), True, 711 * 128),   # a culled fine pass: 711 rays of 64+64
    # append_vertex_locations_to_nerf: a 64-wide vertex embedding, in_dim 148
    # (a 124-column prefix+pos block: two A chunks, the second 60 wide)
    (8, 256, 10, 4, 64, (4,), True, 1000),
    (8, 256, 10, 4, 64, (4,), True, 129),
    (8, 256, 10, 4, 64, (4,), True, 2048 * 64 + 17),
])
def test_fused_v1_kernel_matches_plain(gen, cuda, n_layers, width, pos_f, dir_f, add, skips,
                                       use_dir, rows):
    net = _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed=width + add, add=add)
    spec = fused_mlp.spec_from_model(net)
    x = torch.from_numpy(gen.uniform(-1, 1, (rows, spec.in_dim)).astype(np.float32)).to(cuda)
    before = fused_mlp.launches
    got = fused_mlp.fused_apply(spec, net, x)
    want = fused_mlp.reference_forward(spec, fused_mlp.flatten_params(spec, net), x)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())


def test_fused_v1_wrapper_refuses_what_the_kernel_does_not_take(gen, cuda):
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=1, add=7)
    spec = fused_mlp.spec_from_model(net)
    x = torch.zeros(100, spec.in_dim, device=cuda)
    with pytest.raises(ValueError):
        fused_mlp.fused_apply(spec, net, x.double())
    with pytest.raises(ValueError):
        fused_mlp.fused_apply(spec, net, x[:, :-1].contiguous())
    with pytest.raises(ValueError, match="width"):
        narrow = RenderRayNet(width=48, compute_dtype=torch.bfloat16).to(cuda)
        fused_mlp.fused_apply(fused_mlp.spec_from_model(narrow), narrow,
                              torch.zeros(4, 84, device=cuda))


@pytest.mark.parametrize("width", [32, 96, 128, 160, 256])
def test_fused_v1_launches_with_the_shared_memory_the_wrapper_states(cuda, width):
    spec = fused_mlp.MlpSpec(width=width, additional_input_dim=621)
    assert fused_mlp._lib().fused_mlp_fwd_shared_bytes(width) == fused_mlp.shared_bytes(spec)


def test_mode1_gradient_on_cuda_is_the_plain_versions(gen, cuda):
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=2, add=18).requires_grad_(True)
    spec = fused_mlp.spec_from_model(net)
    x = torch.from_numpy(gen.uniform(-1, 1, (300, spec.in_dim)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(gen.randn(300, 4).astype(np.float32)).to(cuda)
    xk = x.clone().requires_grad_(True)
    before = fused_mlp.launches
    (fused_mlp.fused_apply(spec, net, xk) * g).sum().backward()
    assert fused_mlp.launches == before + 1
    got = [xk.grad] + [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    xp = x.clone().requires_grad_(True)
    (fused_mlp.reference_forward(spec, fused_mlp.flatten_params(spec, net), xp) * g).sum().backward()
    want = [xp.grad] + [p.grad for p in net.parameters()]
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


# ------------------------------------------------------------------ kernel C

def _check_backward(dflat, dx, want_flat, want_dx, exact_dx=None):
    """Kernel C's gradients against the plain version's. Given `exact_dx`
    (`fused_mlp_v2.exact_backward_dx`), dX's max bound is held against that
    float64 gradient instead: the plain version rounds the cotangents to bf16
    as well, and through the encoding one such rounding can put one of its
    rows further from the gradient than the bound (in the 711 x 192-row case,
    on a row where the kernel is close to it)."""
    assert all(torch.isfinite(t).all() for t in (dx, *dflat))
    err = (dx - want_dx).abs()
    max_err = err if exact_dx is None else (dx.double() - exact_dx).abs()
    assert float(max_err.max()) <= BWD_DX_MAX * float(want_dx.abs().max())
    assert float(err.mean()) <= BWD_DX_MEAN * float(want_dx.abs().mean())
    for i, (a, b) in enumerate(zip(dflat, want_flat)):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= BWD_DW_REL * float(b.norm()) + 1e-12, i


@pytest.mark.parametrize("n_layers,width,pos_f,dir_f,skips,use_dir,n", [
    (8, 256, 10, 4, (4,), True, 1000),     # the arm_angles.txt nets; a ragged last tile
    (8, 256, 10, 4, (4,), True, 20000),    # more tiles than blocks: the persistent loop
    (3, 64, 4, 2, (0, 2), False, 1000),
    (2, 32, 1, 1, (), True, 70),
])
def test_fused_v2_backward_kernel_matches_plain(gen, cuda, n_layers, width, pos_f, dir_f, skips,
                                                use_dir, n):
    net = _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed=width)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, n, cuda)
    g = torch.from_numpy(gen.randn(n, 4).astype(np.float32)).to(cuda) / n
    before = fused_mlp_v2.launches_bwd
    dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    want_flat, want_dx = fused_mlp_v2.reference_backward_raw(
        spec, fused_mlp.flatten_params(spec, net), x, g)
    torch.cuda.synchronize()
    assert fused_mlp_v2.launches_bwd == before + 1
    _check_backward(dflat, dx, want_flat, want_dx)
    if not use_dir:      # no directional input: no gradient reaches the direction
        assert float(dx[:, 3:].abs().max()) == 0.0


def test_fused_v2_autograd_function_end_to_end(gen, cuda):
    """Forward B and backward C inside one autograd Function, against autograd
    through the plain version, with a loss downstream and rows that need dX."""
    net = _net(cuda, 4, 128, 6, 3, (2,), True, seed=9).requires_grad_(True)
    spec = fused_mlp.spec_from_model(net)
    base = _rows(gen, 2000, cuda)
    target = torch.from_numpy(gen.randn(2000, 4).astype(np.float32)).to(cuda)

    def grads(apply):
        net.zero_grad()
        x = base.clone().requires_grad_(True)
        loss = ((apply(x * 1.0) - target) ** 2).mean()     # x * 1.0: a non-leaf input
        loss.backward()
        return float(loss.detach()), x.grad, [p.grad.clone() for p in net.parameters()]

    b0, c0 = fused_mlp_v2.launches, fused_mlp_v2.launches_bwd
    loss_k, dx_k, dp_k = grads(lambda x: fused_mlp_v2.fused_apply_raw(spec, net, x))
    assert (fused_mlp_v2.launches - b0, fused_mlp_v2.launches_bwd - c0) == (1, 1)
    loss_p, dx_p, dp_p = grads(lambda x: fused_mlp_v2.reference_forward_raw(
        spec, fused_mlp.flatten_params(spec, net), x))
    assert abs(loss_k - loss_p) <= 1e-3 * abs(loss_p)
    # parameter grads are [out, in] (weight) and [out]; the kernel's are transposed back
    _check_backward(dp_k, dx_k, dp_p, dx_p)
    with torch.no_grad():                                   # no graph: B only
        fused_mlp_v2.fused_apply_raw(spec, net, base)
    assert (fused_mlp_v2.launches - b0, fused_mlp_v2.launches_bwd - c0) == (2, 1)


def test_fused_v2_backward_is_bit_identical_from_run_to_run(gen, cuda):
    """No atomics: every sum of kernel C has one fixed order."""
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=4)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, 30000, cuda)
    g = torch.from_numpy(gen.randn(30000, 4).astype(np.float32)).to(cuda)
    a_flat, a_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    b_flat, b_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    assert torch.equal(a_dx, b_dx)
    for a, b in zip(a_flat, b_flat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_layers,width,pos_f,dir_f,skips,use_dir,rows", [
    (8, 256, 10, 4, (4,), True, 1),            # ragged rows: one row, either side of a tile
    (8, 256, 10, 4, (4,), True, 127),
    (3, 256, 10, 4, (1,), True, 129),
    (8, 256, 10, 4, (4,), True, 131072 + 17),  # 1025 tiles: the persistent grid's tail
    (2, 32, 10, 4, (0,), True, 5000),          # the narrowest width at the flagship encodings
    (4, 96, 4, 2, (2,), True, 5000),           # padded to 128
    (2, 160, 10, 12, (0,), False, 20000),      # padded to 256, no directional input
    (2, 64, 12, 4, (0,), True, 700),           # a positional block of two 64-column chunks
    (8, 256, 10, 4, (4,), True, 711 * 192),    # a culled fine pass: 711 rays of 64+128
])
def test_fused_v2_kernels_on_ragged_and_persistent_shapes(gen, cuda, n_layers, width, pos_f,
                                                          dir_f, skips, use_dir, rows):
    """Kernels B and C against their plain versions where the grid, the tiles
    and the padded widths have edges; dX's largest error against the float64
    gradient (`_check_backward`)."""
    net = _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed=width + rows)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    x = _rows(gen, rows, cuda)
    g = torch.from_numpy(gen.randn(rows, 4).astype(np.float32)).to(cuda) / rows
    b0, c0 = fused_mlp_v2.launches, fused_mlp_v2.launches_bwd
    with torch.no_grad():
        got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
        want = fused_mlp_v2.reference_forward_raw(spec, flat, x)
    dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
    torch.cuda.synchronize()
    assert (fused_mlp_v2.launches - b0, fused_mlp_v2.launches_bwd - c0) == (1, 1)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())
    _check_backward(dflat, dx, want_flat, want_dx,
                    fused_mlp_v2.exact_backward_dx(spec, flat, x, g))
    if not use_dir:
        assert float(dx[:, 3:].abs().max()) == 0.0


def test_fused_v2_forward_at_a_culled_budget(gen, cuda):
    """Kernel B on a culled coarse pass of the arm_angles.txt nets: 711 rays
    (an auto-cap budget of a 2048-ray batch) of 64 samples, rows that fill no
    whole number of 128-row tiles (the fine pass's 711 x 192 rows are a case
    of the ragged-shape test, backward included)."""
    rows = 711 * 64
    net = _net(cuda, 8, 256, 10, 4, (4,), True, seed=rows)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, rows, cuda)
    before = fused_mlp_v2.launches
    with torch.no_grad():
        got = fused_mlp_v2.fused_apply_raw(spec, net, x)
    want = fused_mlp_v2.reference_forward_raw(spec, fused_mlp.flatten_params(spec, net), x)
    torch.cuda.synchronize()
    assert fused_mlp_v2.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())


def _prefixed_rows(gen, n, add, cuda):
    prefix = torch.from_numpy(gen.uniform(-1, 1, (n, add)).astype(np.float32)).to(cuda)
    return torch.cat([prefix, _rows(gen, n, cuda)], -1).contiguous()


@pytest.mark.parametrize("n_layers,width,add,skips,rows", [
    (8, 256, 621, (4,), 1000),          # append_smpl_params under configs/config.txt
    (8, 256, 621, (4,), 711 * 64 + 5),  # ragged rows past a culled budget's
    (8, 256, 64, (4,), 2000),           # append_vertex_locations_to_nerf's embedding
    (8, 256, 18, (4,), 2000),           # append_to_nerf's two encoded joints
    (3, 64, 45, (0, 1), 700),           # chunk 0 holds 45 prefix and 19 encoded columns
    (2, 96, 130, (0,), 300),            # two whole prefix chunks, padded to 128
])
def test_fused_v2_kernels_take_prefix_rows(gen, cuda, n_layers, width, add, skips, rows):
    """Kernels B and C on raw rows [prefix | xyz | dir] against their plain
    versions; dX's largest error against the float64 gradient, on the prefix
    columns and on the xyz/dir columns apart; C twice, bit for bit."""
    net = _net(cuda, n_layers, width, 10, 4, skips, True, seed=width + add, add=add)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    x = _prefixed_rows(gen, rows, add, cuda)
    g = torch.from_numpy(gen.randn(rows, 4).astype(np.float32)).to(cuda) / rows
    b0, c0 = fused_mlp_v2.launches, fused_mlp_v2.launches_bwd
    with torch.no_grad():
        got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
        want = fused_mlp_v2.reference_forward_raw(spec, flat, x)
    dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    again_flat, again_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
    exact = fused_mlp_v2.exact_backward_dx(spec, flat, x, g)
    torch.cuda.synchronize()
    assert (fused_mlp_v2.launches - b0, fused_mlp_v2.launches_bwd - c0) == (1, 2)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())
    assert dx.shape == (rows, add + 6)
    _check_backward(dflat, dx, want_flat, want_dx, exact)
    for cols in (slice(0, add), slice(add, add + 6)):
        _check_backward([], dx[:, cols], [], want_dx[:, cols], exact[:, cols])
    assert torch.equal(dx, again_dx) and all(torch.equal(a, b)
                                             for a, b in zip(dflat, again_flat))


def test_fused_v2_prefix_gradient_reaches_an_embedding(gen, cuda):
    """Forward B and backward C inside the autograd Function with a prefix
    that a trainable embedding makes (append_vertex_locations_to_nerf's
    shape: 64 wide, one row per ray, repeated over its samples): the
    embedding's gradient, through C's prefix columns, against autograd
    through the plain version."""
    net = _net(cuda, 4, 128, 6, 3, (2,), True, seed=10, add=64).requires_grad_(True)
    spec = fused_mlp.spec_from_model(net)
    rays, samples = 40, 50
    embed = torch.from_numpy(gen.randn(rays, 64).astype(np.float32) * 0.5).to(cuda)
    base = _rows(gen, rays * samples, cuda)
    target = torch.from_numpy(gen.randn(rays * samples, 4).astype(np.float32)).to(cuda)

    def grads(apply):
        net.zero_grad()
        e = embed.clone().requires_grad_(True)
        rows = torch.cat([e[:, None, :].expand(rays, samples, 64).reshape(-1, 64), base], -1)
        loss = ((apply(rows) - target) ** 2).mean()
        loss.backward()
        return e.grad, [p.grad.clone() for p in net.parameters()]

    c0 = fused_mlp_v2.launches_bwd
    de_k, dp_k = grads(lambda x: fused_mlp_v2.fused_apply_raw(spec, net, x))
    assert fused_mlp_v2.launches_bwd - c0 == 1
    de_p, dp_p = grads(lambda x: fused_mlp_v2.reference_forward_raw(
        spec, fused_mlp.flatten_params(spec, net), x))
    assert float(de_p.abs().max()) > 0
    # a sum over 50 samples of each ray's prefix cotangent: held like dW
    assert float((de_k - de_p).norm()) <= BWD_DW_REL * float(de_p.norm())
    for a, b in zip(dp_k, dp_p):
        assert float((a - b).norm()) <= BWD_DW_REL * float(b.norm()) + 1e-12


def test_fused_v2_kernels_take_no_rows(cuda):
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=5)
    spec = fused_mlp.spec_from_model(net)
    x = torch.zeros(0, 6, device=cuda)
    b0, c0 = fused_mlp_v2.launches, fused_mlp_v2.launches_bwd
    assert fused_mlp_v2.fused_forward_cuda(spec, net, x).shape == (0, 4)
    dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, torch.zeros(0, 4, device=cuda))
    assert dx.shape == (0, 6)
    for t, p in zip(dflat, fused_mlp.flatten_params(spec, net)):
        assert t.shape == p.shape and not t.any()
    assert (fused_mlp_v2.launches, fused_mlp_v2.launches_bwd) == (b0, c0)


@pytest.mark.parametrize("width", [32, 96, 128, 160, 256])
def test_fused_v2_launches_with_the_shared_memory_the_wrapper_states(cuda, width):
    spec = fused_mlp.MlpSpec(width=width)
    assert fused_mlp_v2._lib().fused_mlp_v2_fwd_shared_bytes(width) == \
        fused_mlp_v2.shared_bytes(spec)
    assert fused_mlp_v2._lib_bwd().fused_mlp_v2_bwd_shared_bytes(width) == \
        fused_mlp_v2.shared_bytes(spec, backward=True)


def test_weight_pack_follows_an_optimizer_step_on_cuda(gen, cuda):
    """torch.optim updates the weights in place; the pack must be rebuilt, or
    the kernels would go on computing with the weights of step 0."""
    args = _smpl_args("--compute_dtype=bfloat16", "--use_fused_mlp=2", "--lrate=1e-2")
    models, encoders = factory.build_models_and_params(args, seed=3, device=cuda)
    pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
    sol = solver.Solver(pipe, args)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _smpl_batch(gen, 256).items()}
    batch["rgb"] = torch.rand(256, 3, device=cuda)
    net = models["model_coarse"]
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, 500, cuda)
    counts = (sample_pdf_cuda.launches, fused_mlp_v2.launches, fused_mlp_v2.launches_bwd)
    first = float(sol.train_step(batch, None)["loss"])
    assert (sample_pdf_cuda.launches - counts[0], fused_mlp_v2.launches - counts[1],
            fused_mlp_v2.launches_bwd - counts[2]) == (1, 2, 2)
    for _ in range(10):
        last = float(sol.train_step(batch, None)["loss"])
    assert np.isfinite(last) and last < first
    with torch.no_grad():
        got = fused_mlp_v2.fused_apply_raw(spec, net, x)
        want = fused_mlp_v2.reference_forward_raw(spec, fused_mlp.flatten_params(spec, net), x)
    assert float((got - want).abs().max()) <= MLP_REL * float(want.abs().max())
    for p in models["model_warp_field"].parameters():       # dX reached the warp field
        assert p.grad is not None and float(p.grad.abs().max()) > 0.0


# ------------------------------------------------------- the append pipelines

def _append_args(model_type, *extra):
    return config.config_parser().parse_args([
        "--config=/dev/null", f"--model_type={model_type}", "--human_pose_encoding=1",
        "--netdepth=3", "--netwidth=64", "--skips=1", "--netdepth_fine=3",
        "--netwidth_fine=64", "--skips_fine=1", "--number_coarse_samples=16",
        "--number_fine_samples=32", "--number_frequencies_postitional=6",
        "--number_frequencies_directional=2", "--number_frequencies_pose=4",
        "--use_identity_pose=1", "--sigma_noise_std=0", "--white_background=1",
        "--use_pallas=1", "--compute_dtype=bfloat16", *extra])


@pytest.mark.parametrize("model_type", ["append_to_nerf", "append_smpl_params"])
def test_append_kernel_path_on_cuda_matches_plain_versions_on_cpu(gen, cuda, model_type):
    args = _append_args(model_type, "--use_fused_mlp=1")
    batch = _smpl_batch(gen, 300)
    outs = {}
    for device in ("cpu", cuda):
        models, encoders = factory.build_models_and_params(args, seed=3, device=device)
        pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
        a, d = sample_pdf_cuda.launches, fused_mlp.launches
        with torch.no_grad():
            out = pipe({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        launched = (sample_pdf_cuda.launches - a, fused_mlp.launches - d)
        assert launched == ((1, 2) if device == cuda else (0, 0))
        outs[str(device)] = {k: v.float().cpu().numpy() for k, v in out.items()}
    for key in ("rgb_coarse", "rgb_fine"):
        err = np.abs(outs["cuda"][key] - outs["cpu"][key])
        assert np.isfinite(outs["cuda"][key]).all()
        assert err.max() < 5e-2 and err.mean() < 5e-3, key


@pytest.mark.parametrize("model_type,mode,kernel", [("smpl_nerf", 2, "fused_mlp_v2"),
                                                    ("append_smpl_params", 1, "fused_mlp")])
def test_culled_renderers_on_cuda_launch_the_kernels_at_an_odd_budget(gen, cuda, model_type,
                                                                      mode, kernel):
    """Both culled renderers send K = int(300 * 0.37) = 111 rays (K*16 and K*48
    rows) through kernels A and B or D. With a given grid (a dilated sphere:
    scores 10 or 0) the selected rays are the same on both devices, the rest
    of the budget taken from the tied zeros by index, and the render is held
    against the plain versions on the CPU; at cap 1 the fast renderer is the
    full pipeline on the same kernels, its rows reordered."""
    args = (_smpl_args(f"--use_fused_mlp={mode}", "--white_background=1",
                       "--compute_dtype=bfloat16") if model_type == "smpl_nerf"
            else _append_args(model_type, f"--use_fused_mlp={mode}"))
    batch = _smpl_batch(gen, 300)
    batch["human_pose"][:] = batch["human_pose"][:1]
    centre = torch.tensor([1.0, 0.0, 0.0])      # about 100 of the 300 rays hit it
    grid = occupancy.build_density_grid(
        lambda p: ((p - centre).norm(dim=-1) < 0.3).float() * 10.0, occupancy.DEFAULT_AABB, 16)
    module = {"fused_mlp_v2": fused_mlp_v2, "fused_mlp": fused_mlp}[kernel]
    outs = {}
    for device in ("cpu", cuda):
        models, encoders = factory.build_models_and_params(args, seed=3, device=device)
        pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        occ = fast.make_occupancy_renderer(pipe, 0.37, grid_resolution=16,
                                           warn_saturation=False)
        a, n = sample_pdf_cuda.launches, module.launches
        outs[str(device)] = occ(tb, grid.to(device)).float().cpu().numpy()
        launched = (sample_pdf_cuda.launches - a, module.launches - n)
        assert launched == ((1, 2) if device == cuda else (0, 0))
    err = np.abs(outs["cuda"] - outs["cpu"])
    assert np.isfinite(outs["cuda"]).all()
    assert err.max() < 5e-2 and err.mean() < 5e-3
    a, n = sample_pdf_cuda.launches, module.launches
    assert torch.isfinite(fast.make_fast_renderer(pipe, 0.37)(tb)).all()
    assert (sample_pdf_cuda.launches - a, module.launches - n) == (1, 2)
    with torch.no_grad():
        full = pipe(tb)["rgb_fine"]
    assert float((fast.make_fast_renderer(pipe, 1.0)(tb) - full).abs().max()) <= 1e-4


def _append_pipelines(cuda, model_type, *modes):
    """Pipelines of one set of seeded append nets on the card, one a mode."""
    args = _append_args(model_type, f"--use_fused_mlp={modes[0]}")
    models, encoders = factory.build_models_and_params(args, seed=3, device=cuda)
    return [build_pipeline(RenderConfig.from_args(_append_args(model_type,
                                                               f"--use_fused_mlp={m}")),
                           models, encoders) for m in modes]


def test_auto_fused_mode_on_cuda_keeps_prefixed_nets_on_the_plain_net(gen, cuda):
    """Under autograd (training) auto keeps the prefixed nets on the plain
    net, as JAX's resolver does: neither D nor B, and what --use_fused_mlp=0
    renders. An explicit --use_fused_mlp=2 takes them to kernel B, never D."""
    auto, plain, v2 = _append_pipelines(cuda, "append_smpl_params", -1, 0, 2)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _smpl_batch(gen, 64).items()}
    before = (fused_mlp.launches, fused_mlp_v2.launches)
    out = auto(batch)["rgb_fine"]
    assert out.requires_grad
    assert (fused_mlp.launches, fused_mlp_v2.launches) == before
    with torch.no_grad():
        assert torch.equal(out.detach(), plain(batch)["rgb_fine"])
        out = v2(batch)["rgb_fine"]
    assert (fused_mlp.launches - before[0], fused_mlp_v2.launches - before[1]) == (0, 2)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("model_type", ["append_to_nerf", "append_smpl_params"])
@pytest.mark.parametrize("no_grad", [torch.no_grad, torch.inference_mode])
def test_auto_fused_mode_on_cuda_sends_prefixed_no_grad_passes_to_kernel_d(gen, cuda,
                                                                           model_type, no_grad):
    """Without autograd auto sends each prefixed net to kernel D (two launches,
    no B) and renders what --use_fused_mlp=1 renders, bit for bit."""
    auto, fused1 = _append_pipelines(cuda, model_type, -1, 1)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in _smpl_batch(gen, 300).items()}
    before = (fused_mlp.launches, fused_mlp_v2.launches)
    with no_grad():
        out = auto(batch)
        launched = (fused_mlp.launches - before[0], fused_mlp_v2.launches - before[1])
        want = fused1(batch)
    assert launched == (2, 0)
    for key in ("rgb_coarse", "rgb_fine"):
        assert torch.isfinite(out[key]).all()
        assert torch.equal(out[key], want[key]), key


def test_sample_pdf_kernel_under_grad_with_detached_inputs(gen, cuda):
    z = torch.linspace(1, 4, 16, device=cuda).repeat(50, 1)
    weights = torch.rand(50, 16, device=cuda, requires_grad=True)
    dirs = torch.ones(50, 3, device=cuda, requires_grad=True)
    before = sample_pdf_cuda.launches
    with torch.enable_grad():
        z_all, samples = sampling.fine_sampling(torch.zeros(50, 3, device=cuda), dirs, z,
                                                weights * 2.0, 32, True)
        samples.sum().backward()
    assert sample_pdf_cuda.launches == before + 1
    assert not z_all.requires_grad and weights.grad is None
    assert torch.allclose(dirs.grad, z_all.sum(-1, keepdim=True).expand(50, 3))


# ------------------------------------------------------------------- kernel E

def _expert_field(gen, cuda, grid, hidden, l_pos, l_dir):
    E, D = grid ** 3, ex.encoded_dim(l_pos, l_dir)
    ws = (gen.randn(E, D, hidden) * 0.3, gen.randn(E, hidden) * 0.1,
          gen.randn(E, hidden, 4) * 0.3, gen.randn(E, 4) * 0.1)
    experts = ep.ExpertMLP(*(torch.tensor(w.astype(np.float32), device=cuda) for w in ws))
    return ex.ExpertField(experts, torch.tensor([-1.0, -0.9, -1.1], device=cuda),
                          torch.tensor([1.0, 1.1, 0.9], device=cuda), grid, l_pos, l_dir)


def _expert_points(gen, n, cuda, span=1.2):
    pos = torch.tensor(gen.uniform(-span, span, (n, 3)).astype(np.float32), device=cuda)
    d = gen.randn(n, 3).astype(np.float32)
    return pos, torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), device=cuda)


@pytest.mark.parametrize("tile,budget,hidden,l_pos,l_dir", [
    (256, 8192, 32, 4, 2),      # the serving shape: D=42, H=32, tile 256
    (8, 2048, 16, 3, 1),        # the JAX tests' small tiles
    (32, 4096, 16, 3, 1),
    (64, 4096, 40, 4, 2),       # H not a multiple of 32: two hidden chunks
    (512, 16384, 32, 10, 4),    # several 128-row blocks per tile, D=90
])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_expert_tiles_kernel_matches_plain(gen, cuda, tile, budget, hidden, l_pos, l_dir, dtype):
    field = _expert_field(gen, cuda, 3, hidden, l_pos, l_dir)
    pos, dirs = _expert_points(gen, 3000, cuda)
    ids, n_route = ex._route(field, pos)
    plan = ep.sorted_tile_plan(ids, n_route, budget, tile)
    assert not bool(plan.overflow.any()) and not bool(plan.valid[-tile:].any())
    args = (field.experts, ex._local_coords(field, pos[plan.tok]).contiguous(),
            dirs[plan.tok].contiguous(), plan.valid, plan.tile_expert)
    kw = dict(l_pos=l_pos, l_dir=l_dir, tile=tile, compute_dtype=dtype)
    before = expert_tiles.launches
    got = expert_tiles.expert_tiles_forward(*args, **kw)
    want = expert_tiles.expert_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert expert_tiles.launches == before + 1
    assert bool(torch.isfinite(got).all()) and float(got[~plan.valid].abs().max()) == 0.0
    err = float((got - want).abs().max())
    if dtype is None:
        assert err <= 2e-5 * max(1.0, float(want.abs().max()))
        tiled = ep.tiles_apply(field.experts, ex._encode(field, pos[plan.tok], dirs[plan.tok]),
                               plan)
        assert float((got - tiled).abs().max()) <= 1e-4 * max(1.0, float(tiled.abs().max()))
    else:
        assert err <= 5e-2


@pytest.mark.parametrize("l_pos,l_dir,H,O,E,tile,all_invalid", [
    (4, 2, 32, 4, 27, 32, False),     # D=42
    (3, 1, 16, 4, 27, 8, False),      # D=30, tile 8: half an m-tile
    (4, 2, 20, 4, 27, 64, False),     # H padded to 32
    (3, 1, 16, 3, 27, 32, False),     # O=3: scalar stores
    (4, 2, 32, 4, 1, 24, False),      # E=1, tile 24: a ragged m-tile
    (3, 1, 16, 4, 27, 32, True),      # every slot invalid
])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_expert_tiles_kernel_matches_plain_at_the_emulated_shapes(gen, cuda, l_pos, l_dir, H,
                                                                  O, E, tile, all_invalid,
                                                                  dtype):
    """The shapes of the kernel's CPU emulation (tests/test_torch_port_ae_hopper.py)."""
    D = expert_tiles.encoded_dim(l_pos, l_dir)
    experts = ep.ExpertMLP(*(torch.tensor(w.astype(np.float32), device=cuda) for w in (
        gen.randn(E, D, H) * 0.3, gen.randn(E, H) * 0.1, gen.randn(E, H, O) * 0.3,
        gen.randn(E, O) * 0.1)))
    budget = 64 * tile
    ids = torch.as_tensor(gen.randint(0, E + 1, budget // 4), device=cuda)
    plan = ep.sorted_tile_plan(ids, E, budget, tile)
    valid = torch.zeros_like(plan.valid) if all_invalid else plan.valid
    local = torch.tensor(gen.uniform(0, 1, (budget, 3)).astype(np.float32), device=cuda)
    d = gen.randn(budget, 3).astype(np.float32)
    dirs = torch.tensor(d / np.linalg.norm(d, axis=-1, keepdims=True), device=cuda)
    kw = dict(l_pos=l_pos, l_dir=l_dir, tile=tile, compute_dtype=dtype)
    args = (experts, local, dirs, valid, plan.tile_expert)
    got = expert_tiles.expert_tiles_forward(*args, **kw)
    want = expert_tiles.expert_tiles_reference(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all()) and bool((got[~valid] == 0).all())
    err = float((got - want).abs().max())
    assert err <= (2e-5 * max(1.0, float(want.abs().max())) if dtype is None else 5e-2)


def test_expert_tiles_kernel_reads_no_expert_outside_the_table(gen, cuda):
    field = _expert_field(gen, cuda, 2, 32, 4, 2)
    L, tile = 1024, 256
    local = torch.rand(L, 3, device=cuda)
    valid = torch.ones(L, dtype=torch.bool, device=cuda)
    valid[512:] = False
    tile_expert = torch.tensor([0, 7, 99, -3], dtype=torch.int32, device=cuda)   # clamped
    got = expert_tiles.expert_tiles_forward(field.experts, local, local, valid, tile_expert,
                                            l_pos=4, l_dir=2, tile=tile)
    want = expert_tiles.expert_tiles_reference(field.experts, local, local, valid,
                                               tile_expert.clamp(0, 7), l_pos=4, l_dir=2,
                                               tile=tile)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert float(got[512:].abs().max()) == 0.0


def test_expert_tiles_wrapper_checks_its_inputs_and_refuses_a_gradient(gen, cuda):
    field = _expert_field(gen, cuda, 2, 16, 3, 1)
    local = torch.rand(64, 3, device=cuda)
    valid = torch.ones(64, dtype=torch.bool, device=cuda)
    te = torch.zeros(2, dtype=torch.int32, device=cuda)
    kw = dict(l_pos=3, l_dir=1, tile=32)
    expert_tiles.expert_tiles_forward(field.experts, local, local, valid, te, **kw)
    with pytest.raises(ValueError, match="multiple of tile"):
        expert_tiles.expert_tiles_forward(field.experts, local[:60], local[:60], valid[:60], te,
                                          **kw)
    with pytest.raises(ValueError, match="tile_expert"):
        expert_tiles.expert_tiles_forward(field.experts, local, local, valid, te.long(), **kw)
    with pytest.raises(ValueError, match="local"):
        expert_tiles.expert_tiles_forward(field.experts, local.double(), local, valid, te, **kw)
    with pytest.raises(ValueError, match="encoding"):
        expert_tiles.expert_tiles_forward(field.experts, local, local, valid, te, l_pos=4,
                                          l_dir=1, tile=32)
    with pytest.raises(ValueError, match="w0"):
        expert_tiles.expert_tiles_forward(ep.ExpertMLP(*(w.cpu() for w in field.experts)), local,
                                          local, valid, te, **kw)
    trainable = ep.ExpertMLP(*(w.clone().requires_grad_(True) for w in field.experts))
    with pytest.raises(RuntimeError, match="forward-only"):
        expert_tiles.expert_tiles_forward(trainable, local, local, valid, te, **kw)
    with torch.no_grad():
        expert_tiles.expert_tiles_forward(trainable, local, local, valid, te, **kw)


@pytest.mark.parametrize("form", ["tiled", "culled"])
def test_expert_serving_through_the_kernel_matches_the_tiled_path_on_cuda(gen, cuda, form):
    field = _expert_field(gen, cuda, 3, 32, 4, 2)
    occ = gen.uniform(size=27) < 0.5
    cfield = ex.compact_field(field, occ)
    R, S = 256, 48
    o = torch.zeros(R, 3, device=cuda)
    o[:, 2] = -2.0
    d = torch.tensor(gen.randn(R, 3).astype(np.float32) * 0.35, device=cuda)
    d[:, 2] += 1.0
    z = torch.linspace(0.5, 4.0, S, device=cuda).expand(R, S)
    render = (ex.render_rays_with_experts_tiled if form == "tiled"
              else ex.render_rays_with_experts_culled)
    before = expert_tiles.launches
    with torch.no_grad():
        got, over_k = render(cfield, o, d, z, 8192, 64, use_kernel=True)
        want, over_p = render(cfield, o, d, z, 8192, 64)
    assert expert_tiles.launches == before + 1 and int(over_k) == int(over_p) == 0
    assert float((got.rgb - want.rgb).abs().max()) <= 1e-4
    assert float(got.acc.max()) > 0.05


# ------------------------------------------------------------------- kernel F

@pytest.mark.parametrize("n,K,N", [
    (131072, 256, 256), (1000, 64, 128), (4096, 512, 512), (300, 1024, 1024), (1, 32, 128),
    (127, 256, 256), (129, 96, 384), (131072 + 17, 512, 512),   # ragged rows, a K tail of 32
    (40000, 32, 128),          # 313 tiles of 128 x 128: the persistent grid's tail
    (20000, 1024, 1024),       # 628 tiles of 128 x 256 over 132 SMs
])
def test_relu_matmul_kernel_matches_plain(gen, cuda, n, K, N):
    x = torch.tensor(gen.randn(n, K).astype(np.float32), device=cuda).to(torch.bfloat16)
    w = torch.tensor((0.05 * gen.randn(K, N)).astype(np.float32), device=cuda).to(torch.bfloat16)
    before = relu_matmul.launches
    got = relu_matmul.relu_matmul(x, w)
    want = relu_matmul.relu_matmul_reference(x, w)
    torch.cuda.synchronize()
    assert relu_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, N)
    err = (got.float() - want.float()).abs()
    assert float((err - 2.0 ** -7 * want.float().abs()).max()) <= 5e-5
    assert float(got.float().min()) == 0.0 and float(got.float().max()) > 0.0


def test_relu_matmul_wrapper_checks_its_inputs(cuda):
    x = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda)
    w = torch.zeros(64, 128, dtype=torch.bfloat16, device=cuda)
    relu_matmul.relu_matmul(x, w)
    with pytest.raises(TypeError):
        relu_matmul.relu_matmul(x.float(), w.float())
    with pytest.raises(ValueError, match="multiple of"):
        relu_matmul.relu_matmul(x, w[:, :96].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        relu_matmul.relu_matmul(x, w.t().contiguous().t())
    with pytest.raises(ValueError, match="one CUDA device"):
        relu_matmul.relu_matmul(x, w.cpu())
    with pytest.raises(ValueError, match="bad shapes"):
        relu_matmul.relu_matmul(x[:, :32].contiguous(), w)
    with pytest.raises(RuntimeError, match="forward-only"):
        relu_matmul.relu_matmul(x, w.clone().requires_grad_(True))


def test_finetune_on_cuda_resumes_from_its_checkpoint(gen, cuda, tmp_path, monkeypatch):
    """Weights, Adam moments and the CUDA generator's state come back from the
    checkpoint; gradients of gathered weights are summed with atomics, so the
    resumed run matches the whole one to float32 rounding, not bit for bit."""
    field = _expert_field(gen, cuda, 2, 8, 2, 1)
    o = np.zeros((256, 3), np.float32)
    o[:, 2] = -2.0
    d = gen.randn(256, 3).astype(np.float32) * 0.35 + np.float32([0, 0, 1])
    rgb = gen.uniform(0, 1, (256, 3)).astype(np.float32)
    kw = dict(near=0.5, far=4.0, n_samples=12, budget=2048, tile=8, batch=64, lr=2e-3, n_steps=6)

    def seeded():
        return torch.Generator(device=cuda).manual_seed(1)

    whole, whole_loss, over = ex.finetune_experts(field, o, d, rgb, seeded(), **kw)
    assert over == 0 and np.isfinite(whole_loss)
    part = str(tmp_path / "ft.part.npz")
    real_step, calls = ex.finetune_step, []

    def cutting_step(*a, **k):
        if len(calls) == 3:
            raise KeyboardInterrupt
        calls.append(1)
        return real_step(*a, **k)

    monkeypatch.setattr(ex, "finetune_step", cutting_step)
    with pytest.raises(KeyboardInterrupt):
        ex.finetune_experts(field, o, d, rgb, seeded(), checkpoint_path=part,
                            checkpoint_every=3, **kw)
    monkeypatch.setattr(ex, "finetune_step", real_step)
    resumed, resumed_loss, _ = ex.finetune_experts(
        field, o, d, rgb, torch.Generator(device=cuda).manual_seed(99), checkpoint_path=part,
        checkpoint_every=3, **kw)
    assert resumed_loss == pytest.approx(whole_loss, rel=1e-4)
    for a, b in zip(resumed.experts, whole.experts):
        assert float((a - b).abs().max()) <= 1e-5


# ------------------------------------------------- the SMPL-driven families

def _dynamic_setup(gen, model_type, *extra, device="cpu"):
    from smpl_nerf_tpu_torch.models import smpl
    args = config.config_parser().parse_args([
        "--config=/dev/null", f"--model_type={model_type}", "--netdepth=4", "--netwidth=128",
        "--skips=2", "--netdepth_fine=4", "--netwidth_fine=128", "--skips_fine=2",
        "--number_coarse_samples=16", "--number_fine_samples=16", "--run_fine=1",
        "--number_frequencies_postitional=6", "--number_frequencies_directional=3",
        "--warp_radius=0.1", "--warp_temperature=100", "--sigma_noise_std=0",
        "--white_background=1", "--compute_dtype=bfloat16", "--use_pallas=1",
        "--lrate=1e-3", *extra])
    human = smpl.procedural_human()
    poses = (0.25 * gen.randn(3, 69)).astype(np.float32)
    extras = {"smpl_model": human, "betas": np.zeros(10, np.float32), "num_images": 3,
              "goal_poses": poses, "num_vertices": human.num_vertices}
    models, encoders = factory.build_models_and_params(args, seed=3, device=device,
                                                       extras=extras)
    return args, build_pipeline(RenderConfig.from_args(args), models, encoders, extras), poses


def _dynamic_batch(gen, poses, n):
    from smpl_nerf_tpu_torch.models import smpl
    verts = smpl.smpl_forward(smpl.procedural_human(), np.zeros(10),
                              torch.from_numpy(poses)).numpy()
    img = gen.randint(0, len(poses), n).astype(np.int32)
    origins = np.tile(np.asarray([[0.0, 0.0, 2.4]], np.float32), (n, 1))
    dirs = verts[img, gen.randint(0, verts.shape[1], n)] - origins
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return {"ray_translation": origins, "ray_direction": dirs, "image_indices": img,
            "rgb": gen.uniform(0, 1, (n, 3)).astype(np.float32)}


def test_dummy_dynamic_kernels_b_and_c_take_per_sample_directions(gen, cuda):
    """Auto mode on the card runs the warped rows, whose directions differ per
    sample, through B and, in a training step, C; against the plain versions
    on the CPU: the render, the loss and every gradient."""
    batch = _dynamic_batch(gen, _dynamic_setup(gen, "dummy_dynamic")[2], 300)
    results = {}
    for device in ("cpu", cuda):
        args, pipe, _ = _dynamic_setup(np.random.RandomState(0), "dummy_dynamic",
                                       "--use_fused_mlp=-1", device=device)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        b0, c0 = fused_mlp_v2.launches, fused_mlp_v2.launches_bwd
        with torch.no_grad():
            out = pipe(tb)
        sol = solver.Solver(pipe, args)
        sol.optimizer.zero_grad()
        loss, _ = sol.loss_fn(tb, None, True)
        loss.backward()
        launched = (fused_mlp_v2.launches - b0, fused_mlp_v2.launches_bwd - c0)
        assert launched == ((2, 1) if device == cuda else (0, 0))
        assert float(out["warp"].abs().max()) > 1e-3                  # the warp bends rays
        grads = [p.grad.float().cpu() for p in pipe.models["model_coarse"].parameters()]
        results[str(device)] = (out["rgb_coarse"].float().cpu(), float(loss.detach()), grads)
    (rgb_c, loss_c, g_c), (rgb_k, loss_k, g_k) = results["cpu"], results["cuda"]
    err = (rgb_k - rgb_c).abs()
    assert torch.isfinite(rgb_k).all() and err.max() < 5e-2 and err.mean() < 5e-3
    assert abs(loss_k - loss_c) <= 2e-2 * loss_c
    for a, b in zip(g_k, g_c):
        assert float((a - b).norm()) <= BWD_DW_REL * float(b.norm()) + 1e-6


def test_dummy_dynamic_steps_on_the_skinned_table_match_per_step_lbs_on_cuda(gen, cuda):
    """Three dummy_dynamic training steps on the card with the skinned pose
    table, and the same steps with LBS in every step (a table that needs a
    gradient, which also sends the attention to the eager path): the same
    losses to bf16 rounding (the bound of the CPU comparison above); every
    step after the first looks the table up."""
    from smpl_nerf_tpu_torch import pipelines
    poses = _dynamic_setup(gen, "dummy_dynamic")[2]
    batches = [{k: torch.from_numpy(v).to(cuda) for k, v in _dynamic_batch(gen, poses, 300).items()}
               for _ in range(3)]
    losses, counts = {}, {}
    for per_step in (False, True):
        args, pipe, _ = _dynamic_setup(np.random.RandomState(0), "dummy_dynamic",
                                       "--use_fused_mlp=-1", device=cuda)
        pipe.models["smpl_estimator"].goal_poses.requires_grad_(per_step)
        sol = solver.Solver(pipe, args)
        b0, h0 = pipelines.goal_table_builds, pipelines.goal_table_hits
        losses[per_step] = [float(sol.train_step(b, None)["loss"]) for b in batches]
        counts[per_step] = (pipelines.goal_table_builds - b0, pipelines.goal_table_hits - h0)
    assert counts == {False: (1, 2), True: (0, 0)}
    for got, want in zip(losses[False], losses[True]):
        assert np.isfinite(got) and abs(got - want) <= 2e-2 * want


def test_append_vertices_kernel_path_on_cuda_matches_plain_versions_on_cpu(gen, cuda):
    """Kernels A and D (a 64-wide embedding prefix) on the card against the
    plain versions on the CPU."""
    batch = _dynamic_batch(gen, _dynamic_setup(gen, "append_vertex_locations_to_nerf")[2], 300)
    outs = {}
    for device in ("cpu", cuda):
        _, pipe, _ = _dynamic_setup(np.random.RandomState(0), "append_vertex_locations_to_nerf",
                                    "--use_fused_mlp=1", device=device)
        a, d = sample_pdf_cuda.launches, fused_mlp.launches
        with torch.no_grad():
            out = pipe({k: torch.from_numpy(v).to(device) for k, v in batch.items()})
        launched = (sample_pdf_cuda.launches - a, fused_mlp.launches - d)
        assert launched == ((1, 2) if device == cuda else (0, 0))
        outs[str(device)] = {k: v.float().cpu().numpy() for k, v in out.items()}
    for key in ("rgb_coarse", "rgb_fine"):
        err = np.abs(outs["cuda"][key] - outs["cpu"][key])
        assert np.isfinite(outs["cuda"][key]).all()
        assert err.max() < 5e-2 and err.mean() < 5e-3, key


def _variant_pipeline(net, device, seed=0):
    flag = ("--siren=1",) if net == "siren" else ("--grid_encoding=1",)
    args = config.config_parser().parse_args([
        "--config=/dev/null", "--model_type=nerf", "--netdepth=3", "--netwidth=64",
        "--netdepth_fine=3", "--netwidth_fine=64", "--run_fine=1",
        "--number_coarse_samples=32", "--number_fine_samples=32", "--near=1", "--far=4",
        "--sigma_noise_std=0", "--use_pallas=1", *flag])
    models, encoders = factory.build_models_and_params(args, seed=seed, device="cpu")
    with torch.no_grad():
        for m in models.values():
            for g in getattr(m, "grids", list)():
                g.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(seed))
    models = {k: m.to(device) for k, m in models.items()}
    return build_pipeline(RenderConfig.from_args(args), models, encoders), args


@pytest.mark.parametrize("net", ["siren", "grid"])
def test_siren_and_grid_runs_launch_kernel_a_and_match_the_cpu(gen, cuda, net):
    """Kernel A in the fine pass of a SIREN / grid pipeline on the card, the
    loss's gradients through the nets' own CUDA forward and backward (the grid
    gathers' backward sums with atomics), against the plain versions on the
    CPU. Kernel A can put a rare fine sample one bin from the plain
    version's, which moves that sample's share of the loss and of every
    gradient: the loss within 1e-2 relative, each gradient within BWD_DW_REL
    by relative norm."""
    R = 512
    dirs = gen.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    batch = {"ray_translation": np.tile(np.float32([[0, 0, 2.4]]), (R, 1)),
             "ray_direction": dirs, "rgb": gen.uniform(0, 1, (R, 3)).astype(np.float32)}
    results = {}
    for device in ("cpu", cuda):
        pipe, args = _variant_pipeline(net, device)
        tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        a = sample_pdf_cuda.launches
        sol = solver.Solver(pipe, args)
        loss, _ = sol.loss_fn(tb, None, False)
        loss.backward()
        assert sample_pdf_cuda.launches - a == (1 if device == cuda else 0)
        grads = {k: p.grad.cpu() for k, p in pipe.models["model_coarse"].named_parameters()}
        results[str(device)] = (float(loss.detach()), grads)
    (loss_c, g_c), (loss_k, g_k) = results["cpu"], results["cuda"]
    assert np.isfinite(loss_k) and abs(loss_k - loss_c) <= 1e-2 * loss_c
    for key, g in g_c.items():
        assert float((g_k[key] - g).norm()) <= BWD_DW_REL * float(g.norm()) + 1e-7, key


def test_grid_gather_backward_on_cuda_matches_the_cpu(gen, cuda):
    """trilinear_interpolate's scatter of gradients into a 64^3 grid: atomics
    on the card, so held by relative norm."""
    from smpl_nerf_tpu_torch.models.grid_nerf import trilinear_interpolate

    grid = torch.from_numpy(gen.uniform(-1, 1, (64, 64, 64, 4)).astype(np.float32))
    p = torch.from_numpy(gen.uniform(-0.1, 1.1, (262144, 3)).astype(np.float32))
    cot = torch.from_numpy(gen.randn(262144, 4).astype(np.float32))
    out = {}
    for device in ("cpu", cuda):
        g = grid.to(device).detach().requires_grad_(True)
        f = trilinear_interpolate(g, p.to(device))
        (f * cot.to(device)).sum().backward()
        out[str(device)] = (f.detach().cpu(), g.grad.cpu())
    (f_c, g_c), (f_k, g_k) = out["cpu"], out["cuda"]
    assert float((f_k - f_c).abs().max()) <= 1e-5
    assert float((g_k - g_c).norm()) <= 1e-5 * float(g_c.norm())


def test_hash_grid_field_and_step_on_cuda_match_the_cpu(gen, cuda):
    """Instant-NGP's published encoding (L 16, F 2, T 2^19, N 16-2048, 64-wide
    MLPs) on the card against the CPU, from one seed, in float32. The field
    alone, forward and backward on fixed rows under a fixed cotangent: the
    encoding's gathers are index_select, whose backward on the card accumulates
    with atomics (index_add_) in another order than the CPU's, so the raw
    outputs within HASH_RAW_REL and each gradient within HASH_GRAD_REL by
    relative norm. Then one smpl_nerf training step through the solver with no
    draws and the plain fine sampling on both: the loss within HASH_LOSS_REL;
    the gradients within BWD_DW_REL, as the grid run's above, since the plain
    sampling's cumsum also adds in another order on the card and can move a
    rare fine sample by a bin."""
    R = 256
    argv = ["--config=", "--model_type=smpl_nerf", "--run_fine=1",
            "--number_coarse_samples=64", "--number_fine_samples=128", "--use_pallas=0",
            "--use_fused_mlp=-1", "--compute_dtype=float32", "--sigma_noise_std=0",
            "--grid_encoding=2", "--grid_features=2", "--grid_width=64", f"--batchsize={R}",
            "--lrate=1e-2", "--seed=3"]
    args = config.config_parser().parse_args(argv)
    angle = gen.uniform(0, 2 * np.pi, R)
    origins = np.stack([2.4 * np.sin(angle), gen.normal(0, 0.2, R), 2.4 * np.cos(angle)], -1)
    poses = np.zeros((R, 69))
    poses[:, [38, 41]] = gen.uniform(0, 0.8, (R, 1))
    batch = {"ray_translation": origins, "ray_direction": gen.normal(0, 0.3, (R, 3)) - origins,
             "human_pose": poses, "rgb": gen.uniform(0, 1, (R, 3))}
    rows = np.concatenate([gen.uniform(-1.7, 1.7, (65536, 3)), gen.normal(0, 1, (65536, 3))], 1)
    rows[:, 3:] /= np.linalg.norm(rows[:, 3:], axis=1, keepdims=True)
    cot = gen.normal(0, 1, (65536, 4))
    out = {}
    for device in ("cpu", cuda):
        models, encoders = factory.build_models_and_params(args, seed=3, device=device)
        net = models["model_fine"]
        raw = net(torch.from_numpy(np.float32(rows)).to(device))
        (raw * torch.from_numpy(np.float32(cot)).to(device)).sum().backward()
        field = (raw.detach().cpu(), {k: p.grad.cpu() for k, p in net.named_parameters()})
        net.zero_grad()
        sol = solver.Solver(build_pipeline(RenderConfig.from_args(args), models, encoders), args)
        tb = {k: torch.from_numpy(np.float32(v)).to(device) for k, v in batch.items()}
        aux = sol.train_step(tb, None)
        out[str(device)] = field, float(aux["loss"]), {
            (m, k): p.grad.cpu() for m, mod in models.items() for k, p in mod.named_parameters()}
    ((raw_c, gf_c), loss_c, g_c), ((raw_k, gf_k), loss_k, g_k) = out["cpu"], out["cuda"]

    def gap(a, b):
        return float((a - b).norm()) / float(b.norm())

    assert g_c[("model_fine", "hash_table")].shape == (6098925, 2)
    assert gap(raw_k, raw_c) <= HASH_RAW_REL
    field_gaps = {k: gap(gf_k[k], g) for k, g in gf_c.items()}
    assert max(field_gaps.values()) <= HASH_GRAD_REL, field_gaps
    assert abs(loss_k - loss_c) <= HASH_LOSS_REL * loss_c
    step_gaps = {k: gap(g_k[k], g) for k, g in g_c.items()}
    assert all(float(g.norm()) > 0 for g in g_c.values())
    assert max(step_gaps.values()) <= BWD_DW_REL, step_gaps


# ------------------------------------------------- kernel G: the vertex attention

def _attention_inputs(gen, R, S, V, device, shift=0.0, meshes=8):
    """Rays from a circle of radius 2.4 at a body-sized box of V vertices, each
    ray's mesh gathered from `meshes` poses as the pipeline gathers its table
    (8 images a batch); `shift` moves the vertices away along x. The CPU
    tests' `_inputs` (test_torch_port_vertex_attention.py) on the card; this
    file imports no other test module, so that it collects alone with
    --noconftest on the card."""
    table = gen.uniform(-1, 1, (meshes, V, 3)) * np.array([0.4, 0.9, 0.25]) + [shift, 0, 0]
    warp_table = gen.normal(0, 0.05, (meshes, V, 3))
    pick = gen.randint(0, meshes, R)
    angle = gen.uniform(0, 2 * np.pi, R)
    origins = np.stack([2.4 * np.cos(angle), gen.normal(0, 0.1, R), 2.4 * np.sin(angle)], -1)
    target = table[pick, gen.randint(0, V, R)] - [shift, 0, 0] + gen.normal(0, 0.05, (R, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    z = np.linspace(1.0, 4.0, S)[None, :] + gen.uniform(0, 3.0 / S, (R, S))
    samples = origins[:, None, :] + z[..., None] * dirs[:, None, :]
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
                 for a in (samples, table[pick], warp_table[pick]))


def _attention_gap(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("R,S,V,radius,temperature", [
    (2048, 64, 6890, 0.15, 1e4),     # a dummy_dynamic.train step
    (4096, 64, 6890, 0.15, 1e4),     # its validation batch
    (2047, 64, 3445, 0.15, 1e4),     # R odd; the mesh halved, as the benchmark's fault halves it
    (5, 64, 1, 0.15, 1e4), (9, 64, 511, 0.15, 1e4), (9, 64, 513, 0.15, 1e4),   # about a tile
    (7, 65, 1000, 0.15, 1e4),        # S one past a chunk of 64 samples
    (7, 16, 1000, 0.3, 100.0),       # fewer samples than a chunk; a soft temperature
])
def test_vertex_attention_kernel_matches_the_eager_path(gen, cuda, R, S, V, radius, temperature):
    s, g, w = _attention_inputs(gen, R, S, V, cuda)
    before = vertex_attention.launches
    got = vertex_attention.vertex_attention_cuda(s, g, w, radius, temperature)
    torch.cuda.synchronize()
    assert vertex_attention.launches == before + 1
    want = vertex_attention.vertex_attention_eager(s, g, w, radius, temperature)
    assert float(want.abs().max()) > 0.0                      # some sample carries a warp
    assert _attention_gap(got, want) <= ATT_REL


def test_vertex_attention_kernel_where_the_correction_term_counts(gen, cuda):
    """At T = 60, M < 104: exp(-M) is not 0, and the -exp(-M) term of the
    modified softmax is a large part of every warp."""
    s, g, w = _attention_inputs(gen, 512, 64, 6890, cuda)
    m = torch.clamp((torch.relu(0.15 - vertex_attention._dist(s, g)) * 60.0).max(), min=0)
    got = vertex_attention.vertex_attention_cuda(s, g, w, 0.15, 60.0)
    want = vertex_attention.vertex_attention_eager(s, g, w, 0.15, 60.0)
    correction = float(torch.exp(-m) * w.sum(1).abs().max())
    assert float(m) < 104 and correction > 1e-2 * float(want.abs().max())
    assert _attention_gap(got, want) <= ATT_REL


def test_vertex_attention_kernel_is_zero_outside_every_sphere(gen, cuda):
    """No sample within the radius of a vertex: M = 0 and every weight is
    exactly 0 (the eager path leaves sum_v w - sum_v w in its rounding)."""
    s, g, w = _attention_inputs(gen, 300, 64, 6890, cuda, shift=10.0)
    got = vertex_attention.vertex_attention_cuda(s, g, w, 0.15, 1e4)
    want = vertex_attention.vertex_attention_eager(s, g, w, 0.15, 1e4)
    assert not bool(got.any())
    assert float(want.abs().max()) <= 1e-5 * float(w.abs().max())


def test_vertex_attention_kernel_takes_strided_inputs(gen, cuda):
    s, g, w = _attention_inputs(gen, 257, 64, 6890, cuda)
    want = vertex_attention.vertex_attention_cuda(s, g, w, 0.15, 1e4)
    s_strided = s.transpose(0, 1).contiguous().transpose(0, 1)
    g_strided = torch.cat([g, g], -1)[..., :3]
    assert not (s_strided.is_contiguous() or g_strided.is_contiguous())
    assert torch.equal(vertex_attention.vertex_attention_cuda(s_strided, g_strided, w, 0.15, 1e4),
                       want)
    half = vertex_attention.vertex_attention_cuda(s, g[:, :3445], w[:, :3445], 0.15, 1e4)
    assert _attention_gap(half, vertex_attention.vertex_attention_eager(
        s, g[:, :3445], w[:, :3445], 0.15, 1e4)) <= ATT_REL


def test_vertex_attention_kernel_is_bit_identical_from_run_to_run(gen, cuda):
    s, g, w = _attention_inputs(gen, 2048, 64, 6890, cuda)
    first = vertex_attention.vertex_attention_cuda(s, g, w, 0.15, 1e4)
    assert torch.equal(vertex_attention.vertex_attention_cuda(s, g, w, 0.15, 1e4), first)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_vertex_attention_on_cuda_refuses_another_dtype(gen, cuda, dtype):
    s, g, w = (t.to(dtype) for t in _attention_inputs(gen, 4, 64, 100, cuda))
    before = vertex_attention.launches
    with torch.no_grad(), pytest.raises(TypeError):
        vertex_attention.vertex_attention_warp(s, g, w, 0.15, 1e4)
    assert vertex_attention.launches == before


def test_vertex_attention_on_cuda_keeps_autograd_where_an_input_needs_it(gen, cuda):
    """A goal mesh that requires a gradient (image_wise_dynamic's) takes the
    eager path, whose gradient is the CPU's; without grad mode the kernel."""
    s, g, w = _attention_inputs(gen, 64, 16, 1000, cuda)
    before = vertex_attention.launches
    g_card = g.clone().requires_grad_(True)
    out = vertex_attention.vertex_attention_warp(s, g_card, w, 0.3, 100.0)
    assert vertex_attention.launches == before and out.requires_grad
    out.square().sum().backward()
    g_cpu = g.cpu().requires_grad_(True)
    vertex_attention.vertex_attention_warp(s.cpu(), g_cpu, w.cpu(), 0.3, 100.0).square().sum() \
        .backward()
    # the same float32 function on two devices: sums in other orders
    assert float((g_card.grad.cpu() - g_cpu.grad).norm()) <= 1e-4 * float(g_cpu.grad.norm())
    with torch.no_grad():
        taken = vertex_attention.vertex_attention_warp(s, g_card, w, 0.3, 100.0)
    assert vertex_attention.launches == before + 1
    assert _attention_gap(taken, out.detach()) <= ATT_REL


def test_vertex_attention_kernel_propagates_nan_as_the_eager_path(gen, cuda):
    """A NaN component of a warp vector makes that component of its ray's
    warps NaN; a NaN sample makes M, and so every warp, NaN."""
    s, g, w = _attention_inputs(gen, 64, 64, 1000, cuda)
    w_nan = w.clone()
    w_nan[3, 17, 1] = float("nan")
    got = vertex_attention.vertex_attention_cuda(s, g, w_nan, 0.15, 1e4)
    want = vertex_attention.vertex_attention_eager(s, g, w_nan, 0.15, 1e4)
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[3, :, 1].isnan().all())
    assert int(got.isnan().sum()) == got.shape[1]
    s_nan = s.clone()
    s_nan[5, 2, 0] = float("nan")
    assert bool(vertex_attention.vertex_attention_cuda(s_nan, g, w, 0.15, 1e4).isnan().all())
    assert bool(vertex_attention.vertex_attention_eager(s_nan, g, w, 0.15, 1e4).isnan().all())


# ------------------------------------ kernel H: the normalised-ReLU attention

def _relu_inputs(gen, R, S, V, device, far_tile=False):
    """`_attention_inputs` with one mesh for every ray ([V, 3] goal and warp
    vectors), as image_wise_dynamic attends; `far_tile` moves vertices 64-127
    (a whole tile of the vertex-major backward) 10 away, so no pair of that
    tile lies inside a sphere."""
    s, g, w = _attention_inputs(gen, R, S, V, device, meshes=1)
    g, w = g[0].contiguous(), w[0].contiguous()
    if far_tile:
        g[64:128, 0] += 10.0
    return s, g, w


def _relu_grads(fn, s, g, w, radius, cot):
    """(out, d samples, d goal, d warps) of fn under the cotangent `cot`."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (s, g, w)]
    out = fn(*leaves, radius)
    return (out.detach(), *torch.autograd.grad(out, leaves, cot))


def _norm_gap(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-300))


@pytest.mark.parametrize("R,S,V,radius,far_tile", [
    (256, 64, 6890, 0.15, False),   # an eighth of an image_wise_dynamic.train step
    (7, 9, 1000, 0.15, False),      # N = 63: under one block of the forward
    (65, 3, 1000, 0.3, False),      # N = 195, V not a multiple of the backward's 64
    (64, 16, 1, 0.3, False),        # one vertex
    (64, 16, 513, 0.15, False),     # one past a tile of the forward
    (128, 16, 200, 0.15, True),     # a vertex tile with no pair inside
])
def test_relu_attention_kernel_matches_eager_autograd_and_float64(gen, cuda, R, S, V, radius,
                                                                 far_tile):
    """H's forward and its three gradients against the eager path under
    autograd (float32, the same a for every pair: only the order of the sums
    differs) and against the eager path in float64, where H is to be no
    further than RELU_F64_FACTOR times the eager float32 path, or within
    RELU_F64_FLOOR."""
    s, g, w = _relu_inputs(gen, R, S, V, cuda, far_tile)
    cot = torch.from_numpy(gen.normal(size=(R, S, 3)).astype(np.float32)).to(cuda)
    before = vertex_attention.relu_launches
    got = _relu_grads(vertex_attention.relu_attention_cuda, s, g, w, radius, cot)
    torch.cuda.synchronize()
    assert vertex_attention.relu_launches == before + 1
    want = _relu_grads(vertex_attention.relu_attention_eager, s, g, w, radius, cot)
    exact = _relu_grads(vertex_attention.relu_attention_eager, s.double(), g.double(),
                        w.double(), radius, cot.double())
    assert float(want[0].abs().max()) > 0.0                   # some sample carries a warp
    assert _attention_gap(got[0], want[0]) <= ATT_REL
    for name, a, b, x in zip(("samples", "goal", "warps"), got[1:], want[1:], exact[1:]):
        assert float(b.abs().max()) > 0.0, name
        assert _norm_gap(a, b) <= RELU_GRAD_REL, (name, _norm_gap(a, b))
        assert _norm_gap(a, x) <= max(RELU_F64_FACTOR * _norm_gap(b, x), RELU_F64_FLOOR), \
            (name, _norm_gap(a, x), _norm_gap(b, x))
    if far_tile:
        assert not bool(got[2][64:128].any()) and not bool(got[3][64:128].any())


def test_relu_attention_kernel_is_bit_identical_from_run_to_run(gen, cuda):
    s, g, w = _relu_inputs(gen, 2048, 64, 6890, cuda)
    cot = torch.from_numpy(gen.normal(size=(2048, 64, 3)).astype(np.float32)).to(cuda)
    first = _relu_grads(vertex_attention.relu_attention_cuda, s, g, w, 0.15, cot)
    again = _relu_grads(vertex_attention.relu_attention_cuda, s, g, w, 0.15, cot)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_relu_attention_kernel_carries_the_goal_gradient_and_none_when_detached(gen, cuda):
    """The benchmark's goal_vjp_gap seam: a fresh goal leaf receives the
    gradient through H's backward (held against the plain closed form), and a
    detached goal leaves the output without a gradient."""
    s, g, w = _relu_inputs(gen, 512, 64, 6890, cuda)
    cot = torch.from_numpy(gen.normal(size=(512, 64, 3)).astype(np.float32)).to(cuda)
    goal = g.clone().requires_grad_(True)
    with torch.enable_grad():
        out = vertex_attention.relu_attention_warp(s, goal, w, 0.15)
        grad, = torch.autograd.grad(out, goal, cot)
    _, want, _ = vertex_attention.relu_attention_backward_plain(s, g, w, 0.15, cot)
    assert float(want.abs().max()) > 0.0
    assert _norm_gap(grad, want) <= RELU_GRAD_REL
    with torch.enable_grad():
        assert not vertex_attention.relu_attention_warp(s, goal.detach(), w, 0.15).requires_grad


def _image_wise_run(cuda, tmp_path, attention=None):
    """(losses, arm angles after each step) of IW_STEPS train_image_wise steps
    on the card from a posed body (so the goal vertices' term of the gradient
    is not 0), through H, or through `attention` at the trainer's seam."""
    from smpl_nerf_tpu_torch.data.datasets import RayData
    from smpl_nerf_tpu_torch.training import image_wise

    net_path = str(tmp_path / "net.pt")
    net = RenderRayNet(n_layers=8, width=64, positions_dim=60, directions_dim=24, skips=(4,),
                       generator=torch.Generator().manual_seed(3))
    torch.save({k: v.detach().clone() for k, v in net.state_dict().items()}, net_path)
    args = config.config_parser().parse_args([
        "--config=", "--model_type=image_wise_dynamic", "--netdepth=8", "--netwidth=64",
        "--skips=4", "--number_coarse_samples=32", "--use_pallas=0", "--use_fused_mlp=0",
        "--sigma_noise_std=0", "--white_background=1", "--warp_radius=0.15",
        "--lrate_pose=3e-3", "--batchsize=256", "--num_epochs=4", "--seed=5",
        f"--load_coarse_model={net_path}", "--dataset_dir="])
    rs = np.random.RandomState(9)
    n = 2 * 16 * 16
    dirs = np.concatenate([rs.uniform(-0.3, 0.3, (n, 2)), -np.ones((n, 1))], 1)
    data = RayData(origins=np.tile(np.float32([[0.0, 0.0, 2.5]]), (n, 1)),
                   directions=dirs.astype(np.float32),
                   image_indices=np.repeat(np.arange(2, dtype=np.int32), 256), h=16, w=16,
                   focal=10.0, num_images=2,
                   camera_transforms=np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)),
                   human_poses=np.zeros((2, 69), np.float32),
                   rgb=rs.uniform(0, 1, (n, 3)).astype(np.float32))
    extras = {"betas": np.zeros(10, np.float32), "smpl_model": factory.smpl_model_for(args),
              "canonical_pose": rs.normal(0.0, 0.3, 69).astype(np.float32)}
    losses, angles = [], []

    def callback(step, loss, models):
        est = models["smpl_estimator"]
        losses.append(loss)
        angles.append(torch.cat([est.arm_angle_l, est.arm_angle_r]).detach().cpu())
        return step == IW_STEPS

    seam = image_wise.relu_attention_warp
    image_wise.relu_attention_warp = attention or seam
    try:
        np.random.seed(5)
        image_wise.train_image_wise(args, None, data, None, extras, device=cuda,
                                    step_callback=callback)
    finally:
        image_wise.relu_attention_warp = seam
    return np.array(losses), torch.stack(angles)


def test_image_wise_steps_through_kernel_h_match_the_eager_path(gen, cuda, tmp_path):
    before = vertex_attention.relu_launches
    losses, angles = _image_wise_run(cuda, tmp_path)
    assert vertex_attention.relu_launches - before == IW_STEPS
    eager_losses, eager_angles = _image_wise_run(
        cuda, tmp_path, lambda s, g, w, r, **k: vertex_attention.relu_attention_eager(s, g, w, r))
    assert vertex_attention.relu_launches - before == IW_STEPS
    assert len(losses) == IW_STEPS and np.all(np.isfinite(losses))
    assert float(angles.abs().max()) > 0.0
    assert np.max(np.abs(losses - eager_losses) / eager_losses) <= IW_LOSS_REL
    assert float((angles - eager_angles).abs().max()) <= IW_ANGLE_ATOL
