"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (decided when the
test runs). The module imports neither JAX nor the JAX package, so it also
runs on a machine without them; there the repository's tests/conftest.py,
which imports JAX, is left out:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: kernel A's cumsum adds in another order than torch.cumsum, so a
rare sample flips one bin (bounded by the widest bin); kernel B rounds to
bf16 at the same places as its plain version but accumulates in another
order, which can flip one bf16 rounding (2^-8 relative) downstream.
"""
import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch import config
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import factory

PDF_ATOL = 2e-4
MLP_REL = 2e-2


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
                                         (7, 15, 16, 0.0), (3, 200, 40, 0.0)])
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


def _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed):
    g = torch.Generator().manual_seed(seed)
    net = RenderRayNet(n_layers=n_layers, width=width, positions_dim=6 * pos_f,
                       directions_dim=6 * dir_f, skips=skips, use_directional_input=use_dir,
                       compute_dtype=torch.bfloat16, generator=g)
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
    before = fused_mlp_v2.launches
    got = fused_mlp_v2.fused_apply_raw(spec, net, x)
    want = fused_mlp_v2.reference_forward_raw(spec, fused_mlp.flatten_params(spec, net), x)
    torch.cuda.synchronize()
    assert fused_mlp_v2.launches == before + 1
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
    net.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        fused_mlp_v2.fused_apply_raw(spec, net, x)


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
