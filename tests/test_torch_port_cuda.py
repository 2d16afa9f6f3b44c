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
and is held by relative norm. Its float32 atomics make dW and db differ in
the last bits from run to run.
"""
import numpy as np
import pytest
import torch

from smpl_nerf_tpu_torch import config
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda
from smpl_nerf_tpu_torch.pipelines import RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import factory, solver

PDF_ATOL = 2e-4
MLP_REL = 2e-2
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2


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
    with pytest.raises(ValueError):
        fused_mlp_v2.fused_backward_cuda(spec, net, x, torch.ones(100, 3, device=cuda))
    prefixed = _net(cuda, 3, 64, 4, 2, (1,), True, seed=1, add=5)
    with pytest.raises(ValueError, match="prefix"):
        fused_mlp_v2.fused_apply_raw(fused_mlp.spec_from_model(prefixed), prefixed,
                                     torch.zeros(10, 11, device=cuda))


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

@pytest.mark.parametrize("n_layers,width,pos_f,dir_f,add,skips,use_dir", [
    (8, 256, 10, 4, 621, (4,), True),    # the configs/config.txt nets
    (8, 256, 10, 4, 0, (4,), True),
    (3, 64, 4, 2, 18, (0, 2), False),
    (2, 32, 1, 1, 5, (), True),
])
def test_fused_v1_kernel_matches_plain(gen, cuda, n_layers, width, pos_f, dir_f, add, skips,
                                       use_dir):
    net = _net(cuda, n_layers, width, pos_f, dir_f, skips, use_dir, seed=width + add, add=add)
    spec = fused_mlp.spec_from_model(net)
    x = torch.from_numpy(gen.uniform(-1, 1, (1000, spec.in_dim)).astype(np.float32)).to(cuda)
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
    with pytest.raises(ValueError, match="shared memory"):
        wide = RenderRayNet(additional_input_dim=1200, compute_dtype=torch.bfloat16).to(cuda)
        fused_mlp.fused_apply(fused_mlp.spec_from_model(wide), wide,
                              torch.zeros(4, 1284, device=cuda))


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

def _check_backward(dflat, dx, want_flat, want_dx):
    assert all(torch.isfinite(t).all() for t in (dx, *dflat))
    err = (dx - want_dx).abs()
    assert float(err.max()) <= BWD_DX_MAX * float(want_dx.abs().max())
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


def test_fused_v2_backward_atomics_are_close_from_run_to_run(gen, cuda):
    net = _net(cuda, 3, 64, 4, 2, (1,), True, seed=4)
    spec = fused_mlp.spec_from_model(net)
    x = _rows(gen, 30000, cuda)
    g = torch.from_numpy(gen.randn(30000, 4).astype(np.float32)).to(cuda)
    a_flat, a_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    b_flat, b_dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    assert torch.equal(a_dx, b_dx)                          # dX has no atomics
    for a, b in zip(a_flat, b_flat):
        assert float((a - b).norm()) <= 1e-5 * float(b.norm()) + 1e-12


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


def test_auto_fused_mode_on_cuda_keeps_prefixed_nets_on_the_plain_net(gen, cuda):
    args = _append_args("append_smpl_params", "--use_fused_mlp=-1")
    models, encoders = factory.build_models_and_params(args, seed=3, device=cuda)
    pipe = build_pipeline(RenderConfig.from_args(args), models, encoders)
    before = (fused_mlp.launches, fused_mlp_v2.launches)
    with torch.no_grad():
        out = pipe({k: torch.from_numpy(v).to(cuda) for k, v in _smpl_batch(gen, 64).items()})
    assert (fused_mlp.launches, fused_mlp_v2.launches) == before
    assert torch.isfinite(out["rgb_fine"]).all()
    with pytest.raises(ValueError, match="prefix"):
        build_pipeline(RenderConfig.from_args(_append_args("append_smpl_params",
                                                           "--use_fused_mlp=2")),
                       models, encoders)


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
