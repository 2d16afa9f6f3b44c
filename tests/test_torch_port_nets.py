"""The port's SIREN and grid nets against the JAX package's, on shared weights.

Weights come from the JAX modules' own init (or the JAX factory) and reach
the port through `checkpoints.params_from_jax`; inputs come from a seeded
numpy RandomState. Sizes are small: depth 3, width 32, grid levels 4 and 8.

Tolerances, each with its reason:
  * float32 forwards: the same operations in the same order, except the
    order of each matmul's sum: max |port - JAX| <= 1e-5 * max |JAX| (the
    SIREN trunk multiplies every pre-activation by 30 before its sine, which
    is where most of that budget goes).
  * float32 gradients: the same, per parameter by relative norm (1e-5 for
    the MLP layers); the grid gradients are scatter sums over the corners the
    samples touch, summed in another order: 1e-5 by relative norm.
  * bf16 SIREN: the sine is taken of a bf16 pre-activation times 30, so one
    bf16 rounding (2^-8 relative) of a pre-activation near 1 moves sin(30 x)
    by up to 30 * 2^-8 ~ 0.12; over three sine layers the outputs stay within
    0.15 * max |JAX| at most and 0.02 * mean |JAX| on average.
  * bf16 grid net: its trunk is ReLU, one rounding flip carries as in the
    RenderRayNet slice: 2e-2 * max |JAX|.
  * pipeline losses in float32 (eval mode: no jitter, no noise): fine
    sampling can flip an inverse-CDF bin where u meets a cdf entry to float
    precision, so the losses agree to 1e-4 relative.
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.models import grid_nerf as jax_grid
from smpl_nerf_tpu.models import render_ray_net as jax_rrn
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import render_path
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.models.grid_nerf import GridNerf, trilinear_interpolate
from smpl_nerf_tpu_torch.models.render_ray_net import Dense, SirenRenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp
from smpl_nerf_tpu_torch.training import checkpoints, factory, solver

F32_REL = 1e-5
SIREN_BF16_MAX, SIREN_BF16_MEAN = 0.15, 0.02
GRID_BF16_MAX = 2e-2
LOSS_REL = 1e-4
N = 64


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(np.abs(np.asarray(want)).max(), 1e-30))


def _norm_rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want))
                 / max(np.linalg.norm(np.asarray(want)), 1e-30))


def _jax_siren(dtype=jnp.float32, add=0, skips=(1,)):
    return jax_rrn.SirenRenderRayNet(n_layers=3, width=32, positions_dim=27,
                                     directions_dim=15, additional_input_dim=add,
                                     skips=skips, dtype=dtype)


def _port_siren(dtype=torch.float32, add=0, skips=(1,)):
    return SirenRenderRayNet(n_layers=3, width=32, positions_dim=27, directions_dim=15,
                             additional_input_dim=add, skips=skips, compute_dtype=dtype)


def _jax_grid(dtype=jnp.float32, add=0):
    return jax_grid.GridNerf(levels=(4, 8), features=4, width=32, n_layers=3, dir_freqs=2,
                             additional_input_dim=add, bound=1.6, dtype=dtype)


def _port_grid(dtype=torch.float32, add=0):
    return GridNerf(levels=(4, 8), features=4, width=32, n_layers=3, dir_freqs=2,
                    additional_input_dim=add, bound=1.6, compute_dtype=dtype)


def _shared(jax_net, port_net, in_dim, seed=0):
    """JAX-initialised variables (biases made non-zero, grids widened so the
    interpolation shows) loaded into the port net; returns the variables."""
    params = jax.device_get(jax.jit(jax_net.init)(jax.random.PRNGKey(seed),
                                                  jnp.zeros((2, in_dim), jnp.float32)))
    rs = np.random.RandomState(seed + 1)

    def widen(path, p):
        name = str(getattr(path[-1], "key", ""))
        if name.startswith("grid_"):
            return np.asarray(rs.uniform(-1, 1, p.shape), np.float32)
        if p.ndim == 1:
            return np.asarray(p) + 0.05 * rs.randn(*p.shape).astype(np.float32)
        return np.asarray(p)

    params = jax.tree_util.tree_map_with_path(widen, params)
    port_net.load_state_dict(checkpoints.params_from_jax({"net": params})["net"])
    return params


def _siren_rows(rs, add=0):
    return rs.uniform(-1, 1, (N, add + 27 + 15)).astype(np.float32)


def _grid_rows(rs, add=0):
    x = rs.uniform(-1, 1, (N, add + 6)).astype(np.float32)
    x[:, add:add + 3] *= 2.0                      # some samples leave the grid's box
    d = x[:, add + 3:]
    x[:, add + 3:] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return x


# ------------------------------------------------------------------ forwards

@pytest.mark.parametrize("kind,add", [("siren", 0), ("siren", 5), ("grid", 0), ("grid", 7)])
def test_forward_and_gradients_match_jax_in_float32(rng, kind, add):
    if kind == "siren":
        jnet, pnet, x = _jax_siren(add=add), _port_siren(add=add), _siren_rows(rng, add)
    else:
        jnet, pnet, x = _jax_grid(add=add), _port_grid(add=add), _grid_rows(rng, add)
    params = _shared(jnet, pnet, x.shape[1])
    cot = rng.randn(N, 4).astype(np.float32)

    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pnet(xt)
    assert _rel(got.detach(), want) <= F32_REL

    def jax_loss(p, xx):
        return jnp.sum(jnet.apply(p, xx) * cot)

    gp, gx = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(params, jnp.asarray(x))
    (got * torch.from_numpy(cot)).sum().backward()
    want_grads = checkpoints.params_from_jax({"net": jax.device_get(gp)})["net"]
    port_grads = {k: p.grad for k, p in pnet.named_parameters()}
    assert set(port_grads) == set(want_grads)
    for key, g in want_grads.items():
        assert _norm_rel(port_grads[key], g) <= F32_REL, key
    assert _norm_rel(xt.grad, gx) <= F32_REL


def test_bf16_siren_stays_within_its_stated_bound(rng):
    jnet, pnet, x = _jax_siren(jnp.bfloat16), _port_siren(torch.bfloat16), _siren_rows(rng)
    params = _shared(jnet, pnet, x.shape[1])
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x)).numpy()
    err = np.abs(got - want)
    assert err.max() <= SIREN_BF16_MAX * np.abs(want).max()
    assert err.mean() <= SIREN_BF16_MEAN * np.abs(want).mean()


def test_bf16_grid_net_stays_within_its_stated_bound(rng):
    jnet, pnet, x = _jax_grid(jnp.bfloat16, 7), _port_grid(torch.bfloat16, 7), _grid_rows(rng, 7)
    params = _shared(jnet, pnet, x.shape[1])
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x)), np.float32)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x)).numpy()
    assert _rel(got, want) <= GRID_BF16_MAX


def test_trilinear_interpolation_matches_jax(rng):
    grid = rng.randn(5, 5, 5, 3).astype(np.float32)
    p = rng.uniform(-0.2, 1.2, (200, 3)).astype(np.float32)
    p[:4] = [[0, 0, 0], [1, 1, 1], [0.25, 0.5, 0.75], [1, 0, 0.5]]    # lattice points, edges
    want = np.asarray(jax_grid.trilinear_interpolate(jnp.asarray(grid), jnp.asarray(p)))
    got = trilinear_interpolate(torch.from_numpy(grid), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], grid[0, 0, 0], atol=1e-6)
    np.testing.assert_allclose(got[1], grid[4, 4, 4], atol=1e-6)


def test_siren_init_follows_the_siren_scheme():
    net = SirenRenderRayNet(n_layers=3, width=64, positions_dim=27, directions_dim=15,
                            skips=(1,), generator=torch.Generator().manual_seed(0))
    first = net.positions_pose_input.weight
    assert first.abs().max() <= 1.0 / 27 and first.abs().max() > 0.9 / 27
    for layer in (*net.positional_net, net.additional_linear_layer, net.directional_net[0]):
        bound = (6.0 / layer.weight.shape[1]) ** 0.5 / 30.0
        assert layer.weight.abs().max() <= bound and layer.weight.abs().max() > 0.9 * bound
        assert torch.count_nonzero(layer.bias) == 0
    # the heads keep the lecun-normal init: clipped at two standard deviations
    for layer in (net.sigma_out_layer, net.directional_input, net.rgb_out_layer):
        std = (1.0 / layer.weight.shape[1]) ** 0.5 / 0.87962566103423978
        assert layer.weight.abs().max() <= 2 * std
        assert layer.weight.abs().max() > (6.0 / layer.weight.shape[1]) ** 0.5 / 30.0
    grid = GridNerf(levels=(4, 8), generator=torch.Generator().manual_seed(0))
    assert all(float(g.detach().abs().max()) <= 1e-4 for g in grid.grids())


# ------------------------------------------------------- factory and pipeline

def _argv(model_type="nerf", net="siren", fused=0, extra=()):
    flag = ["--siren=1"] if net == "siren" else [
        "--grid_encoding=1", "--grid_levels=4,8", "--grid_width=32", "--grid_depth=3"]
    return ["--config=/dev/null", f"--model_type={model_type}", "--netdepth=3",
            "--netwidth=32", "--skips=1", "--netdepth_fine=3", "--netwidth_fine=32",
            "--skips_fine=1", "--run_fine=1", "--number_coarse_samples=8",
            "--number_fine_samples=16", "--number_frequencies_postitional=4",
            "--number_frequencies_directional=2", "--number_frequencies_pose=2",
            "--human_pose_encoding=1", "--sigma_noise_std=0", "--near=1", "--far=4",
            "--use_pallas=0", f"--use_fused_mlp={fused}", "--batchsize_val=48", *flag, *extra]


def _jax_models(argv, seed=0):
    jargs = jax_config.config_parser().parse_args(argv)
    models, params, encoders = jax_factory.build_models_and_params(jargs,
                                                                   jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                   if p.ndim == 1 else 0.0), jax.device_get(params))
    return jargs, models, params, encoders


def _port_pipeline(argv, params=None):
    args = port_config.config_parser().parse_args(argv)
    models, encoders = factory.build_models_and_params(args, device="cpu")
    if params is not None:
        for name, sd in checkpoints.params_from_jax(params).items():
            models[name].load_state_dict(sd)
    return pipelines.build_pipeline(pipelines.RenderConfig.from_args(args), models, encoders)


def _batch(rng, R=12):
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    return {"ray_translation": origins, "ray_direction": dirs,
            "human_pose": rng.uniform(-0.5, 0.5, (R, 69)).astype(np.float32),
            "rgb": rng.uniform(0, 1, (R, 3)).astype(np.float32)}


@pytest.mark.parametrize("net,model_type", [("siren", "nerf"), ("siren", "append_to_nerf"),
                                            ("grid", "nerf"), ("grid", "append_smpl_params")])
def test_factory_nets_carry_jax_weights_and_the_loss_matches(rng, net, model_type):
    argv = _argv(model_type, net)
    jargs, jmodels, params, encoders = _jax_models(argv)
    port = _port_pipeline(argv, params)
    cls = SirenRenderRayNet if net == "siren" else GridNerf
    for key in ("model_coarse", "model_fine"):
        assert type(port.models[key]) is cls
        fresh = factory.build_models_and_params(port_config.config_parser().parse_args(argv),
                                                device="cpu")[0][key].state_dict()
        carried = checkpoints.params_from_jax({key: params[key]})[key]
        assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in carried.items()}
    jpipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs), jmodels,
                                         encoders, {})
    batch = _batch(rng)
    jax_loss = jax.jit(lambda p, b: jax_solver.make_loss_fn(jpipe)(p, b, None, False)[0])
    want = jax_loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, _ = solver.make_loss_fn(port)({k: torch.from_numpy(v) for k, v in batch.items()},
                                           None, False)
    assert abs(float(got) - float(want)) <= LOSS_REL * abs(float(want))


@pytest.mark.parametrize("net", ["siren", "grid"])
@pytest.mark.parametrize("fused", [1, 2])
def test_an_explicit_fused_mode_on_a_siren_or_grid_net_raises(net, fused):
    with pytest.raises(ValueError, match=f"--use_fused_mlp={fused}: the fused kernels run "
                                         "RenderRayNet only"):
        _port_pipeline(_argv(net=net, fused=fused))


@pytest.mark.parametrize("net", ["siren", "grid", "relu"])
def test_auto_mode_resolves_only_render_ray_nets(rng, monkeypatch, capsys, net):
    """With the resolver answering 2 (as it does on the card for a prefix-free
    bf16 net), a RenderRayNet is sent to kernel B and a SIREN or grid net is
    left on its own forward, never reaching the resolver."""
    asked = []

    def on_the_card(spec, *args):
        asked.append(spec)
        return 2

    monkeypatch.setattr(pipelines, "resolve_fused_mode_auto", on_the_card)
    argv = _argv(net="siren" if net == "relu" else net, fused=-1)
    if net == "relu":
        argv = [a for a in argv if a != "--siren=1"]
    auto = _port_pipeline(argv)
    out = capsys.readouterr().out
    if net == "relu":
        assert type(auto.models["model_coarse"]) is RenderRayNet
        assert len(asked) == 2 and "fused v2 selected for model_coarse" in out
        return
    assert asked == [] and "fused v2 selected" not in out
    plain = _port_pipeline([a.replace("--use_fused_mlp=-1", "--use_fused_mlp=0") for a in argv])
    plain.models["model_coarse"].load_state_dict(auto.models["model_coarse"].state_dict())
    plain.models["model_fine"].load_state_dict(auto.models["model_fine"].state_dict())
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
    with torch.no_grad():
        a, p = auto(batch), plain(batch)
    assert torch.equal(a["rgb_fine"], p["rgb_fine"])


class _SplitDense(Dense):
    """Stands for parallel/tp.ColumnParallelDense: a subclass of Dense."""


@pytest.mark.parametrize("net", ["relu", "siren", "split"])
def test_auto_mode_sends_prefixed_no_grad_passes_to_kernel_d(rng, monkeypatch, capsys, net):
    """With the resolver answering as on the card, each bf16 RenderRayNet of an
    append pipeline calls kernel D's forward (a recording stand-in over its
    plain version) once a pass without autograd, rendering what an explicit
    --use_fused_mlp=1 renders, and never under autograd, where it renders as
    the plain net; a SIREN prefixed net never calls it, nor a net whose layer
    tensor parallelism swapped for a subclass of Dense after the build."""
    resolve = pipelines.resolve_fused_modes_auto
    monkeypatch.setattr(pipelines, "resolve_fused_modes_auto",
                        lambda spec, pos, dirs, device: resolve(spec, pos, dirs,
                                                                torch.device("cuda")))
    calls = []

    def kernel_d(spec, net, rows):
        calls.append((rows.dtype, rows.shape[1] == spec.in_dim, torch.is_grad_enabled()))
        return fused_mlp.reference_forward(spec, fused_mlp.flatten_params(spec, net), rows)

    monkeypatch.setattr(fused_mlp, "fused_forward_cuda", kernel_d)
    argv = _argv("append_smpl_params", "siren", fused=-1, extra=("--compute_dtype=bfloat16",))
    if net != "siren":
        argv = [a for a in argv if a != "--siren=1"]
    auto = _port_pipeline(argv)
    out = capsys.readouterr().out
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
    if net == "split":
        auto.models["model_coarse"].positional_net[0].__class__ = _SplitDense
        with torch.no_grad():
            auto(batch)
        assert calls == [(torch.float32, True, False)]     # the fine net's alone
        return
    with torch.no_grad():
        rendered = auto(batch)["rgb_fine"]
    trained = auto(batch)["rgb_fine"]
    if net == "siren":
        assert calls == [] and "kernel D" not in out
        return
    assert type(auto.models["model_coarse"]) is RenderRayNet
    assert "fused v1 (kernel D) selected for model_coarse without autograd" in out
    assert calls == [(torch.float32, True, False)] * 2
    for mode, want in ((1, rendered), (0, trained)):
        other = _port_pipeline([a.replace("--use_fused_mlp=-1", f"--use_fused_mlp={mode}")
                                for a in argv])
        for key in ("model_coarse", "model_fine"):
            other.models[key].load_state_dict(auto.models[key].state_dict())
        with torch.no_grad():
            assert torch.equal(other(batch)["rgb_fine"], want.detach())
    assert len(calls) == 2


def test_grid_run_renders_the_same_through_fast_1_at_full_cap(tmp_path):
    """A saved grid run renders through render_path; --fast 1 --cap_fraction 1
    sends every ray through the fine pass, so it gives the full render."""
    parser = port_config.config_parser()
    args = parser.parse_args(_argv("smpl_nerf", "grid", extra=("--netwidth_warp=16",)))
    models, _ = factory.build_models_and_params(args, seed=3, device="cpu")
    with torch.no_grad():
        for m in (models["model_coarse"], models["model_fine"]):
            for g in m.grids():
                g.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(1))
    run_dir = str(tmp_path / "grid_run")
    checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()}, args, parser)
    assert "grid_4" in torch.load(os.path.join(run_dir, "model_coarse.pt"))

    def views(*extra):
        return render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                                 "--number_steps", "2", "--resolution", "8",
                                 "--human_pose_angle", "20", "--out",
                                 str(tmp_path / "v.npy"), "--device", "cpu", *extra])

    full = views()
    assert full.shape == (2, 8, 8, 3) and np.isfinite(full).all()
    np.testing.assert_allclose(views("--fast", "1", "--cap_fraction", "1"), full, atol=1e-5)
    culled = views("--fast", "2")
    assert culled.shape == full.shape and np.isfinite(culled).all()


def test_grid_net_trains_end_to_end(tmp_path, monkeypatch):
    """The JAX package's test_grid_nerf_trains_end_to_end through the port:
    --grid_encoding=1 trains through the standard solver on a generated nerf
    set, and its loss drops hard within 6 epochs (no SummaryWriter: its
    import costs seconds and logs nothing this test reads)."""
    from smpl_nerf_tpu_torch.cli import train as train_cli
    from smpl_nerf_tpu_torch.data import generate

    monkeypatch.setattr(train_cli, "summary_writer", lambda log_dir: None)

    data_dir = str(tmp_path / "ds")
    gparser = port_config.dataset_config_parser()
    generate.create_dataset(gparser.parse_args([
        f"--save_dir={data_dir}", "--dataset_type=nerf", "--resolution=16",
        "--camera_path=circle", "--number_steps=4", "--train_val_ratio=0.75"]), gparser,
        device="cpu")
    sol = train_cli.train([
        "--config=/dev/null", "--model_type=nerf", f"--dataset_dir={data_dir}",
        "--grid_encoding=1", "--grid_levels=4,8,16", "--grid_features=2", "--grid_width=16",
        "--num_epochs=6", "--batchsize=128", "--batchsize_val=128",
        "--number_coarse_samples=8", "--run_fine=0", "--sigma_noise_std=0", "--use_pallas=0",
        "--lrate=1e-2", "--render_gif=0", "--number_validation_images=0"],
        log_dir=str(tmp_path / "run"), device="cpu")
    h = sol.history["train_loss"]
    assert type(sol.models["model_coarse"]) is GridNerf
    assert np.isfinite(h).all() and h[-1] < 0.4 * h[0]
