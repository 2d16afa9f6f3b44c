"""The port's append families (append_to_nerf, append_smpl_params) and the fused
v1 forward (kernel D's plain version and weight pack) vs the JAX package.

Weights come from the JAX factory through `params_from_jax`, rays and poses
from a seeded numpy RandomState; the port runs on device="cpu", where
`fused_apply` takes its plain version. The JAX side runs its Pallas v1 kernel
in interpret mode, as its own tests do. Sizes: 3 layers, width 32, skip 1,
L=4/2, 8 coarse + 16 fine samples, 12 rays.

Tolerances: float32 rgb_coarse 1e-5 (same math, another summation order);
rgb_fine 2e-3, because the fine pass can flip an inverse-CDF bin where u
meets a cdf entry to float precision; bf16 2e-2 (one summation-order
difference can flip a bf16 rounding that carries through later layers).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.cli import inference as jax_inference
from smpl_nerf_tpu.core import cameras as jax_cameras
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.models import RenderRayNet as JaxRenderRayNet
from smpl_nerf_tpu.ops import fused_mlp as jax_fused
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import render_path
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp
from smpl_nerf_tpu_torch.training import checkpoints, factory

R = 12
RGB_COARSE_ATOL, RGB_FINE_ATOL, BF16_ATOL = 1e-5, 2e-3, 2e-2


def _argv(model_type, pose_enc=1, use_fused_mlp=0, use_pallas=1, extra=()):
    return ["--config=/dev/null", f"--model_type={model_type}",
            f"--human_pose_encoding={pose_enc}", "--netdepth=3", "--netwidth=32", "--skips=1",
            "--netdepth_fine=3", "--netwidth_fine=32", "--skips_fine=1", "--run_fine=1",
            "--number_coarse_samples=8", "--number_fine_samples=16",
            "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
            "--number_frequencies_pose=2", "--use_identity_pose=1", "--sigma_noise_std=0",
            "--white_background=1", "--near=1", "--far=4", f"--use_pallas={use_pallas}",
            f"--use_fused_mlp={use_fused_mlp}", "--batchsize_val=48", *extra]


def _jax_params(args, seed=0):
    """JAX models + params with non-zero biases (a misplaced bias shows)."""
    models, params, encoders = jax_factory.build_models_and_params(
        args, jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed + 1)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                   if p.ndim == 1 else 0.0),
        jax.device_get(params))
    return models, params, encoders


def _port_pipeline(argv, jax_params):
    args = port_config.config_parser().parse_args(argv)
    models, encoders = factory.build_models_and_params(args, device="cpu")
    for name, sd in checkpoints.params_from_jax(jax_params).items():
        models[name].load_state_dict(sd)
    return pipelines.build_pipeline(pipelines.RenderConfig.from_args(args), models, encoders)


def _rays(rng):
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    return {"ray_translation": origins, "ray_direction": dirs,
            "human_pose": rng.uniform(-0.5, 0.5, (R, 69)).astype(np.float32)}


def _both(rng, model_type, pose_enc, jax_fused_mode, port_fused_mode, extra=(), seed=0):
    jargs = jax_config.config_parser().parse_args(
        _argv(model_type, pose_enc, jax_fused_mode, extra=extra))
    models, params, encoders = _jax_params(jargs, seed)
    jax_pipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs),
                                            models, encoders, {})
    batch = _rays(rng)
    want = jax_pipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    port = _port_pipeline(_argv(model_type, pose_enc, port_fused_mode, extra=extra), params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    return want, got, port


# ------------------------------------------------------------ the pipelines

@pytest.mark.parametrize("model_type,additional", [("append_to_nerf", 2 * 5),
                                                   ("append_smpl_params", 69 * 5)])
@pytest.mark.parametrize("jax_mode,port_mode", [(0, 0), (1, 1), (0, 1), (0, -1)])
def test_append_fn_matches_jax_build_pipeline(rng, model_type, additional, jax_mode,
                                              port_mode):
    want, got, port = _both(rng, model_type, 1, jax_mode, port_mode)
    assert port.models["model_coarse"].additional_input_dim == additional
    np.testing.assert_allclose(got["rgb_coarse"].numpy(), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)
    np.testing.assert_allclose(got["rgb_fine"].numpy(), np.asarray(want["rgb_fine"]),
                               atol=RGB_FINE_ATOL)
    np.testing.assert_allclose(got["ray_samples"].numpy(), np.asarray(want["ray_samples"]),
                               atol=RGB_FINE_ATOL)
    assert set(got) == set(want)


def test_append_fn_without_pose_encoding_feeds_the_raw_pose(rng):
    want, got, port = _both(rng, "append_smpl_params", 0, 0, 1, seed=2)
    assert port.models["model_fine"].additional_input_dim == 69
    np.testing.assert_allclose(got["rgb_coarse"].numpy(), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)


@pytest.mark.parametrize("model_type", ["append_to_nerf", "append_smpl_params"])
def test_append_bf16_stays_near_jax(rng, model_type):
    want, got, _ = _both(rng, model_type, 1, 1, 1, extra=("--compute_dtype=bfloat16",), seed=4)
    for key in ("rgb_coarse", "rgb_fine"):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < BF16_ATOL, key


def test_explicit_v2_with_a_prefix_runs_plain_on_cpu_and_is_refused_for_cuda(rng):
    """JAX's explicit --use_fused_mlp=2 takes nets with a prefix; the port's
    plain version does too, but kernels B and C do not yet: refused by name."""
    want, got, port = _both(rng, "append_to_nerf", 1, 2, 2, seed=6)
    np.testing.assert_allclose(got["rgb_coarse"].numpy(), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)
    from smpl_nerf_tpu_torch.ops import fused_mlp_v2
    spec = fused_mlp.spec_from_model(port.models["model_coarse"])
    reason = fused_mlp_v2.kernel_supports(
        fused_mlp.MlpSpec(**{**spec.__dict__, "dtype": "bfloat16"}))
    assert "prefix" in reason and "use_fused_mlp=1" in reason


# ------------------------------------------------------------ kernel D, plain

def _jax_net(add, width=32, n_layers=3, skips=(1,), use_dir=True, seed=0):
    net = JaxRenderRayNet(n_layers=n_layers, width=width, positions_dim=24,
                          directions_dim=12, additional_input_dim=add, skips=skips,
                          use_directional_input=use_dir)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((2, 36 + add)))
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(rs.randn(*p.shape), jnp.float32) if p.ndim == 1 else p,
        params)


def _port_net(params, add, width=32, n_layers=3, skips=(1,), use_dir=True,
              dtype=torch.float32):
    net = RenderRayNet(n_layers=n_layers, width=width, positions_dim=24, directions_dim=12,
                       additional_input_dim=add, skips=skips, use_directional_input=use_dir,
                       compute_dtype=dtype)
    net.load_state_dict(checkpoints.params_from_jax({"m": params})["m"])
    return net


def _specs(dtype, add, width=32, n_layers=3, skips=(1,), use_dir=True):
    common = dict(n_layers=n_layers, width=width, positions_dim=24, directions_dim=12,
                  additional_input_dim=add, skips=tuple(skips), use_directional_input=use_dir,
                  dtype=dtype)
    return jax_fused.MlpSpec(**common), fused_mlp.MlpSpec(**common)


@pytest.mark.parametrize("add", [0, 18, 621])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_fused_apply_plain_matches_jax_pallas_forward_interpret(rng, add, dtype, atol):
    jspec, pspec = _specs(dtype, add)
    params = _jax_net(add)
    net = _port_net(params, add)
    x = rng.uniform(-1, 1, (70, jspec.in_dim)).astype(np.float32)
    want = np.asarray(jax_fused._pallas_forward(
        jspec, jax_fused.flatten_params(jspec, params), jnp.asarray(x), True))
    before = fused_mlp.launches
    got = fused_mlp.fused_apply(pspec, net, torch.from_numpy(x)).detach().numpy()
    assert fused_mlp.launches == before          # CPU rows never launch
    np.testing.assert_allclose(got, want, atol=atol * max(1.0, np.abs(want).max()))


def _emulate_packed_kernel(spec, w, b, table, x):
    """Kernel D's algorithm step by step on the CPU, reading the same weight
    pack: padded prefix+pos and dir blocks, segment-wise K, f32 bias, bf16 rounding."""
    def block(cols):
        pad = (-cols.shape[1]) % 16
        return torch.cat([cols, torch.zeros(cols.shape[0], pad)], -1).to(torch.bfloat16)

    pos = block(x[:, :spec.pos_block])
    dirs = block(x[:, spec.in_dim - spec.directions_dim:])

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


@pytest.mark.parametrize("kw", [{"add": 621, "width": 64}, {"add": 18, "skips": (0, 1)},
                                {"add": 5, "use_dir": False}])
def test_weight_pack_drives_kernel_d_math_to_plain_version(rng, kw):
    add = kw.pop("add")
    _, pspec = _specs("bfloat16", add, **kw)
    net = _port_net(_jax_net(add, **kw), add, dtype=torch.bfloat16, **kw)
    flat = fused_mlp.flatten_params(pspec, net)
    w, b, table = fused_mlp.pack_weights(pspec, flat, "cpu")
    layout = fused_mlp.pack_layout(pspec)
    assert w.dtype == torch.bfloat16 and table.shape == (pspec.n_layers + 5, 4)
    assert [list(map(int, row)) for row in table] == [list(l[2:]) for l in layout]
    assert all(int(k) % 16 == 0 for k in table[:-2, 2])
    assert all(int(o) % 8 == 0 for o in table[:, 0])
    x = torch.from_numpy(rng.uniform(-1, 1, (96, pspec.in_dim)).astype(np.float32))
    got = _emulate_packed_kernel(pspec, w, b, table, x)
    want = fused_mlp.reference_forward(pspec, flat, x)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               atol=1e-2 * float(want.detach().abs().max()))
    # gradients in the pack's layout come back as the flat (kernel, bias) pairs
    dflat = fused_mlp.unpack_grads(pspec, w.float(), b)
    for got_g, param in zip(dflat, flat):
        assert got_g.shape == param.shape
        np.testing.assert_allclose(got_g.numpy(), param.detach().to(torch.bfloat16 if
                                   got_g.dim() == 2 else torch.float32).float().numpy())


def test_kernel_d_gate_and_shared_memory_budget():
    flagship = fused_mlp.MlpSpec(additional_input_dim=621)        # configs/config.txt
    assert fused_mlp.kernel_supports(flagship) == ""
    assert 150_000 < fused_mlp.shared_bytes(flagship) <= fused_mlp.MAX_SHARED_BYTES
    assert fused_mlp.shared_bytes(fused_mlp.MlpSpec()) < fused_mlp.MAX_SHARED_BYTES // 2
    assert "shared memory" in fused_mlp.kernel_supports(
        fused_mlp.MlpSpec(additional_input_dim=1200))
    assert "bfloat16" in fused_mlp.kernel_supports(fused_mlp.MlpSpec(dtype="float32"))
    assert "width" in fused_mlp.kernel_supports(fused_mlp.MlpSpec(width=48))
    x = torch.zeros(4, flagship.in_dim)
    net = RenderRayNet(additional_input_dim=621, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp.fused_forward_cuda(flagship, net, x)


# ------------------------------------------------------------------ run dirs

def test_port_renders_an_exported_jax_append_run_dir_like_jax_render_dataset(tmp_path):
    parser = jax_config.config_parser()
    args = parser.parse_args(_argv("append_smpl_params", use_fused_mlp=1))
    _, params, _ = _jax_params(args, seed=7)
    run_dir = str(tmp_path / "run")
    jax_checkpoints.save_run(run_dir, params, args, parser)
    assert set(jax_checkpoints.export_torch_run(run_dir, run_dir)) == {"model_coarse",
                                                                       "model_fine"}
    steps, res, angle = 2, 8, 20.0
    got = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                            "--number_steps", str(steps), "--resolution", str(res),
                            "--human_pose_angle", str(angle),
                            "--out", str(tmp_path / "views.npy"), "--device", "cpu"])
    assert got.shape == (steps, res, res, 3) and np.isfinite(got).all()

    jargs, extras, _ = jax_inference.setup_from_run_dir(run_dir)
    cams, _ = jax_cameras.get_circle_poses(-90, 90, steps, 2.4)
    data = jax_datasets.rays_from_cameras(cams, res, res, np.pi / 3)
    pose = np.zeros((steps, 69), np.float32)
    for j in jargs.human_joints:
        pose[:, int(j)] = np.deg2rad(angle)
    data.human_poses, data.betas = pose, np.zeros(10, np.float32)
    want = jax_inference.render_dataset(jargs, extras, run_dir, data)
    np.testing.assert_allclose(got, want, atol=RGB_FINE_ATOL)
    assert np.abs(got - want).mean() < 1e-4
