"""The port's serving slice (smpl_nerf novel-view render) vs the JAX package.

Weights are drawn by the JAX factory and carried into the port through
`params_from_jax` (or through a run directory written by JAX `save_run` +
`export_torch_run`); rays come from a seeded numpy RandomState. The port runs
on device="cpu", where every kernel wrapper takes its plain PyTorch version.
Sizes follow tests/test_pipeline_parity.py: 3 layers, width 32, skip at 1,
L=4/2/3, 8 coarse + 16 fine samples, 12 rays.

Tolerances are those of test_pipeline_parity.py: 2e-4 on rgb_coarse and 2e-3
on rgb_fine (the fine pass can flip an inverse-CDF bin where u meets a cdf
entry to float precision).
"""
import dataclasses
import os

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
from smpl_nerf_tpu.ops import fused_mlp as jax_fused_mlp
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import render_path
from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.ops import fused_mlp
from smpl_nerf_tpu_torch.render import batched
from smpl_nerf_tpu_torch.training import checkpoints, factory

RGB_COARSE_ATOL = 2e-4
RGB_FINE_ATOL = 2e-3
R = 12


def _argv(model_type="smpl_nerf", human_pose_encoding=1, white_background=0, use_pallas=0,
          use_fused_mlp=0, extra=()):
    return ["--config=/dev/null", f"--model_type={model_type}",
            f"--human_pose_encoding={human_pose_encoding}",
            "--netdepth=3", "--netwidth=32", "--skips=1",
            "--netdepth_fine=3", "--netwidth_fine=32", "--skips_fine=1",
            "--run_fine=1", "--netwidth_warp=16", "--netdepth_warp=2",
            "--number_coarse_samples=8", "--number_fine_samples=16",
            "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
            "--number_frequencies_pose=3", "--sigma_noise_std=0",
            f"--white_background={white_background}", "--near=1", "--far=4",
            f"--use_pallas={use_pallas}", f"--use_fused_mlp={use_fused_mlp}",
            "--batchsize_val=48", *extra]


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


def _rays(rng, with_pose=True):
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (R, 1))
    dirs = rng.uniform(-0.3, 0.3, (R, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    batch = {"ray_translation": origins, "ray_direction": dirs}
    if with_pose:
        batch["human_pose"] = rng.uniform(-0.5, 0.5, (R, 69)).astype(np.float32)
    return batch


def _compare(jax_out, port_out, keys=("rgb_coarse", "rgb_fine")):
    for key in keys:
        atol = RGB_COARSE_ATOL if key == "rgb_coarse" else RGB_FINE_ATOL
        np.testing.assert_allclose(port_out[key].detach().numpy(), np.asarray(jax_out[key]),
                                   atol=atol, err_msg=key)


# --------------------------------------------------------------- the slice

@pytest.mark.parametrize("jax_pallas,port_pallas,port_fused,pose_enc,white", [
    (0, 0, 0, 1, 0),
    (1, 1, 0, 1, 1),
    (1, 1, 2, 1, 0),     # both kernels' plain versions on the port side
    (0, 1, 2, 0, 1),     # unencoded pose into the warp field
    (0, 0, -1, 1, 0),    # auto resolves to the plain net on the CPU, as in JAX
])
def test_smpl_nerf_fn_matches_jax_build_pipeline(rng, jax_pallas, port_pallas, port_fused,
                                                 pose_enc, white):
    jax_argv = _argv(human_pose_encoding=pose_enc, white_background=white,
                     use_pallas=jax_pallas)
    jargs = jax_config.config_parser().parse_args(jax_argv)
    models, params, encoders = _jax_params(jargs)
    jax_pipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs),
                                            models, encoders, {})
    batch = _rays(rng)
    want = jax_pipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)

    port = _port_pipeline(_argv(human_pose_encoding=pose_enc, white_background=white,
                                use_pallas=port_pallas, use_fused_mlp=port_fused), params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()}, train=False)
    _compare(want, got)
    np.testing.assert_allclose(got["warp"].numpy(), np.asarray(want["warp"]), atol=2e-3)
    np.testing.assert_allclose(got["ray_samples"].numpy(), np.asarray(want["ray_samples"]),
                               atol=2e-3)


@pytest.mark.parametrize("port_fused", [0, 2])
def test_nerf_fn_matches_jax_build_pipeline(rng, port_fused):
    jargs = jax_config.config_parser().parse_args(_argv("nerf", use_pallas=1))
    models, params, encoders = _jax_params(jargs, seed=3)
    jax_pipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs),
                                            models, encoders, {})
    batch = _rays(rng, with_pose=False)
    want = jax_pipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    port = _port_pipeline(_argv("nerf", use_pallas=1, use_fused_mlp=port_fused), params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    _compare(want, got)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(want["depth"]), atol=2e-3)


def test_smpl_nerf_bf16_slice_stays_near_jax(rng):
    # bf16 rounds activations; one summation-order difference can flip a bf16
    # rounding (2^-8 relative) that carries through later layers
    extra = ("--compute_dtype=bfloat16",)
    jargs = jax_config.config_parser().parse_args(_argv(use_pallas=1, extra=extra))
    models, params, encoders = _jax_params(jargs, seed=5)
    jax_pipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs),
                                            models, encoders, {})
    batch = _rays(rng)
    want = jax_pipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    port = _port_pipeline(_argv(use_pallas=1, use_fused_mlp=2, extra=extra), params)
    with torch.no_grad():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("rgb_coarse", "rgb_fine"):
        assert np.abs(got[key].numpy() - np.asarray(want[key])).max() < 2e-2, key


def test_auto_fused_mode_follows_the_jax_resolver():
    """-1 (auto) takes the v2 kernel on CUDA for the prefix-free bf16 nets it
    supports, as JAX's resolver does on its accelerator, else the plain net;
    on the CPU always the plain net."""
    extra = ("--compute_dtype=bfloat16",)
    args = port_config.config_parser().parse_args(_argv(extra=extra))
    models, encoders = factory.build_models_and_params(args, device="cpu")
    pos, dirs = encoders["position"], encoders["direction"]
    spec = fused_mlp.spec_from_model(models["model_coarse"])
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pipelines.resolve_fused_mode_auto(spec, pos, dirs, cuda) == 2
    assert pipelines.resolve_fused_mode_auto(spec, pos, dirs, cpu) == 0
    for unsupported in (dataclasses.replace(spec, dtype="float32"),
                        dataclasses.replace(spec, width=384),
                        dataclasses.replace(spec, additional_input_dim=8)):
        assert pipelines.resolve_fused_mode_auto(unsupported, pos, dirs, cuda) == 0
    with_identity = PositionalEncoder(pos.number_frequencies, True)
    assert pipelines.resolve_fused_mode_auto(spec, with_identity, dirs, cuda) == 0

    jargs = jax_config.config_parser().parse_args(_argv(extra=extra))
    jmodels, _, jencoders = jax_factory.build_models_and_params(jargs, jax.random.PRNGKey(0))
    jspec = jax_fused_mlp.spec_from_model(jmodels["model_coarse"])
    assert jax_pipelines.resolve_fused_mode_auto(
        jspec, jencoders["position"], jencoders["direction"], "tpu") == 2


def test_unported_model_types_and_modes_raise():
    args = port_config.config_parser().parse_args(_argv("append_vertex_locations_to_nerf"))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        factory.build_models_and_params(args, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        pipelines.build_pipeline(pipelines.RenderConfig(model_type="vertex_sphere"), {}, {})
    args = port_config.config_parser().parse_args(_argv(extra=("--siren=1",)))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        factory.build_models_and_params(args, device="cpu")


# ------------------------------------------------------------ batched render

def test_render_rays_batched_pads_the_last_chunk_with_its_last_ray():
    seen = []

    def fake_pipeline(batch):
        seen.append({k: v.clone() for k, v in batch.items()})
        return {"rgb_fine": batch["ray_translation"].clone()}

    n_img, hw = 2, 5
    data = render_path.camera_path_data("circle", n_img, 2.4, -90, 90, 1, [41, 38], 0.0)
    data.origins = np.arange(n_img * hw * 3, dtype=np.float32).reshape(-1, 3)
    data.directions = np.ones_like(data.origins)
    data.image_indices = np.repeat(np.arange(n_img, dtype=np.int32), hw)
    data.human_poses = np.arange(n_img * 69, dtype=np.float32).reshape(n_img, 69)
    out = batched.render_rays_batched(fake_pipeline, data, 4, torch.device("cpu"))
    np.testing.assert_array_equal(out, data.origins)
    assert [b["ray_translation"].shape[0] for b in seen] == [4, 4, 4]
    last = seen[-1]["ray_translation"].numpy()
    np.testing.assert_array_equal(last[2:], np.repeat(data.origins[-1:], 2, 0))
    np.testing.assert_array_equal(seen[1]["human_pose"].numpy(),
                                  data.human_poses[[0, 1, 1, 1]])


# ------------------------------------------------------------------ run dirs

def _write_jax_run(tmp_path, argv):
    parser = jax_config.config_parser()
    args = parser.parse_args(argv)
    _, params, _ = _jax_params(args, seed=7)
    run_dir = str(tmp_path / "run")
    jax_checkpoints.save_run(run_dir, params, args, parser)
    written = jax_checkpoints.export_torch_run(run_dir, run_dir)
    assert set(written) == {"model_coarse", "model_fine", "model_warp_field"}
    return run_dir, params


def test_port_renders_an_exported_jax_run_dir_like_jax_render_dataset(tmp_path):
    run_dir, params = _write_jax_run(tmp_path, _argv(use_pallas=1))
    # the port's loader reads the reference-layout .pt files back unchanged
    for name, sd in checkpoints.load_run(run_dir).items():
        for key, value in checkpoints.params_from_jax({name: params[name]})[name].items():
            np.testing.assert_array_equal(sd[key].numpy(), value.numpy(), err_msg=key)

    steps, res, angle = 2, 8, 20.0
    out = str(tmp_path / "views.npy")
    got = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                            "--number_steps", str(steps), "--resolution", str(res),
                            "--human_pose_angle", str(angle), "--out", out,
                            "--device", "cpu"])
    assert got.shape == (steps, res, res, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(np.load(out), got)

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


def test_port_save_run_round_trips_through_load_run(tmp_path):
    parser = port_config.config_parser()
    args = parser.parse_args(_argv())
    models, _ = factory.build_models_and_params(args, seed=11, device="cpu")
    run_dir = str(tmp_path / "port_run")
    checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()}, args, parser)
    assert sorted(os.listdir(run_dir)) == ["config.txt", "model_coarse.pt", "model_fine.pt",
                                           "model_warp_field.pt"]
    loaded_args = vars(checkpoints.load_config(run_dir))
    assert loaded_args.pop("config") == os.path.join(run_dir, "config.txt")
    assert loaded_args == {k: v for k, v in vars(args).items() if k != "config"}
    loaded = checkpoints.load_run(run_dir)
    for name, model in models.items():
        for key, value in model.state_dict().items():
            assert torch.equal(loaded[name][key], value), (name, key)
    # the JAX package reads the port's run directory back (reference layout)
    jax_params = jax_checkpoints.import_torch_run(run_dir, n_layers=3, n_layers_fine=3)
    back = checkpoints.params_from_jax(jax.device_get(jax_params))
    for name, model in models.items():
        for key, value in model.state_dict().items():
            np.testing.assert_array_equal(back[name][key].numpy(), value.numpy())
