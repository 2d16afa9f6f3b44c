"""The port's distillation tool end to end on the CPU (the slice as a whole):
a tiny dataset from the JAX package's generator, a tiny run the port trains
itself, then `cli/distill.py`: teacher, distill, fine-tune (both phases), ESS,
every serving form, the ray-cull legs, `scores.json` and `field.npz`; the
static `nerf` family and the pose-baked `append_smpl_params` family; the warp
family and an append run without `--pose_image` are refused.

The tool's host-side sizing (`tiled_budget`, `max_bucket_count`,
`ray_fg_masks`, `filter_images_by_pose`) is held against the JAX tool's on the
same split: integer results, equal exactly.

Training recipe note: tiny runs need --sigma_noise_std=1 and
--foreground_sample_ratio=0.5, or they collapse into a transparent field and
the teacher has no density to distill.
"""
import _torch_threads  # noqa: F401

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.data import generate as jax_generate
from smpl_nerf_tpu_torch.cli import distill
from smpl_nerf_tpu_torch.cli.train import train
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.render import experts as ex
from tools import distill_run as jax_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_dataset(d, n_cams=4, n_poses=1):
    parser = jax_config.dataset_config_parser()
    argv = [f"--save_dir={d}", "--dataset_type=smpl_nerf", "--resolution=12",
            "--camera_path=circle", f"--number_steps={n_cams}", "--train_val_ratio=0.75"]
    if n_poses > 1:
        argv += ["--multi_human_pose=1", f"--human_number_steps={n_poses}",
                 "--human_start_angle=0", "--human_end_angle=40"]
    jax_generate.create_dataset(parser.parse_args(argv), parser)


def _train_run(root, ds, model_type, extra=()):
    log_dir = os.path.join(root, f"run_{model_type}")
    train(["--config=/dev/null", f"--model_type={model_type}", f"--dataset_dir={ds}",
           "--num_epochs=3", "--batchsize=128", "--batchsize_val=128",
           "--number_coarse_samples=8", "--run_fine=0", "--sigma_noise_std=1",
           "--foreground_sample_ratio=0.5", "--netdepth=2", "--netwidth=16",
           "--number_frequencies_postitional=2", "--number_frequencies_directional=1",
           "--use_pallas=0", "--render_gif=0", "--number_validation_images=0",
           "--steps_per_epoch=60", "--lrate=1e-3"] + list(extra),
          log_dir=log_dir, device="cpu")
    return log_dir


def _distill_argv(run_dir, ds, out_dir, extra=()):
    return ([f"--run_dir={run_dir}", f"--dataset_dir={ds}/val", f"--out_dir={out_dir}",
             "--grid=4", "--hidden=8", "--l_pos=2", "--l_dir=1", "--steps=40", "--batch=256",
             "--samples=8", "--chunk=72", "--tile=8", "--images=1", "--time_reps=1",
             "--time_tiles=16", "--finetune_steps=10", "--finetune_batch=64",
             "--finetune_samples=8", "--finetune_tile=8", "--ess=1", "--ess_probe=2",
             "--ess_thresh=0.01", "--sigma_thresh=0.05", "--probe_res=12", "--ray_cull=0",
             "--device=cpu"] + list(extra))


@pytest.fixture(scope="module")
def static_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_distill_static"))
    ds = os.path.join(root, "ds")
    _make_dataset(ds)
    return ds, _train_run(root, ds, "nerf"), root


@pytest.fixture(scope="module")
def append_setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_distill_append"))
    ds = os.path.join(root, "ds")
    _make_dataset(ds, n_cams=4, n_poses=2)
    run_dir = _train_run(root, ds, "append_smpl_params",
                         extra=["--human_pose_encoding=1", "--number_frequencies_pose=2"])
    return ds, run_dir, root


@pytest.fixture(scope="module")
def static_out(static_setup):
    ds, run_dir, root = static_setup
    out_dir = os.path.join(root, "distill")
    return distill.main(_distill_argv(run_dir, ds, out_dir, ["--finetune2_steps=6"])), out_dir


def test_distill_static_nerf_end_to_end(static_out):
    out, out_dir = static_out
    with open(os.path.join(out_dir, "scores.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(out))
    # the keys of the JAX tool's scores.json, the device the times were taken on,
    # the heartbeat losses and what was resumed
    assert {"run_dir", "dataset_dir", "grid", "hidden", "steps", "samples", "chunk", "tile",
            "budget_full", "model_type", "pose_image", "pose_views_scored", "distill_bias",
            "serve_dtype", "distill_seconds", "distill_final_mse", "teacher", "distilled",
            "distill_gap", "finetune", "finetune2", "ess", "ray_cull", "latency_ms",
            "device", "distill_loss_history", "resumed"} == set(out)
    assert out["resumed"] == {"field": False, "teacher_render": False}
    steps, losses = zip(*out["distill_loss_history"])
    assert steps[-1] == out["steps"] and list(steps) == sorted(set(steps))
    assert np.isfinite(losses).all() and losses[-1] == pytest.approx(out["distill_final_mse"],
                                                                     abs=1e-5)
    for phase in ("finetune", "finetune2"):
        steps, losses = zip(*out[phase]["loss_history"])
        assert steps[-1] == out[phase]["steps"] and not out[phase]["resumed"]
        assert losses[-1] == pytest.approx(out[phase]["final_pixel_mse"], abs=1e-6)
    assert out["device"] == "cpu" and out["model_type"] == "nerf" and out["pose_image"] is None
    for leg in ("teacher", "distilled", "distill_gap"):
        assert set(out[leg]) == {"mse", "psnr", "ssim"} and out[leg]["psnr"] > 0
    assert out["finetune"]["overflow"] == 0 and out["finetune"]["steps"] == 10
    assert out["finetune2"]["overflow"] == 0 and out["finetune2"]["lr"] == [1e-4, 3e-6]
    assert np.isfinite(out["finetune2"]["final_pixel_mse"])
    ess = out["ess"]
    assert ess["scores"]["psnr"] > 0 and 0 < ess["occupied_cells"] <= ess["total_cells"] == 64
    assert ess["budget"] % 8 == 0 and ess["kernel_check_max_abs_rgb"] <= distill.KERNEL_CHECK_MAX
    for k in ("teacher", "tiled", "ess_culled", "ess_tiled", "ess_fused_kernel", "ess_bucketed"):
        assert out["latency_ms"][k] > 0
    assert set(out["latency_ms"]["ess_tile_sweep"]) == {"16"}
    # the distilled field tracks the teacher on this tiny scene
    assert out["distill_gap"]["mse"] < 0.15
    for fname in ("field.npz", "field_ft.npz", "field_ft2.npz", "teacher_render.npz",
                  "field.npz.scores.json"):
        assert os.path.exists(os.path.join(out_dir, fname)), fname
    field = ex.load_field(os.path.join(out_dir, "field_ft2.npz"))
    assert field.grid == 4 and tuple(field.experts.w0.shape) == (64, 24, 8)


def test_a_rerun_resumes_fields_and_caches_and_recomputes_a_cache_that_does_not_load(
        static_setup, static_out, capsys):
    ds, run_dir, _ = static_setup
    out, out_dir = static_out
    with open(os.path.join(out_dir, "teacher_render.npz"), "r+b") as fh:
        fh.truncate(40)                                  # a write that was cut
    with open(os.path.join(out_dir, "field_ft.npz.scores.json"), "w") as fh:
        fh.write('{"scores": {"mse"')
    capsys.readouterr()
    again = distill.main(_distill_argv(run_dir, ds, out_dir, ["--finetune2_steps=6"]))
    said = capsys.readouterr().out
    assert said.count("resumed field from") == 3
    assert "teacher_render.npz does not load" in said
    assert "field_ft.npz.scores.json does not load" in said
    assert "scores cached" in said and "distill step" not in said
    assert again["finetune"]["resumed"] and again["distill_seconds"] == 0.0
    # the teacher render was truncated above, so it alone is recomputed
    assert again["resumed"] == {"field": True, "teacher_render": False}
    assert again["distill_loss_history"] == [] and again["finetune2"]["loss_history"] == []
    for leg in ("teacher", "distilled"):
        assert again[leg]["psnr"] == pytest.approx(out[leg]["psnr"], abs=1e-4)
    assert again["finetune"]["scores"]["psnr"] == pytest.approx(
        out["finetune"]["scores"]["psnr"], abs=1e-4)
    assert not [f for f in os.listdir(out_dir) if ".tmp" in f]
    # another geometry refits instead of resuming
    refit = distill.main(_distill_argv(run_dir, ds, out_dir,
                                       ["--hidden=4", "--finetune_steps=0", "--ess=0"]))
    assert "does not match this run" in capsys.readouterr().out
    assert refit["distill_seconds"] > 0 and refit["ess"] is None and refit["finetune"] is None


def test_distill_ray_cull_head_to_head(static_setup, static_out):
    """The field's cell occupancy selects foreground rays; background rays are
    exactly the skip-routed (zero-raw) rays of the full render, so the culled
    ESS render scores within noise of the full one."""
    ds, run_dir, root = static_setup
    out_dir = os.path.join(root, "distill_rc")
    out = distill.main(_distill_argv(run_dir, ds, out_dir, ["--ray_cull=1"]))
    rc = out["ray_cull"]
    for k in ("teacher_rc", "ess_rc", "ess_rc_kernel"):
        assert rc["latency_ms"][k] > 0
    assert 0 < rc["worst_fg"] <= rc["rays_per_view"] == 144
    assert rc["stream"] % 72 == 0 and rc["stream"] >= 72 and rc["budget"] > 0
    assert abs(rc["scores"]["psnr"] - out["ess"]["scores"]["psnr"]) < 0.3


def test_distill_pose_conditioned_append(append_setup):
    """Per-pose baking: an append_smpl_params run distills at one pose and is
    scored only against same-pose views."""
    ds, run_dir, root = append_setup
    out_dir = os.path.join(root, "distill_pose")
    out = distill.main(_distill_argv(run_dir, ds, out_dir, ["--pose_image=0", "--images=0"]))
    assert out["pose_image"] == 0 and out["pose_views_scored"] >= 1
    # plumbing smoke: a 3-epoch toy teacher distilled for 40 steps only roughly tracks
    assert out["distill_gap"]["mse"] < 0.5
    with open(os.path.join(out_dir, "scores.json")) as fh:
        assert json.load(fh)["model_type"] == "append_smpl_params"


def test_append_teacher_requires_pose(append_setup):
    _, run_dir, _ = append_setup
    with pytest.raises(ValueError, match="pose_image"):
        distill.build_teacher(run_dir, device="cpu")


def test_distill_rejects_warp_families(tmp_path):
    ds = str(tmp_path / "ds")
    _make_dataset(ds)
    run_dir = _train_run(str(tmp_path), ds, "smpl_nerf",
                         extra=["--netwidth_warp=8", "--number_frequencies_pose=2",
                                "--num_epochs=1", "--steps_per_epoch=2"])
    with pytest.raises(ValueError, match="per-pose"):
        distill.build_teacher(run_dir, device="cpu")


def test_host_side_sizing_matches_the_jax_tool_exactly(append_setup, rng):
    ds, _, _ = append_setup
    split = os.path.join(ds, "val")
    got, want = datasets.load_dataset(split, "nerf"), jax_datasets.load_dataset(split, "nerf", None)
    lo, hi = np.float32([-0.6, -0.9, -0.5]), np.float32([0.6, 0.8, 0.5])
    z = np.linspace(1.0, 4.0, 8, dtype=np.float32)
    occ = rng.uniform(size=64) < 0.5
    for occupied in (None, occ):
        for tile in (8, 32):
            assert (distill.tiled_budget(got, lo, hi, 4, z, 72, tile, occupied)
                    == jax_tool.tiled_budget(want, lo, hi, 4, z, 72, tile, occupied))
        assert (distill.max_bucket_count(got, lo, hi, 4, z, 72, occupied)
                == jax_tool.max_bucket_count(want, lo, hi, 4, z, 72, occupied))
        for a, b in zip(distill._chunk_counts(got, lo, hi, 4, z, 72, occupied),
                        jax_tool._chunk_counts(want, lo, hi, 4, z, 72, occupied)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(distill.ray_fg_masks(got, lo, hi, 4, z, occ),
                    jax_tool.ray_fg_masks(want, lo, hi, 4, z, occ)):
        np.testing.assert_array_equal(a, b)
    pose = got.human_poses[0]
    got_f, want_f = copy.deepcopy(got), copy.deepcopy(want)
    assert distill.filter_images_by_pose(got_f, pose) == jax_tool.filter_images_by_pose(want_f,
                                                                                        pose)
    np.testing.assert_array_equal(got_f.origins, want_f.origins)
    np.testing.assert_array_equal(got_f.image_indices, want_f.image_indices)
    assert got_f.num_images == want_f.num_images < got.num_images
    with pytest.raises(ValueError, match="no images"):
        distill.filter_images_by_pose(copy.deepcopy(got), pose + 1.0)


def test_the_root_shim_defaults_to_the_card_and_raises_without_one(static_setup, tmp_path):
    ds, run_dir, _ = static_setup
    argv = [a for a in _distill_argv(run_dir, ds, str(tmp_path / "out")) if a != "--device=cpu"]
    assert distill.arg_parser().parse_args(argv).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    done = subprocess.run([sys.executable, os.path.join(REPO, "distill_torch.py"), *argv],
                          cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "CUDA" in done.stderr
