"""The port's inference entry point, scores and image files against the JAX package.

`evaluation/scores.py` (rlpips on the seeded untrained VGG16, lpips on a
weights file with linear heads, print_scores), `data/gif.py`,
`cli/inference.py` (`save_rerenders`, `inference` with its scores.json at
--inf_fast 0, 1 and 2, `inference_gif`'s frame order) and the original_nerf
loader, each against its JAX counterpart. Run directories are written by the
JAX package (`save_run` + `export_torch_run`) with the small nets of
tests/test_torch_port_slice.py; datasets hold 32x32 views (rlpips needs 32
px a side); the port runs with --device cpu.

Tolerances: scores within 1e-4 relative (the port and JAX renders differ by
float rounding, up to 2e-3 on a pixel where a fine sample flips an
inverse-CDF bin); PNG pixels exactly; GIF pixels exactly the palette entry
of each pixel's nearest levels, which lies within the encoder's stated
per-channel error.
"""
import _torch_threads  # noqa: F401

import json
import os
import shutil

import cv2
import imageio.v3 as iio
import numpy as np
import pytest

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.cli import inference as jax_inference
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.evaluation import scores as jax_scores
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import datasets, gif
from smpl_nerf_tpu_torch.evaluation import scores
from tests.test_torch_port_slice import _argv, _jax_params

RES = 32
REL = 1e-4


def _pair_images(rng, shape):
    x = rng.uniform(0, 1, shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    return x, y


# ------------------------------------------------------------------ scores

@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 48, 40, 3)])
def test_rlpips_matches_jax(rng, shape):
    x, y = _pair_images(rng, shape)
    want = jax_scores.rlpips(x, y)
    assert scores.rlpips(x, y) == pytest.approx(want, rel=REL)
    assert scores.rlpips(x, x) == 0.0


def test_vgg_weights_are_the_jax_draws():
    want = jax_scores.Vgg16Features.random(3).weights
    got = scores.Vgg16Features.random(3).weights
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


def test_lpips_with_linear_heads_matches_jax(rng, tmp_path):
    path = str(tmp_path / "lpips_vgg16.npz")
    weights = {k: np.asarray(v) for k, v in jax_scores.Vgg16Features.random(5).weights.items()}
    for j, c in enumerate((64, 128, 256, 512, 512)):
        weights[f"lin{j}_weight"] = rng.uniform(0, 1, c).astype(np.float32)
    np.savez(path, **weights)
    x, y = _pair_images(rng, (2, 32, 32, 3))
    want = jax_scores.lpips(x, y, path)
    assert scores.lpips(x, y, path) == pytest.approx(want, rel=REL)
    assert scores.lpips(x, y, str(tmp_path / "absent.npz")) is None


@pytest.mark.parametrize("size,no_rlpips", [(32, False), (32, True), (16, False)])
def test_print_scores_gives_jax_keys_and_values(rng, capsys, monkeypatch, size, no_rlpips):
    if no_rlpips:
        monkeypatch.setenv("SMPL_NERF_TPU_NO_RLPIPS", "1")
    x, y = _pair_images(rng, (2, size, size, 3))
    want = jax_scores.print_scores(x, y)
    want_out = capsys.readouterr().out
    got = scores.print_scores(x, y)
    got_out = capsys.readouterr().out
    assert list(got) == list(want)
    assert ("rlpips" in got) is (size >= 32 and not no_rlpips)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=REL), key
    for why in ("rlpips skipped", "LPIPS skipped"):
        assert (why in got_out) is (why in want_out)


# ------------------------------------------------------------- files

def test_save_rerenders_pngs_decode_to_jax_pixels(rng, tmp_path):
    images = rng.uniform(-0.1, 1.1, (3, 9, 7, 3)).astype(np.float32)
    jax_inference.save_rerenders(images, str(tmp_path / "jax"))
    inference.save_rerenders(images, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    for i in range(3):
        name = f"img_{i:03d}.png"
        np.testing.assert_array_equal(iio.imread(tmp_path / "port" / name),
                                      iio.imread(tmp_path / "jax" / name))


@pytest.mark.parametrize("h,w,n", [(9, 7, 3), (96, 80, 2), (1, 1, 1)])
def test_gif_reads_back_with_the_stated_palette_error(rng, tmp_path, h, w, n):
    frames = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for _ in range(n)]
    if h > 50:
        frames[1][: h // 2] = 255        # long runs and a random half: table resets
    path = str(tmp_path / "x.gif")
    gif.write_gif(path, frames)
    back = iio.imread(path, index=None)
    assert back.shape == (n, h, w, 3)
    for got, frame in zip(back, frames):
        np.testing.assert_array_equal(got, gif.palette()[gif.quantize(frame)])
        err = np.abs(got.astype(int) - frame.astype(int)).reshape(-1, 3).max(0)
        assert (err <= np.asarray(gif.MAX_CHANNEL_ERROR)).all()
    meta = iio.immeta(path)
    assert meta["duration"] == 100 and meta["loop"] == 0


def test_gif_error_bound_is_tight():
    values = np.arange(256, dtype=np.uint8)
    frame = np.stack([values] * 3, -1)[None]
    err = np.abs(gif.palette()[gif.quantize(frame)].astype(int) - frame).max((0, 1))
    assert tuple(err) == gif.MAX_CHANNEL_ERROR


# --------------------------------------------------- datasets and run dirs

def _write_split(rng, directory, n, with_pose):
    cams, _ = cameras.get_circle_poses(-90, 90, n, 2.4)
    images = rng.uniform(0.6, 1.0, (n, RES, RES, 3)).astype(np.float32)
    poses = None
    if with_pose:
        poses = np.zeros((n, 69), np.float32)
        poses[:, [38, 41]] = rng.uniform(-0.5, 0.5, (n, 2))
    datasets.write_dataset(directory, images, cams, np.pi / 3, poses)


def _write_blender_split(rng, directory, n):
    """The Blender NeRF schema: RGBA PNGs named by frames[i].file_path."""
    os.makedirs(directory, exist_ok=True)
    cams, _ = cameras.get_circle_poses(-90, 90, n, 2.4)
    frames = []
    for i in range(n):
        image = rng.randint(0, 256, (RES, RES, 4)).astype(np.uint8)
        cv2.imwrite(os.path.join(directory, f"r_{i}.png"), image)
        frames.append({"file_path": f"./val/r_{i}", "transform_matrix": cams[i].tolist()})
    with open(os.path.join(directory, "transforms.json"), "w") as fh:
        json.dump({"camera_angle_x": np.pi / 3, "frames": frames[::-1]}, fh)


def test_original_nerf_loader_matches_jax(rng, tmp_path):
    split = str(tmp_path / "val")
    _write_blender_split(rng, split, 3)
    got = datasets.load_dataset(split, "original_nerf")
    want = jax_datasets.load_dataset(split, "original_nerf")
    for key in ("origins", "directions", "rgb", "image_indices", "camera_transforms"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert (got.h, got.w, got.focal, got.num_images) == (want.h, want.w, want.focal,
                                                         want.num_images)


def _jax_run(tmp_path, model_type, *extra):
    parser = jax_config.config_parser()
    args = parser.parse_args(_argv(model_type, white_background=1, extra=extra))
    _, params, _ = _jax_params(args, seed=21)
    run_dir = str(tmp_path / "run")
    jax_checkpoints.save_run(run_dir, params, args, parser)
    jax_checkpoints.export_torch_run(run_dir, run_dir)
    return run_dir


@pytest.mark.parametrize("model_type,fast", [("append_smpl_params", 0),
                                             ("append_smpl_params", 1),
                                             ("append_smpl_params", 2),
                                             ("original_nerf", 2)])
def test_inference_on_a_jax_run_dir_gives_jax_scores(rng, tmp_path, model_type, fast):
    val = str(tmp_path / "data" / "val")
    if model_type == "original_nerf":
        _write_blender_split(rng, val, 2)
    else:
        _write_split(rng, val, 2, with_pose=True)      # two poses: one grid per image
    run_dir = _jax_run(tmp_path, model_type)
    argv = [f"--inf_run_dir={run_dir}", f"--inf_ground_truth_dir={val}", "--inf_batchsize=256",
            f"--inf_fast={fast}"]
    want = jax_inference.inference(argv + [f"--inf_save_dir={tmp_path / 'jax'}"])
    got = inference.inference(argv + [f"--inf_save_dir={tmp_path / 'port'}", "--device=cpu"])
    assert list(got) == list(want) and "rlpips" in got
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=REL), key
    with open(tmp_path / "port" / "scores.json") as fh:
        port_json = json.load(fh)
    with open(tmp_path / "jax" / "scores.json") as fh:
        jax_json = json.load(fh)
    assert list(port_json) == list(jax_json)
    assert port_json["fast"] == fast and port_json["run_dir"] == run_dir
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_inference_gif_keeps_the_jax_frame_order(rng, tmp_path):
    data_dir = tmp_path / "data"
    _write_split(rng, str(data_dir / "train"), 3, with_pose=True)
    _write_split(rng, str(data_dir / "val"), 2, with_pose=True)
    run_dir = _jax_run(tmp_path, "append_smpl_params")
    with open(os.path.join(run_dir, "create_dataset_config.txt"), "w") as fh:
        fh.write("train_index = [4, 0, 2]\nval_index = [1, 3]\n")
    port_dir = str(tmp_path / "port_run")
    shutil.copytree(run_dir, port_dir)
    jargs, _, _ = jax_inference.setup_from_run_dir(run_dir)
    want = jax_inference.inference_gif(
        run_dir, jargs, *(jax_datasets.load_dataset(str(data_dir / s), jargs.model_type, jargs)
                          for s in ("train", "val")))
    args = inference.setup_from_run_dir(port_dir)
    got = inference.inference_gif(
        port_dir, args, *(datasets.load_dataset(str(data_dir / s), args.model_type)
                          for s in ("train", "val")), device="cpu")
    np.testing.assert_allclose(got, want, atol=2e-3)
    # frame i is dataset image i: train holds 4, 0, 2 and val 1, 3
    order = np.argsort([4, 0, 2, 1, 3])
    plain = np.concatenate([inference.render_dataset(args, port_dir, datasets.load_dataset(
        str(data_dir / s), args.model_type), device="cpu") for s in ("train", "val")])
    np.testing.assert_array_equal(got, plain[order])
    frames = iio.imread(os.path.join(port_dir, "inference.gif"), index=None)
    assert frames.shape == (5, RES, RES, 3)
    rgb8 = (np.clip(got, 0, 1) * 255).astype(np.uint8)[..., ::-1]
    for i in range(5):
        np.testing.assert_array_equal(iio.imread(os.path.join(port_dir, f"img_{i:03d}.png")),
                                      rgb8[i])
    assert os.path.exists(os.path.join(run_dir, "walking.gif"))


def test_setup_from_run_dir_refuses_the_vertex_families(tmp_path):
    """No family is refused: vertex_sphere, like the SMPL-driven families, gets
    the procedural human, as JAX's setup gives it; smpl and warp set up without
    one; smpl_estimator sets up (as in JAX) but has no render pipeline to
    render with."""
    run_dir = _jax_run(tmp_path, "nerf")
    assert inference.setup_from_run_dir(run_dir).model_type == "nerf"
    for model_type in ("smpl", "warp", "smpl_estimator"):
        args = inference.setup_from_run_dir(run_dir, model_type)
        _, jextras, _ = jax_inference.setup_from_run_dir(run_dir, model_type)
        assert args.model_type == model_type and jextras == {}
        assert getattr(args, "_smpl_model", None) is None
    with pytest.raises(ValueError, match="no render pipeline"):
        inference.render_dataset(inference.setup_from_run_dir(run_dir, "smpl_estimator"),
                                 run_dir, None, device="cpu")
    for model_type in ("vertex_sphere", "dummy_dynamic", "image_wise_dynamic",
                       "append_vertex_locations_to_nerf"):
        args = inference.setup_from_run_dir(run_dir, model_type)
        _, jextras, _ = jax_inference.setup_from_run_dir(run_dir, model_type)
        assert args._smpl_model.num_vertices == jextras["num_vertices"] == 3120
