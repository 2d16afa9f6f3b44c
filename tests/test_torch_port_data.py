"""The port's PNG reader/writer, dataset loader and CPU training recipe.

`data/png.py` takes cv2's place in the port (torch + numpy + standard library
only), so it is held against `cv2.imread` / `cv2.imwrite` byte for byte; the
loader and the batch gather are held against the JAX package's on the same
split directory; the small training recipe of the verify notes runs through
`train_torch.py --device cpu` on a dataset the JAX package generated.
"""
import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.data import generate as jax_generate
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch.cli import render_path
from smpl_nerf_tpu_torch.data import datasets, png
from smpl_nerf_tpu_torch.training import solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _image(rng, h, w, c):
    """Smooth gradients plus noise, so every filter type has something to predict."""
    yy, xx = np.mgrid[:h, :w]
    base = (3 * xx + 5 * yy)[..., None] + 40 * np.arange(c)
    return ((base + rng.randint(0, 30, (h, w, c))) % 256).astype(np.uint8)


# ----------------------------------------------------------------------- png

@pytest.mark.parametrize("filter_type", range(5))
def test_read_png_every_filter_type_matches_cv2_imread(rng, tmp_path, filter_type):
    image = _image(rng, 13, 17, 3)
    path = str(tmp_path / f"f{filter_type}.png")
    png.write_png(path, image, filter_type)
    with open(path, "rb") as fh:       # the file really uses that filter on every line
        data = fh.read()
    assert {line[0] for line in _scanlines(data, 13, 17 * 3)} == {filter_type}
    np.testing.assert_array_equal(png.read_png(path), image)
    np.testing.assert_array_equal(cv2.imread(path), image)      # BGR in, BGR out


def _scanlines(data, h, stride):
    import zlib
    pos, idat = 8, b""
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    return [raw[y * (stride + 1):(y + 1) * (stride + 1)] for y in range(h)]


@pytest.mark.parametrize("channels,flag", [(1, cv2.IMREAD_GRAYSCALE), (3, cv2.IMREAD_COLOR),
                                           (4, cv2.IMREAD_UNCHANGED)])
def test_read_png_of_cv2_written_grey_rgb_rgba_matches_cv2_imread(rng, tmp_path, channels,
                                                                  flag):
    image = _image(rng, 24, 31, channels)
    path = str(tmp_path / f"c{channels}.png")
    assert cv2.imwrite(path, image[..., 0] if channels == 1 else image)
    assert cv2.imread(path, flag).shape[2:] == ((channels,) if channels > 1 else ())
    want = cv2.imread(path)            # what the JAX loader sees: BGR, alpha dropped
    got = png.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (24, 31, 3)
    np.testing.assert_array_equal(got, want)


def test_write_png_is_read_back_by_cv2_as_bgr_and_refuses_bad_input(rng, tmp_path):
    image = _image(rng, 9, 7, 3)
    image[..., 0], image[..., 2] = 250, 5      # strongly blue in BGR
    path = str(tmp_path / "w.png")
    png.write_png(path, image)
    np.testing.assert_array_equal(cv2.imread(path), image)
    assert cv2.imread(path)[..., 0].mean() > 200    # channel 0 is still blue
    with pytest.raises(ValueError):
        png.write_png(path, image.astype(np.float32))
    with pytest.raises(ValueError):
        png.write_png(path, image, filter_type=7)
    cv2.imwrite(str(tmp_path / "deep.png"), image.astype(np.uint16) * 256)
    with pytest.raises(ValueError, match="8-bit"):
        png.read_png(str(tmp_path / "deep.png"))
    with open(path, "r+b") as fh:                 # a damaged file fails its CRC
        fh.seek(40)
        fh.write(b"\xff\xff")
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(path)


# -------------------------------------------------------------------- loader

def _write_split(rng, directory, n=3, res=6, with_pose=True):
    """A hand-written split: cv2-written PNGs and a transforms.json."""
    os.makedirs(directory)
    transforms = {"camera_angle_x": 0.9, "image_transform_map": {}}
    if with_pose:
        transforms.update(image_pose_map={}, betas=[0.0] * 10, expression=[0.0] * 10)
    for i in rng.permutation(n):                  # written out of order
        name = f"img_{i:03d}.png"
        cv2.imwrite(os.path.join(directory, name), _image(rng, res, res, 3))
        cam = np.eye(4, dtype=np.float32)
        cam[:3, 3] = rng.uniform(-1, 1, 3)
        cam[:3, :3] += 0.1 * rng.randn(3, 3).astype(np.float32)
        transforms["image_transform_map"][name] = cam.tolist()
        if with_pose:
            transforms["image_pose_map"][name] = rng.uniform(-1, 1, 69).tolist()
    with open(os.path.join(directory, "transforms.json"), "w") as fh:
        json.dump(transforms, fh)


@pytest.mark.parametrize("model_type,with_pose", [("nerf", False), ("smpl_nerf", True),
                                                  ("append_to_nerf", True),
                                                  ("append_smpl_params", True)])
def test_load_dataset_and_gather_batch_match_jax(rng, tmp_path, model_type, with_pose):
    split = str(tmp_path / "train")
    _write_split(rng, split, with_pose=with_pose)
    want = jax_datasets.load_dataset(split, model_type)
    got = datasets.load_dataset(split, model_type)
    for key in ("origins", "directions", "rgb", "image_indices", "camera_transforms"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)
    assert (got.h, got.w, got.num_images, got.num_rays) == (want.h, want.w, want.num_images,
                                                           want.num_rays)
    assert got.focal == pytest.approx(want.focal)
    if with_pose:
        np.testing.assert_array_equal(got.human_poses, want.human_poses)

    want_arrays = want.batch_arrays(model_type)
    got_arrays = got.batch_arrays(model_type)
    assert set(got_arrays) == set(want_arrays)
    idx = rng.randint(0, got.num_rays, 20)
    want_batch = jax_solver.gather_batch({k: jnp.asarray(v) for k, v in want_arrays.items()},
                                         jnp.asarray(idx))
    got_batch = solver.gather_batch({k: torch.as_tensor(v) for k, v in got_arrays.items()},
                                    torch.as_tensor(idx))
    assert set(got_batch) == set(want_batch)
    for key, value in want_batch.items():
        np.testing.assert_array_equal(got_batch[key].numpy(), np.asarray(value), err_msg=key)
    if with_pose:
        assert got_batch["human_pose"].shape == (20, 69)


def test_loader_refuses_what_is_not_ported_and_a_miscounted_split(rng, tmp_path):
    split = str(tmp_path / "train")
    _write_split(rng, split)
    for model_type in ("smpl", "vertex_sphere", "original_nerf", "smpl_estimator"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            datasets.load_dataset(split, model_type)
    cv2.imwrite(os.path.join(split, "stray.png"), _image(rng, 6, 6, 3))
    with pytest.raises(ValueError, match="number of images"):
        datasets.load_dataset(split, "nerf")


def test_write_dataset_round_trips_through_both_loaders(rng, tmp_path):
    images = rng.randint(0, 256, (2, 5, 5, 3)).astype(np.float32) / 255.0
    cams = np.stack([np.eye(4, dtype=np.float32)] * 2)
    poses = rng.uniform(-1, 1, (2, 69)).astype(np.float32)
    split = str(tmp_path / "val")
    datasets.write_dataset(split, images, cams, 1.0, poses)
    for loader in (datasets.load_dataset, jax_datasets.load_dataset):
        data = loader(split, "smpl_nerf")
        np.testing.assert_allclose(data.rgb.reshape(images.shape), images, atol=1e-6)
        np.testing.assert_allclose(data.human_poses, poses, atol=1e-6)


# ----------------------------------------------------- the CPU train recipe

def test_train_torch_cpu_recipe_loss_drops_and_the_run_renders(tmp_path):
    """The verify notes' small recipe (2 epochs, 2x32 nets, 8+8 samples) on a
    16x16 JAX-generated smpl_nerf dataset, through the root shim."""
    data_dir = str(tmp_path / "data")
    gparser = jax_config.dataset_config_parser()
    jax_generate.create_dataset(gparser.parse_args([
        f"--save_dir={data_dir}", "--dataset_type=smpl_nerf", "--resolution=16",
        "--camera_path=circle", "--number_steps=4", "--multi_human_pose=1",
        "--human_start_angle=0", "--human_end_angle=45", "--human_number_steps=2",
        "--train_val_ratio=0.75"]), gparser)
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run(
        [sys.executable, os.path.join(REPO, "train_torch.py"), "--device", "cpu",
         "--config=/dev/null", "--model_type=smpl_nerf", f"--dataset_dir={data_dir}",
         "--num_epochs=2", "--batchsize=512", "--batchsize_val=3000",
         "--number_coarse_samples=8", "--number_fine_samples=8", "--run_fine=1",
         "--sigma_noise_std=0", "--netdepth=2", "--netwidth=32", "--netdepth_fine=2",
         "--netwidth_fine=32", "--netwidth_warp=16", "--number_frequencies_postitional=4",
         "--number_frequencies_directional=2", "--number_frequencies_pose=2",
         "--human_pose_encoding=1", "--use_pallas=0", "--render_gif=0", "--lrate=2e-3",
         "--foreground_sample_ratio=0.5", "--number_validation_images=0",
         "--experiment_name=verify_x"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    (run_name,) = os.listdir(tmp_path / "runs")
    run_dir = str(tmp_path / "runs" / run_name)
    assert run_name.endswith("_verify_x")
    assert {"config.txt", "model_coarse.pt", "model_fine.pt", "model_warp_field.pt",
            "val_curve.json", "train_state.pt", "best"} <= set(os.listdir(run_dir))
    with open(os.path.join(run_dir, "val_curve.json")) as fh:
        curve = json.load(fh)
    assert [c["epoch"] for c in curve] == [0, 1]
    assert curve[1]["train_loss"] < curve[0]["train_loss"]
    assert all(np.isfinite(c["val_loss"]) for c in curve)
    views = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                              "--number_steps", "2", "--resolution", "8",
                              "--human_pose_angle", "20", "--out", str(tmp_path / "v.npy"),
                              "--device", "cpu"])
    assert views.shape == (2, 8, 8, 3) and np.isfinite(views).all()
