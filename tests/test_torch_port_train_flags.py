"""The port's training flags and per-epoch logging against the JAX package.

`--check_nans` (`solver.nan_report` against JAX's report on the same
non-finite leaves; the epoch check through the CLI), `--profile_dir` (a
Chrome trace of the training that names the program's spans), the logging module (the rerender grid's
panels against the arrays JAX's matplotlib figure is drawn from, the
vedo_data files against JAX's), and the solver's logging through a writer.
Sizes: a 4x4 or 8x8 two-view dataset, one or two steps of 2x16 nets.
"""
import _torch_threads  # noqa: F401

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from smpl_nerf_tpu.training import logging as jax_log
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.training import checkpoints, factory
from smpl_nerf_tpu_torch.training import logging as log_mod
from smpl_nerf_tpu_torch.training import solver


class RecordingWriter:
    def __init__(self):
        self.scalars, self.images, self.meshes = [], [], []
        self.closed = False

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), step))

    def add_image(self, tag, img, step, dataformats="HWC"):
        self.images.append((tag, np.asarray(img), step, dataformats))

    def add_mesh(self, tag, vertices=None, colors=None, global_step=None):
        self.meshes.append((tag, np.asarray(vertices).shape, global_step))

    def close(self):
        self.closed = True


def _dataset(rng, root, res=4, posed=False):
    cams = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cams[:, 2, 3] = 3.0
    poses = rng.uniform(-0.3, 0.3, (2, 69)).astype(np.float32) if posed else None
    for split in ("train", "val"):
        images = rng.uniform(0, 1, (2, res, res, 3)).astype(np.float32)
        datasets.write_dataset(os.path.join(root, split), images, cams, np.pi / 3, poses)
    return root


def _argv(data_dir, *extra, model_type="nerf"):
    return ["--config=/dev/null", f"--model_type={model_type}", f"--dataset_dir={data_dir}",
            "--num_epochs=1", "--steps_per_epoch=2", "--batchsize=16", "--batchsize_val=64",
            "--number_coarse_samples=4", "--number_fine_samples=4", "--run_fine=1",
            "--netdepth=2", "--netwidth=16", "--netdepth_fine=2", "--netwidth_fine=16",
            "--netwidth_warp=8", "--number_frequencies_postitional=2",
            "--number_frequencies_directional=1", "--number_frequencies_pose=1",
            "--use_pallas=0", "--sigma_noise_std=0", "--render_gif=0",
            "--number_validation_images=0", *extra]


# ------------------------------------------------------------------ check_nans

def _counts(report):
    """{(n_nan, n_inf, size)} of a report's lines."""
    return sorted(tuple(int(v) for v in m) for m in
                  re.findall(r": (\d+) NaN, (\d+) Inf of (\d+)", report))


def test_nan_report_counts_what_jax_counts(rng):
    args = port_config.config_parser().parse_args(_argv("unused"))
    models, _ = factory.build_models_and_params(args, device="cpu")
    tree = {name: {"params": {}} for name in ("model_coarse", "model_fine")}
    for name in tree:
        for key, p in models[name].state_dict().items():
            layer, leaf = key.rsplit(".", 1)
            flax_layer = layer.replace(".", "_")
            flax_leaf = "kernel" if leaf == "weight" else leaf
            value = p.numpy().T.copy() if leaf == "weight" else p.numpy().copy()
            tree[name]["params"].setdefault(flax_layer, {})[flax_leaf] = value
    assert solver.nan_report(models) == "" == jax_solver.nan_report(tree)
    coarse = tree["model_coarse"]["params"]
    coarse["positional_net_0"]["kernel"].reshape(-1)[[0, 3, 7]] = np.nan
    coarse["rgb_out_layer"]["bias"][1] = np.inf
    tree["model_fine"]["params"]["sigma_out_layer"]["kernel"][:2] = [[np.nan], [-np.inf]]
    for name, sd in checkpoints.params_from_jax(tree).items():
        models[name].load_state_dict(sd)
    got, want = solver.nan_report(models), jax_solver.nan_report(tree)
    assert _counts(got) == _counts(want) == [(0, 1, 3), (1, 1, 16), (3, 0, 256)]
    assert "model_coarse/positional_net.0.weight: 3 NaN, 0 Inf of 256" in got
    assert "model_fine/sigma_out_layer.weight: 1 NaN, 1 Inf of 16" in got


@pytest.mark.parametrize("check_nans", [1, 0])
def test_check_nans_raises_naming_the_non_finite_parameter(rng, tmp_path, check_nans):
    data_dir = _dataset(rng, str(tmp_path / "data"))
    args = port_config.config_parser().parse_args(_argv(data_dir))
    models, _ = factory.build_models_and_params(args, device="cpu")
    sds = {k: m.state_dict() for k, m in models.items()}
    sds["model_coarse"]["positional_net.0.weight"][0, 0] = float("nan")
    checkpoints.save_run(str(tmp_path / "nan_run"), sds)
    argv = _argv(data_dir, f"--check_nans={check_nans}", f"--load_run={tmp_path / 'nan_run'}")
    if check_nans:
        with pytest.raises(RuntimeError, match=r"non-finite train loss nan at epoch 0; "
                                               r"non-finite params:\n(.*\n)*.*model_coarse/"
                                               r"positional_net.0.weight: \d+ NaN"):
            train_cli.train(argv, log_dir=str(tmp_path / "run"), device="cpu",
                            writer=RecordingWriter())
    else:
        sol = train_cli.train(argv, log_dir=str(tmp_path / "run"), device="cpu",
                              writer=RecordingWriter())
        assert np.isnan(sol.history["train_loss"][0])


def test_check_nans_passes_finite_runs_and_says_when_params_stay_finite(rng, tmp_path,
                                                                        monkeypatch):
    data_dir = _dataset(rng, str(tmp_path / "data"))
    sol = train_cli.train(_argv(data_dir, "--check_nans=1"), log_dir=str(tmp_path / "ok"),
                          device="cpu", writer=RecordingWriter())
    assert np.isfinite(sol.history["train_loss"]).all()
    monkeypatch.setattr(solver.Solver, "train_step",
                        lambda self, batch, gen=None: {"loss": torch.tensor(float("nan"))})
    with pytest.raises(RuntimeError, match=r"params still finite - NaN originated in the loss"):
        train_cli.train(_argv(data_dir, "--check_nans=1"), log_dir=str(tmp_path / "nan"),
                        device="cpu", writer=RecordingWriter())


# ----------------------------------------------------------------- profile_dir

def test_profile_dir_writes_a_chrome_trace_of_the_training(rng, tmp_path):
    data_dir = _dataset(rng, str(tmp_path / "data"))
    prof_dir = tmp_path / "prof"
    train_cli.train(_argv(data_dir, f"--profile_dir={prof_dir}"), log_dir=str(tmp_path / "run"),
                    device="cpu", writer=RecordingWriter())
    with open(prof_dir / train_cli.TRACE_FILE) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("linear" in n or "addmm" in n or "matmul" in n for n in names)
    assert any("Optimizer.step" in n for n in names)
    assert {"solver.step", "pass.net"} <= names


# --------------------------------------------------------------------- writer

def test_train_makes_a_writer_where_tensorboard_imports_and_closes_it(rng, tmp_path,
                                                                      monkeypatch):
    data_dir = _dataset(rng, str(tmp_path / "data"))
    made = []

    def recording(log_dir):
        made.append((log_dir, RecordingWriter()))
        return made[-1][1]

    monkeypatch.setattr(train_cli, "summary_writer", recording)
    log_dir = str(tmp_path / "run")
    train_cli.train(_argv(data_dir), log_dir=log_dir, device="cpu")
    (where, writer), = made
    assert where == log_dir and writer.closed
    assert [t for t, _, _ in writer.scalars] == ["loss/train", "loss/val", "perf/rays_per_sec"]
    passed = RecordingWriter()
    train_cli.train(_argv(data_dir), log_dir=log_dir, device="cpu", writer=passed)
    assert len(made) == 1 and not passed.closed and len(passed.scalars) == 3


def test_summary_writer_is_none_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_cli.summary_writer(str(tmp_path)) is None


# --------------------------------------------------------------------- logging

@pytest.fixture
def jax_imshow(monkeypatch):
    """The arrays JAX's tensorboard_rerenders hands to matplotlib's imshow."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib.axes import Axes

    shown = []
    original = Axes.imshow

    def record(self, X, *args, **kwargs):
        shown.append(np.asarray(X))
        return original(self, X, *args, **kwargs)

    monkeypatch.setattr(Axes, "imshow", record)
    return shown


@pytest.mark.parametrize("warps", [None, "magnitude", "vectors"])
def test_rerender_grid_panels_are_the_arrays_jax_shows(rng, jax_imshow, warps):
    n, h, w = 2, 6, 5
    renders = rng.uniform(-0.1, 1.1, (n, h, w, 3)).astype(np.float32)
    gts = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    ray_warps = {None: None, "magnitude": rng.uniform(0, 0.2, (n, h, w)).astype(np.float32),
                 "vectors": rng.randn(n, h, w, 3).astype(np.float32)}[warps]
    jax_log.tensorboard_rerenders(RecordingWriter(), n, renders, gts, 3, ray_warps)
    writer = RecordingWriter()
    grid = log_mod.tensorboard_rerenders(writer, n, renders, gts, 3, ray_warps)
    rows = log_mod.rerender_panels(n, renders, gts, ray_warps)
    cols = 2 if warps is None else 3
    assert len(jax_imshow) == n * cols and [len(r) for r in rows] == [cols] * n
    for i in range(n):
        for j in range(cols):
            want = jax_imshow[i * cols + j]
            got = rows[i][j]
            if j == 2:                       # JAX colour-maps the magnitude; the port greys it
                want = want / want.max()
                got = got[..., 0]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            np.testing.assert_array_equal(grid[i * h:(i + 1) * h, j * w:(j + 1) * w], rows[i][j])
    (tag, img, step, fmt), = writer.images
    assert (tag, step, fmt) == ("val/rerenders", 3, "HWC") and img.shape == (n * h, cols * w, 3)
    assert img.dtype == np.float32 and 0.0 <= img.min() and img.max() <= 1.0


@pytest.mark.parametrize("with_warps", [False, True])
def test_vedo_data_files_match_jax(rng, tmp_path, with_warps):
    dens = rng.rand(10, 4).astype(np.float32)
    samples = rng.rand(10, 4, 3).astype(np.float32)
    warps = rng.rand(10, 4, 3).astype(np.float32) if with_warps else None
    jax_log.vedo_data(str(tmp_path / "jax"), dens, samples, warps, epoch=2, image_idx=1)
    path = log_mod.vedo_data(str(tmp_path / "port"), dens, samples, warps, epoch=2, image_idx=1)
    assert path == str(tmp_path / "port" / "vedo_data" / "epoch_2_img_1.npz")
    want = np.load(tmp_path / "jax" / "vedo_data" / "epoch_2_img_1.npz")
    got = np.load(path)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        np.testing.assert_array_equal(got[key], want[key])


def test_tensorboard_warps_logs_a_coloured_cloud(rng):
    writer = RecordingWriter()
    log_mod.tensorboard_warps(writer, 4, rng.rand(5, 3, 3), rng.rand(5, 3, 3))
    assert writer.meshes == [("warp_cloud", (1, 15, 3), 4)]
    log_mod.tensorboard_warps(object(), 4, rng.rand(5, 3), rng.rand(5, 3))    # no add_mesh


@pytest.mark.parametrize("model_type", ["nerf", "smpl_nerf"])
def test_solver_logs_rerenders_and_vedo_data_every_epoch(rng, tmp_path, model_type):
    data_dir = _dataset(rng, str(tmp_path / "data"), res=8, posed=model_type != "nerf")
    writer = RecordingWriter()
    log_dir = str(tmp_path / "run")
    sol = train_cli.train(_argv(data_dir, "--num_epochs=2", "--number_validation_images=2",
                                "--mesh_epochs=0.5", model_type=model_type),
                          log_dir=log_dir, device="cpu", writer=writer)
    cols = 3 if model_type == "smpl_nerf" else 2
    assert [(tag, img.shape, step) for tag, img, step, _ in writer.images] == [
        ("val/rerenders", (16, 8 * cols, 3), 2), ("val/rerenders", (16, 8 * cols, 3), 4)]
    tags = [t for t, _, _ in writer.scalars]
    assert tags == ["loss/train", "loss/val", "perf/rays_per_sec"] * 2
    assert writer.scalars[0][1] == pytest.approx(sol.history["train_loss"][0])
    # the ground-truth panels are the val split's images, BGR flipped to RGB
    val = datasets.load_dataset(os.path.join(data_dir, "val"), model_type, device="cpu")
    grid = writer.images[0][1]
    for i in range(2):
        np.testing.assert_array_equal(grid[8 * i:8 * (i + 1), :8],
                                      val.rgb[64 * i:64 * (i + 1)].reshape(8, 8, 3)[..., ::-1])
    # warp families log the point cloud at --mesh_epochs 0.5 of 2 epochs: epoch 1;
    # the pipeline's samples of a ray are its 4 coarse and 4 fine ones
    assert writer.meshes == ([("warp_cloud", (1, 64 * 8, 3), 4)]
                             if model_type == "smpl_nerf" else [])
    for epoch in (0, 1):
        dump = np.load(os.path.join(log_dir, "vedo_data", f"epoch_{epoch}_img_0.npz"))
        assert sorted(dump.files) == ["densities", "density_samples"]
        assert dump["densities"].shape == (64 * 8,)
        assert dump["density_samples"].shape == (64 * 8, 3)
