"""The run directory and the training flags of the port against the JAX package.

`checkpoints.save_run` copies the dataset's create_dataset_config.txt into the
run directory as the JAX package's does (serving reads the frame order back
from it), byte for byte, and writes none where the dataset has none. The
training flags whose machinery is not ported raise, naming the flag, before
any data is loaded, as do the model types not ported yet (smpl, warp,
vertex_sphere, smpl_estimator); `--render_gif` (on by default) re-renders train + val into
<run_dir>/inference.gif and img_XXX.png, and nothing when it is 0. Sizes: a
4x4 two-view dataset, one step of 2x16 nets.
"""
import os

import imageio.v3 as iio
import numpy as np
import pytest

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.training import checkpoints

DATASET_CONFIG = "create_dataset_config.txt"
# what the JAX dataset tool writes there: its resolved flags, frame order included
DATASET_CONFIG_TEXT = ("save_dir = data/x\ndataset_type = nerf\nresolution = 4\n"
                       "camera_path = circle\nnumber_steps = 2\nsequence_skip = 4\n")


def _dataset(rng, root, with_config):
    cams = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cams[:, 2, 3] = 3.0
    for split in ("train", "val"):
        images = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
        datasets.write_dataset(os.path.join(root, split), images, cams, np.pi / 3)
    if with_config:
        with open(os.path.join(root, DATASET_CONFIG), "w") as fh:
            fh.write(DATASET_CONFIG_TEXT)
    return root


@pytest.mark.parametrize("with_config", [True, False])
@pytest.mark.parametrize("through", ["dataset_dir", "args"])
def test_save_run_copies_the_dataset_config_like_jax(rng, tmp_path, with_config, through):
    data_dir = _dataset(rng, str(tmp_path / "data"), with_config)
    argv = ["--config=/dev/null", "--model_type=nerf", f"--dataset_dir={data_dir}"]
    jparser, pparser = jax_config.config_parser(), port_config.config_parser()
    jargs, pargs = jparser.parse_args(argv), pparser.parse_args(argv)
    explicit = data_dir if through == "dataset_dir" else None
    jax_checkpoints.save_run(str(tmp_path / "jax_run"), {}, jargs, jparser, explicit)
    checkpoints.save_run(str(tmp_path / "port_run"), {}, pargs, pparser, explicit)
    copies = [tmp_path / run / DATASET_CONFIG for run in ("jax_run", "port_run")]
    if with_config:
        assert copies[0].read_bytes() == copies[1].read_bytes() == DATASET_CONFIG_TEXT.encode()
    else:
        assert not copies[0].exists() and not copies[1].exists()


def test_save_run_without_args_or_dataset_dir_copies_nothing(rng, tmp_path):
    _dataset(rng, str(tmp_path / "data"), True)
    checkpoints.save_run(str(tmp_path / "run"), {})
    assert os.listdir(tmp_path / "run") == []


def _train_argv(data_dir, *extra):
    return ["--config=/dev/null", "--model_type=nerf", f"--dataset_dir={data_dir}",
            "--num_epochs=1", "--steps_per_epoch=1", "--batchsize=16", "--batchsize_val=64",
            "--number_coarse_samples=4", "--number_fine_samples=4", "--run_fine=1",
            "--netdepth=2", "--netwidth=16", "--netdepth_fine=2", "--netwidth_fine=16",
            "--number_frequencies_postitional=2", "--number_frequencies_directional=1",
            "--use_pallas=0", "--sigma_noise_std=0", "--number_validation_images=0", *extra]


@pytest.mark.parametrize("render_gif", [1, 0])
def test_train_saves_the_dataset_config_and_says_the_gif_step_is_skipped(
        rng, tmp_path, render_gif):
    data_dir = _dataset(rng, str(tmp_path / "data"), True)
    log_dir = str(tmp_path / "run")
    train_cli.train(_train_argv(data_dir, f"--render_gif={render_gif}"), log_dir=log_dir,
                    device="cpu")
    with open(os.path.join(log_dir, DATASET_CONFIG)) as fh:
        assert fh.read() == DATASET_CONFIG_TEXT
    gif_path = os.path.join(log_dir, "inference.gif")
    pngs = sorted(n for n in os.listdir(log_dir) if n.endswith(".png"))
    if render_gif:
        # the 2 train + 2 val views, re-rendered after training
        assert iio.imread(gif_path, index=None).shape == (4, 4, 4, 3)
        assert pngs == [f"img_{i:03d}.png" for i in range(4)]
    else:
        assert not os.path.exists(gif_path) and pngs == []


@pytest.mark.parametrize("flag,value", [
    ("mesh_shape", "8"), ("tensor_parallel", "1"), ("mesh_shape", "4,2"), ("multihost", "1")])
def test_an_unported_flag_raises_before_any_data_is_loaded(tmp_path, monkeypatch, flag, value):
    def no_loading(*args, **kwargs):
        raise AssertionError("a dataset was loaded before the flag was refused")

    monkeypatch.setattr(datasets, "load_dataset", no_loading)
    argv = _train_argv(str(tmp_path / "no_such_dataset"), f"--{flag}={value}")
    with pytest.raises(NotImplementedError, match=f"--{flag} .*not ported yet"):
        train_cli.train(argv, log_dir=str(tmp_path / "run"), device="cpu")
    assert not (tmp_path / "run").exists()


def test_the_unported_flags_at_their_defaults_pass_the_guard():
    parser = port_config.config_parser()
    args = parser.parse_args(["--config=/dev/null", "--check_nans=0", "--images_per_batch=2",
                              "--use_gmm_loss=1", "--tensor_parallel=0", "--mesh_shape=",
                              "--multihost=0"])
    train_cli._refuse_unported_flags(args, parser)
    assert set(train_cli.UNPORTED_FLAGS) == {"tensor_parallel", "mesh_shape", "multihost"}


@pytest.mark.parametrize("model_type", ["smpl", "warp", "vertex_sphere", "smpl_estimator"])
def test_the_unported_families_raise_naming_themselves(tmp_path, model_type):
    """None of the four families raises any more: each trains through the CLI
    on a dataset the port generates, saves its run dir, and
    setup_from_run_dir reads that run back (vertex_sphere with the procedural
    human)."""
    from smpl_nerf_tpu_torch.cli import inference
    from smpl_nerf_tpu_torch.data import generate

    kind, res = {"smpl": ("smpl", 8), "warp": ("smpl", 8), "vertex_sphere": ("smpl_nerf", 8),
                 "smpl_estimator": ("smpl_nerf", 32)}[model_type]
    data_dir = str(tmp_path / "data")
    parser = port_config.dataset_config_parser()
    generate.create_dataset(parser.parse_args([
        f"--save_dir={data_dir}", f"--dataset_type={kind}", f"--resolution={res}",
        "--camera_path=circle", "--number_steps=2", "--multi_human_pose=1",
        "--human_number_steps=2"]), parser, device="cpu")
    run_dir = str(tmp_path / "run")
    train_cli.train(_train_argv(data_dir, f"--model_type={model_type}",
                                "--vertex_sphere_radius=0.1"), log_dir=run_dir, device="cpu")
    weights = "model_smpl_estimator.pt" if model_type == "smpl_estimator" else "model_coarse.pt"
    assert os.path.exists(os.path.join(run_dir, weights))
    args = inference.setup_from_run_dir(run_dir)
    assert args.model_type == model_type
    if model_type == "vertex_sphere":
        assert args._smpl_model.num_vertices == 3120
