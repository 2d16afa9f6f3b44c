"""The run directory and the training flags of the port against the JAX package.

`checkpoints.save_run` copies the dataset's create_dataset_config.txt into the
run directory as the JAX package's does (serving reads the frame order back
from it), byte for byte, and writes none where the dataset has none. The
parallel flags train at world 1: --mesh_shape=1 / 1,1 and --tensor_parallel=1
as a plain run, --multihost=1 in a world-1 gloo group, and a mesh larger than
the world raises JAX's make_mesh message. The model types once refused (smpl,
warp, vertex_sphere, smpl_estimator) train; `--render_gif` (on by default)
re-renders train + val into <run_dir>/inference.gif and img_XXX.png, and
nothing when it is 0. Sizes: a 4x4 two-view dataset, one or two steps of 2x16
nets.
"""
import _torch_threads  # noqa: F401

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


@pytest.mark.parametrize("flag", ["--mesh_shape=1", "--mesh_shape=1,1", "--tensor_parallel=1"])
def test_a_parallel_flag_trains_two_steps_at_world_1(rng, tmp_path, flag):
    """Without a process group the mesh is one device: each flag trains as a
    plain run does (the same two step losses)."""
    data_dir = _dataset(rng, str(tmp_path / "data"), False)
    plain = train_cli.train(_train_argv(data_dir, "--steps_per_epoch=2", "--render_gif=0"),
                            log_dir=str(tmp_path / "plain"), device="cpu")
    got = train_cli.train(_train_argv(data_dir, "--steps_per_epoch=2", "--render_gif=0", flag),
                          log_dir=str(tmp_path / "run"), device="cpu")
    assert (got.mesh.data, got.mesh.model, got.mesh.distributed) == (1, 1, False)
    assert len(got.history["step_loss"]) == 2
    assert got.history["step_loss"] == plain.history["step_loss"]
    assert os.path.exists(tmp_path / "run" / "model_coarse.pt")


def test_multihost_trains_two_steps_in_a_world_1_gloo_group(rng, tmp_path, monkeypatch):
    """--multihost=1 initialises the group from torchrun's environment (here a
    world of 1 on a loopback rendezvous) and trains on it: the mesh's
    collectives run, and the steps equal a plain run's."""
    import socket

    import torch.distributed as dist
    from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod

    data_dir = _dataset(rng, str(tmp_path / "data"), False)
    plain = train_cli.train(_train_argv(data_dir, "--steps_per_epoch=2", "--render_gif=0"),
                            log_dir=str(tmp_path / "plain"), device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for key, value in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, value)
    try:
        got = train_cli.train(_train_argv(data_dir, "--steps_per_epoch=2", "--render_gif=1",
                                          "--multihost=1"),
                              log_dir=str(tmp_path / "run"), device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert got.mesh.distributed and (got.mesh.data, got.mesh.model) == (1, 1)
    finally:
        mesh_mod.destroy()
    assert not dist.is_initialized()
    np.testing.assert_allclose(got.history["step_loss"], plain.history["step_loss"], rtol=1e-6)
    assert os.path.exists(tmp_path / "run" / "inference.gif")


@pytest.mark.parametrize("shape", ["4,2", "8"])
def test_a_mesh_larger_than_the_world_raises_the_make_mesh_message(rng, tmp_path, shape):
    from smpl_nerf_tpu.parallel import mesh as jax_mesh
    import jax

    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(shape, jax.devices()[:1])
    data_dir = _dataset(rng, str(tmp_path / "data"), False)
    with pytest.raises(ValueError) as got:
        train_cli.train(_train_argv(data_dir, f"--mesh_shape={shape}"),
                        log_dir=str(tmp_path / "run"), device="cpu")
    assert str(got.value) == str(want.value)


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
