"""The PyTorch port's core ray math, config and package rules vs the JAX package.

Inputs come from a seeded numpy RandomState and go through the JAX function
and its port counterpart on the CPU (the port with device="cpu").
"""
import _torch_threads  # noqa: F401

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu.core import cameras as jax_cameras
from smpl_nerf_tpu.core import encoding as jax_encoding
from smpl_nerf_tpu.core import integrate as jax_integrate
from smpl_nerf_tpu.core import rays as jax_rays
from smpl_nerf_tpu.core import sampling as jax_sampling
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch._platform import resolve_device
from smpl_nerf_tpu_torch.core import cameras, encoding, integrate, rays, sampling
from smpl_nerf_tpu_torch.data import datasets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "smpl_nerf_tpu_torch")


def to_np(t):
    return t.detach().cpu().numpy()


# ------------------------------------------------------------------ encoding

@pytest.mark.parametrize("L,identity,atol", [(4, False, 1e-6), (2, True, 1e-6),
                                             (10, False, 2e-4)])
def test_positional_encoder_matches_jax(rng, L, identity, atol):
    # atol grows with 2^(L-1): sin/cos of large arguments round differently
    x = rng.uniform(-2, 2, (5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_encoding.PositionalEncoder(L, identity).encode(jnp.asarray(x)))
    enc = encoding.PositionalEncoder(L, identity)
    got = to_np(enc.encode(torch.from_numpy(x)))
    assert enc.output_dim == jax_encoding.PositionalEncoder(L, identity).output_dim
    np.testing.assert_allclose(got, want, atol=atol)


# ---------------------------------------------------------------- rays, cameras

def test_rays_match_jax(rng):
    cams = rng.randn(3, 4, 4).astype(np.float32)
    h, w, focal = 5, 6, rays.focal_from_fov(6, np.pi / 3)
    assert focal == jax_rays.focal_from_fov(6, np.pi / 3)
    o, d = rays.get_rays(h, w, focal, torch.from_numpy(cams[0]))
    jo, jd = jax_rays.get_rays(h, w, focal, cams[0])
    np.testing.assert_allclose(to_np(o), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(to_np(d), np.asarray(jd), atol=1e-5)
    ob, db = rays.get_rays_batch(h, w, focal, torch.from_numpy(cams))
    jo, jd = jax_rays.get_rays_batch(h, w, focal, cams)
    np.testing.assert_allclose(to_np(ob), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(to_np(db), np.asarray(jd), atol=1e-5)
    on, dn = rays.get_rays_batch_np(h, w, focal, cams)
    jo, jd = jax_rays.get_rays_batch_np(h, w, focal, cams)
    np.testing.assert_array_equal(on, jo)
    np.testing.assert_array_equal(dn, jd)


def test_rays_from_cameras_matches_jax():
    cams, _ = jax_cameras.get_circle_poses(-90, 90, 3, 2.4)
    want = jax_datasets.rays_from_cameras(cams, 6, 5, np.pi / 3)
    got = datasets.rays_from_cameras(cams, 6, 5, np.pi / 3)
    for name in ("origins", "directions", "image_indices", "camera_transforms"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.h, got.w, got.focal, got.num_images, got.num_rays) == \
        (want.h, want.w, want.focal, want.num_images, want.num_rays)


@pytest.mark.parametrize("path", ["circle", "sphere", "circle_on_sphere"])
def test_camera_paths_match_jax(path):
    if path == "circle":
        got, ga = cameras.get_circle_poses(-90, 90, 5, 2.4)
        want, wa = jax_cameras.get_circle_poses(-90, 90, 5, 2.4)
    elif path == "sphere":
        got, ga = cameras.get_sphere_poses(-60, 60, 3, 2.4)
        want, wa = jax_cameras.get_sphere_poses(-60, 60, 3, 2.4)
    else:
        got, ga = cameras.get_circle_on_sphere_poses(4, 10.0, 2.4, 5.0, -3.0)
        want, wa = jax_cameras.get_circle_on_sphere_poses(4, 10.0, 2.4, 5.0, -3.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ga, wa)


# ------------------------------------------------------------------ sampling

@pytest.mark.parametrize("S", [8, 64])
def test_coarse_sampling_eval_matches_jax(rng, S):
    o = rng.randn(6, 3).astype(np.float32)
    d = rng.randn(6, 3).astype(np.float32)
    js, jz = jax_sampling.coarse_sampling(jnp.asarray(o), jnp.asarray(d), 1.0, 4.0, S)
    ps, pz = sampling.coarse_sampling(torch.from_numpy(o), torch.from_numpy(d), 1.0, 4.0, S)
    np.testing.assert_allclose(to_np(pz), np.asarray(jz), rtol=1e-6)
    np.testing.assert_allclose(to_np(ps), np.asarray(js), atol=1e-5)


def test_coarse_sampling_jitter_is_one_per_ray(rng):
    o = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    d = torch.from_numpy(rng.randn(5, 3).astype(np.float32))
    g = torch.Generator().manual_seed(3)
    _, z = sampling.coarse_sampling(o, d, 1.0, 4.0, 8, g)
    _, zc = sampling.coarse_sampling(o, d, 1.0, 4.0, 8)
    assert not torch.allclose(z, zc)
    # one shared jitter per ray: z stays sorted inside its bins
    assert bool((z[:, 1:] >= z[:, :-1]).all())


def test_fine_u_is_linspace_to_the_last_bit():
    for F in (16, 128):
        u = to_np(sampling.fine_u(F))
        np.testing.assert_allclose(u, np.linspace(0, 1, F, dtype=np.float32), atol=1.2e-7)
        assert u[0] == 0.0 and abs(u[-1] - 1.0) < 1.2e-7


# ------------------------------------------------------------------ integrate

@pytest.mark.parametrize("per_sample_dirs,white", [(True, False), (False, True),
                                                   (True, True)])
def test_raw2outputs_matches_jax(rng, per_sample_dirs, white):
    R, S = 7, 12
    raw = rng.randn(R, S, 4).astype(np.float32)
    z = np.sort(rng.uniform(1, 4, (R, S)).astype(np.float32), -1)
    dirs = rng.randn(R, S, 3).astype(np.float32) if per_sample_dirs \
        else rng.randn(R, 3).astype(np.float32)
    want = jax_integrate.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(dirs),
                                     0.0, white)
    got = integrate.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                                torch.from_numpy(dirs), 0.0, white)
    for name in ("rgb", "weights", "density", "depth", "acc"):
        np.testing.assert_allclose(to_np(getattr(got, name)), np.asarray(getattr(want, name)),
                                   atol=2e-6, err_msg=name)


def test_raw2outputs_single_sample_matches_jax(rng):
    raw = rng.randn(5, 1, 4).astype(np.float32)
    z = rng.uniform(1, 4, (5, 1)).astype(np.float32)
    d = rng.randn(5, 3).astype(np.float32)
    want = jax_integrate.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d))
    got = integrate.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z), torch.from_numpy(d))
    np.testing.assert_allclose(to_np(got.rgb), np.asarray(want.rgb), atol=1e-6)


# -------------------------------------------------------------------- config

def test_config_parses_arm_angles_like_jax():
    path = os.path.join(REPO, "configs", "arm_angles.txt")
    want = vars(jax_config.config_parser().parse_args([f"--config={path}"]))
    got = vars(port_config.config_parser().parse_args([f"--config={path}"]))
    # the port's one key more than JAX's parser, --smpl_model_path, defaults to None
    assert {k: got[k] for k in want} == want and set(got) - set(want) == {"smpl_model_path"}
    assert got["smpl_model_path"] is None
    assert got["skips"] == [4] and got["human_joints"] == [41, 38]


def test_config_reads_a_jax_written_config_txt(tmp_path):
    parser = jax_config.config_parser()
    args = parser.parse_args(["--config=/dev/null", "--model_type=smpl_nerf", "--skips=4",
                              "--skips_fine=2", "--skips_fine=5", "--human_joints=38",
                              "--compute_dtype=bfloat16", "--use_fused_mlp=2"])
    path = str(tmp_path / "config.txt")
    parser.write_config_file(args, [path])
    got = vars(port_config.config_parser().parse_args([f"--config={path}"]))
    want = vars(parser.parse_args([f"--config={path}"]))
    assert {k: got[k] for k in want} == want and set(got) - set(want) == {"smpl_model_path"}
    assert got["smpl_model_path"] is None
    assert got["skips"] == [4] and got["skips_fine"] == [2, 5] and got["human_joints"] == [38]


# ------------------------------------------------------------ package rules

FORBIDDEN = ("jax", "flax", "cv2", "imageio", "optax", "smpl_nerf_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, n) for n in os.listdir(REPO)
             if n == "chip_smoke.py" or n.endswith("_torch.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_no_jax_flax_or_jax_package():
    bad = []
    for path in _port_files():
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert len(_port_files()) > 20
    assert not bad, bad


def test_port_entry_points_load_without_jax():
    code = ("import sys\n"
            "import smpl_nerf_tpu_torch.cli.render_path, smpl_nerf_tpu_torch.render.batched\n"
            "import smpl_nerf_tpu_torch.cli.inference, smpl_nerf_tpu_torch.render.fast\n"
            "import smpl_nerf_tpu_torch.ops.sample_pdf_cuda, smpl_nerf_tpu_torch.ops.fused_mlp_v2\n"
            "import smpl_nerf_tpu_torch.cli.train, smpl_nerf_tpu_torch.training.image_wise\n"
            "import smpl_nerf_tpu_torch.models.smpl, smpl_nerf_tpu_torch.core.gmm\n"
            "import smpl_nerf_tpu_torch.ops.vertex_attention, smpl_nerf_tpu_torch.ops.raymesh\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'smpl_nerf_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from smpl_nerf_tpu_torch.cli import inference, render_path
    from smpl_nerf_tpu_torch.cli.inference import render_dataset
    from smpl_nerf_tpu_torch.training import factory

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        render_dataset(None, str(tmp_path), None)
    parser = port_config.config_parser()
    args = parser.parse_args(["--config=/dev/null", "--model_type=nerf"])
    parser.write_config_file(args, [str(tmp_path / "config.txt")])
    with pytest.raises(RuntimeError, match="CUDA"):
        render_path.render_path(str(tmp_path), number_steps=1, resolution=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        factory.build_models_and_params(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.inference([f"--inf_run_dir={tmp_path}"])
    assert resolve_device("cpu") == torch.device("cpu")
