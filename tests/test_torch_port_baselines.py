"""The port's Table-1 baselines against the JAX package's.

Nearest neighbours (indices identical, the CLI's renders and files), the
silhouette pose fit (projection, chamfer, priors, the first losses of the
fit), the SMPLify max-mixture prior on a synthetic GMM, the depth -> RGB
U-Net (each convolution's padding and the transposed convolutions' kernel
flip against flax, the whole net and its loss gradient on carried-over
weights, the CLI on a tiny pair set) and the pix2pix evaluation CLI.

Tolerances: numpy code copied as is is held bit for bit; float32 torch
against float32 JAX on the same formulas to 1e-6 relative, except where a
chain of sums in another order lies between them: the fit's losses
(LBS, projection and Adam over 10 steps) to 1e-3 relative, the U-Net's 11
convolutions to 1e-4 absolute on outputs in (0, 1) and its loss gradient to
1e-4 by relative norm.
"""
import _torch_threads  # noqa: F401

import glob
import importlib.util
import json
import os
import pickle
import sys

import imageio.v3 as iio
import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from smpl_nerf_tpu.baselines import nearest_neighbors as jax_nn
from smpl_nerf_tpu.baselines import pose_priors as jax_priors
from smpl_nerf_tpu.baselines import silhouette_pose_fit as jax_fit
from smpl_nerf_tpu.core import cameras as jax_cameras
from smpl_nerf_tpu.evaluation import scores as jax_scores
from smpl_nerf_tpu.models import smpl as jax_smpl
from smpl_nerf_tpu_torch.baselines import nearest_neighbors as nn_mod
from smpl_nerf_tpu_torch.baselines import pose_priors, silhouette_pose_fit as fit
from smpl_nerf_tpu_torch.cli import baselines as baselines_cli
from smpl_nerf_tpu_torch.cli import evaluate_pix2pix, pix2pix
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import datasets, png
from smpl_nerf_tpu_torch.models import smpl as smpl_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-6
FIT_LOSS_REL = 1e-3
UNET_ATOL, UNET_GRAD_REL = 1e-4, 1e-4


def _sphere_cams(rng, n):
    return np.stack([cameras.get_sphere_pose(p, t, 2.4)
                     for p, t in rng.uniform(-60, 60, (n, 2))]).astype(np.float32)


def _jax_pix2pix():
    """tools/pix2pix_baseline.py's module (its import points JAX's compilation
    cache at a directory of its own, which is put back here)."""
    old = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "pix2pix_baseline", os.path.join(REPO, "tools", "pix2pix_baseline.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod              # flax's dataclass transform looks it up
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    return mod


# ------------------------------------------------------------ nearest neighbours

def test_nearest_neighbour_indices_are_jax_s(rng):
    train, query = _sphere_cams(rng, 12), _sphere_cams(rng, 7)
    for c in train[:3]:
        np.testing.assert_array_equal(cameras.get_xyzphitheta(c),
                                      jax_cameras.get_xyzphitheta(c))
    tp, qp = rng.uniform(-1, 1, (12, 69)), rng.uniform(-1, 1, (7, 69))
    for args in ((train, query), (train, query, tp, qp, 0.3), (train, train[[4, 1]])):
        np.testing.assert_array_equal(nn_mod.nearest_neighbor_indices(*args),
                                      jax_nn.nearest_neighbor_indices(*args))
    np.testing.assert_array_equal(nn_mod.nearest_neighbor_indices(train, train[[4, 1]]), [4, 1])


def test_nearest_neighbour_cli_renders_and_scores_like_jax(rng, tmp_path):
    data_dir = tmp_path / "data"
    for split, n in (("train", 5), ("val", 3)):
        images = rng.uniform(0, 1, (n, 16, 16, 3)).astype(np.float32)
        datasets.write_dataset(str(data_dir / split), images, _sphere_cams(rng, n), np.pi / 3,
                               rng.uniform(-0.5, 0.5, (n, 69)).astype(np.float32))
    out = tmp_path / "nn"
    renders, scores = baselines_cli.main(["--dataset_dir", str(data_dir), "--out", str(out),
                                          "--device", "cpu"])
    train, val = (datasets.load_dataset(str(data_dir / s), "smpl_nerf", device="cpu")
                  for s in ("train", "val"))
    want_renders, want_scores = jax_nn.evaluate_nearest_neighbors(train, val)
    np.testing.assert_array_equal(renders, want_renders)
    assert set(scores) == set(want_scores) == {"mse", "psnr", "ssim"}
    for key in scores:
        assert scores[key] == pytest.approx(want_scores[key], rel=1e-5), key
    assert json.loads((out / "scores.json").read_text()) == scores
    assert sorted(os.listdir(out)) == ["img_000.png", "img_001.png", "img_002.png",
                                       "scores.json", "walking.gif"]
    np.testing.assert_array_equal(png.read_png(str(out / "img_001.png")),
                                  (np.clip(renders[1], 0, 1) * 255).astype(np.uint8))


# ------------------------------------------------------------- silhouette fit

def test_projection_chamfer_and_priors_match_jax(rng):
    verts = rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
    cam = jax_cameras.get_sphere_pose(10.0, 20.0, 2.4)
    got = fit.project_vertices(torch.from_numpy(verts), cam, 32, 48, 41.0).numpy()
    want = np.asarray(jax_fit.project_vertices(jnp.asarray(verts), cam, 32, 48, 41.0))
    np.testing.assert_allclose(got, want, rtol=F32_REL, atol=1e-4)
    a, b = rng.uniform(0, 30, (25, 2)), rng.uniform(0, 30, (17, 2))
    a, b = a.astype(np.float32), b.astype(np.float32)
    assert float(fit.chamfer(torch.from_numpy(a), torch.from_numpy(b))) == pytest.approx(
        float(jax_fit.chamfer(jnp.asarray(a), jnp.asarray(b))), rel=F32_REL)
    pose = rng.uniform(-1, 1, 69).astype(np.float32)
    for port_fn, jax_fn in ((fit.angle_prior, jax_fit.angle_prior),
                            (pose_priors.l2_prior, jax_priors.l2_prior)):
        assert float(port_fn(torch.from_numpy(pose))) == pytest.approx(
            float(jax_fn(jnp.asarray(pose))), rel=F32_REL)
    mask = rng.uniform(0, 1, (60, 70)) < 0.7
    np.testing.assert_array_equal(fit.silhouette_pixels(mask), jax_fit.silhouette_pixels(mask))
    np.testing.assert_array_equal(fit.silhouette_pixels(mask, 50),
                                  jax_fit.silhouette_pixels(mask, 50))


def test_the_fit_s_first_losses_match_jax():
    cam = jax_cameras.get_sphere_pose(0.0, 0.0, 2.4)
    yy, xx = np.mgrid[:32, :32]
    mask = ((xx - 16) / 6.0) ** 2 + ((yy - 15) / 12.0) ** 2 < 1.0
    mask |= (np.abs(yy - 10) < 2) & (np.abs(xx - 16) < 13)          # two arms
    kw = dict(steps=10, lr=0.03, free_joints=np.array([38, 41]))
    pose, losses = fit.fit_pose_to_silhouette(smpl_mod.procedural_human(3, 6), mask, cam,
                                              np.pi / 3, device="cpu", **kw)
    want_pose, want_losses = jax_fit.fit_pose_to_silhouette(
        jax_smpl.procedural_human(3, 6), mask, cam, np.pi / 3, **kw)
    np.testing.assert_allclose(losses, want_losses, rtol=FIT_LOSS_REL)
    assert losses[-1] < losses[0]
    frozen = np.setdiff1d(np.arange(69), [38, 41])
    assert np.all(pose[frozen] == 0) and np.all(pose[[38, 41]] != 0)
    np.testing.assert_allclose(pose, want_pose, atol=1e-3)


def test_max_mixture_prior_on_a_synthetic_gmm(rng, tmp_path):
    K, D = 4, 69
    means = rng.randn(K, D)
    covars = np.stack([np.eye(D) * (0.5 + rng.rand()) + 0.05 * np.outer(v, v)
                       for v in rng.randn(K, D)])
    weights = rng.dirichlet(np.ones(K))
    path = str(tmp_path / "gmm_04.pkl")
    with open(path, "wb") as fh:
        pickle.dump({"means": means, "covars": covars, "weights": weights}, fh)
    prior = pose_priors.MaxMixturePrior.load(path)
    want_prior = jax_priors.MaxMixturePrior.load(path)
    assert pose_priors.MaxMixturePrior.load(str(tmp_path / "missing.pkl")) is None
    poses = (rng.randn(5, D) * 0.3).astype(np.float32)
    got = prior(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(got, np.asarray(want_prior(jnp.asarray(poses))), rtol=1e-5)
    oracle = min(0.5 * (poses[0] - means[k]) @ np.linalg.inv(covars[k]) @ (poses[0] - means[k])
                 + 0.5 * np.linalg.slogdet(covars[k])[1] - np.log(weights[k]) for k in range(K))
    assert float(prior(torch.from_numpy(poses[0]))) == pytest.approx(oracle, rel=1e-3)
    assert got.shape == (5,)


# ---------------------------------------------------------------------- U-Net

@pytest.mark.parametrize("size", [2, 4, 8, 16])
@pytest.mark.parametrize("transposed", [False, True])
def test_stride_2_convolutions_pad_as_flax_same(rng, size, transposed):
    """flax's SAME Conv (stride 2, kernel 4) is torch's padding=1 at even
    sizes; flax's SAME ConvTranspose (unflipped kernel, lax.conv_transpose) is
    torch's conv_transpose2d at padding=1 on the flipped kernel."""
    layer = (flax_nn.ConvTranspose if transposed else flax_nn.Conv)(
        5, (4, 4), strides=(2, 2), padding="SAME", name="up0" if transposed else "down0")
    x = rng.randn(2, size, size, 3).astype(np.float32)
    params = jax.device_get(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["bias"] = rng.randn(5).astype(np.float32)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    if transposed:
        want_lax = np.asarray(jax.lax.conv_transpose(
            jnp.asarray(x), jnp.asarray(params["params"]["kernel"]), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))) + params["params"]["bias"]
        np.testing.assert_allclose(want, want_lax, atol=1e-5)
    sd = pix2pix.state_dict_from_jax({"params": {layer.name: params["params"]}})
    conv = torch.nn.functional.conv_transpose2d if transposed else torch.nn.functional.conv2d
    got = conv(torch.from_numpy(x).permute(0, 3, 1, 2), sd[f"{layer.name}.weight"],
               sd[f"{layer.name}.bias"], 2, 1).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, size * 2 if transposed else size // 2,
                                       size * 2 if transposed else size // 2, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_unet_forward_and_loss_gradient_on_carried_weights(rng):
    jmod = _jax_pix2pix()
    jnet = jmod.UNet(base=8, dtype=jnp.float32)
    depth = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    target = np.ones((2, 32, 32, 3), np.float32)
    target[:, 8:24, 10:20] = rng.uniform(0, 0.9, (2, 16, 10, 3))
    # the flax layout from the module's shapes (eval_shape compiles nothing),
    # filled with seeded values at lecun scale and non-zero biases
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(depth))
    params = jax.tree_util.tree_map(
        lambda s: (rng.randn(*s.shape) * (0.05 if len(s.shape) == 1 else
                                          (1.0 / np.prod(s.shape[:-1])) ** 0.5)
                   ).astype(np.float32), shapes)
    net = pix2pix.UNet(base=8, compute_dtype=torch.float32)
    net.load_state_dict(pix2pix.state_dict_from_jax(params))
    want = np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(depth)))
    got = net(torch.from_numpy(depth))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=UNET_ATOL)

    def jax_loss(p):
        err = jnp.abs(jnet.apply(p, jnp.asarray(depth)) - target)
        fg = (target.min(-1, keepdims=True) < 0.98).astype(jnp.float32)
        w = 1.0 + 15.0 * fg
        return (err * w).sum() / (w.sum() * 3.0)

    want_loss, grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    loss = pix2pix.weighted_l1(got, torch.from_numpy(target), 15.0)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    loss.backward()
    want_grads = pix2pix.state_dict_from_jax(jax.device_get(grads))
    for name, p in net.named_parameters():
        g = want_grads[name].numpy()
        assert np.linalg.norm(p.grad.numpy() - g) <= UNET_GRAD_REL * np.linalg.norm(g), name
    with pytest.raises(ValueError, match="multiples of 32"):
        net(torch.zeros(1, 48, 40, 1))


def _pairs(rng, root, n_train=4, n_val=2, res=32):
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            img = np.full((res, 2 * res, 3), 255, np.uint8)
            img[8:24, 8:20] = rng.randint(0, 200, (16, 12, 3))
            img[:, res:] = rng.randint(0, 256, (res, res, 1))
            png.write_png(os.path.join(root, split, f"img_{i:03d}.png"), img)
    return root


def test_pix2pix_cli_trains_renders_and_scores(rng, tmp_path):
    data_dir = _pairs(rng, str(tmp_path / "p2p"))
    rgb, depth = pix2pix.load_pairs(os.path.join(data_dir, "train"))
    raw = png.read_png(os.path.join(data_dir, "train", "img_002.png"))
    np.testing.assert_array_equal(rgb[2] * 255, raw[:, :32, ::-1])
    np.testing.assert_array_equal(depth[2, ..., 0] * 255, raw[:, 32:, 2])
    out = tmp_path / "out"
    result = pix2pix.main(["--dataset_dir", data_dir, "--epochs", "3", "--batch", "2",
                           "--out", str(out), "--device", "cpu"])
    assert result["renders"].shape == (2, 32, 32, 3)
    assert np.isfinite(result["losses"]).all() and len(result["epoch_seconds"]) == 3
    assert result["losses"][-1] < result["losses"][0]
    assert {"mse", "psnr", "ssim", "rlpips"} <= set(result["scores"])
    assert json.loads((out / "scores.json").read_text()) == result["scores"]
    np.testing.assert_array_equal(
        png.read_png(str(out / "img_001.png"))[..., ::-1],
        (np.clip(result["renders"][1], 0, 1) * 255).astype(np.uint8))


def test_evaluate_pix2pix_cli_scores_and_writes_the_gif(rng, tmp_path, monkeypatch):
    # rLPIPS against JAX's is held in test_torch_port_inference.py
    monkeypatch.setenv("SMPL_NERF_TPU_NO_RLPIPS", "1")
    dirs = {}
    for name, width in (("gt", 16), ("nerf", 16), ("p2p", 32)):
        dirs[name] = tmp_path / name
        os.makedirs(dirs[name])
        for i in range(3 if name != "nerf" else 2):
            png.write_png(str(dirs[name] / f"img_{i:03d}.png"),
                          rng.randint(0, 256, (16, width, 3)).astype(np.uint8))
    gif_path = str(tmp_path / "cmp.gif")
    scores = evaluate_pix2pix.main(["--gt_dir", str(dirs["gt"]), "--nerf_dir", str(dirs["nerf"]),
                                    "--pix2pix_dir", str(dirs["p2p"]), "--out", gif_path,
                                    "--device", "cpu"])
    gt, nerf, p2p = (evaluate_pix2pix.load_images(str(dirs[k])) for k in ("gt", "nerf", "p2p"))
    assert gt.shape == (3, 16, 16, 3) and p2p.shape == (3, 16, 32, 3)
    np.testing.assert_array_equal(gt[1] * 255.0, png.read_png(
        sorted(glob.glob(str(dirs["gt"] / "*.png")))[1])[..., ::-1])
    for key, got, want in (("smpl-nerf", scores["smpl-nerf"], jax_scores.print_scores(
                                nerf, gt[:2])),
                           ("pix2pix", scores["pix2pix"], jax_scores.print_scores(
                               p2p[:, :, :16], gt))):
        assert set(got) == set(want) == {"mse", "psnr", "ssim"}
        for name in got:
            assert got[name] == pytest.approx(float(want[name]), rel=1e-4), (key, name)
    frames = iio.imread(gif_path, index=None)
    assert frames.shape[:3] == (2, 16, 48)
