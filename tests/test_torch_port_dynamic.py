"""The port's SMPL-driven families against the JAX package, on the CPU.

SMPL LBS, the vertex-attention warps, the modified softmax and the GMM, the
dummy estimators and the vertex embedder, the dummy_dynamic and
append_vertex_locations_to_nerf pipelines (with and without
--images_per_batch), the solver's --images_per_batch draws and guards, the
pose-table swap, a GMM-loss step, ray-mesh intersection, the image-wise pose
loss and its gradient, and tiny train_torch / inference_torch runs of the
three families. Inputs come from seeded numpy; weights are drawn by JAX and
carried over with `params_from_jax`; every pipeline runs without a generator
(jitter 0.5, no sigma noise), so nothing random is drawn on either side.
Sizes: 2-layer 32-wide nets, <= 64 rays, <= 8 samples, the procedural human
(3,120 vertices; a coarser one where a test sweeps many poses).

Tolerances, each with its reason:
  * LBS: float32 chains of 4x4 products in another order: 1e-5 absolute on
    vertices of order 1; its pose gradient 1e-4 relative to the largest entry.
  * vertex attention at temperature T: a distance carries float32 rounding of
    about 1e-7 of the coordinates (order 1), which T turns into a logit error of
    T * 1e-7 and a weight error of that relative size: 1e-3 of the largest warp
    vector at T = 1e4, 1e-5 at T = 100. The normalised-ReLU form has no T: 1e-6.
  * pipelines: rgb_coarse 1e-4 (the warp's rounding moves a sample by 1e-7 and
    the net carries it); rgb_fine 2e-3, because the fine pass can flip an
    inverse-CDF bin where u meets a cdf entry to float precision; losses 1e-5.
  * ray-mesh hits: t 1e-5, and the same face and hit flags.
"""
import _torch_threads  # noqa: F401

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.core import gmm as jax_gmm
from smpl_nerf_tpu.models import dummy_estimators as jax_est
from smpl_nerf_tpu.models import smpl as jax_smpl
from smpl_nerf_tpu.ops import raymesh as jax_raymesh
from smpl_nerf_tpu.ops import vertex_attention as jax_va
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu.training import image_wise as jax_image_wise
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.core import gmm
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import dummy_estimators, smpl
from smpl_nerf_tpu_torch.ops import raymesh, vertex_attention
from smpl_nerf_tpu_torch.training import checkpoints, factory, image_wise, solver

LBS_ATOL, LBS_GRAD_RTOL = 1e-5, 1e-4
ATT_REL = {1e4: 1e-3, 100.0: 1e-5}
RGB_COARSE_ATOL, RGB_FINE_ATOL, LOSS_ATOL = 1e-4, 2e-3, 1e-5
N_IMG, R, S = 4, 48, 8


def to_np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def humans():
    return jax_smpl.procedural_human(), smpl.procedural_human()


def _synthetic_pkl(path, rng, V=60, F=40):
    """A licensed-SMPL-shaped pkl (scipy csc J_regressor), as tests/test_smpl.py writes it."""
    from scipy.sparse import csc_matrix
    data = {"v_template": rng.randn(V, 3), "shapedirs": rng.randn(V, 3, 10) * 0.01,
            "posedirs": rng.randn(V, 3, 207) * 0.001,
            "J_regressor": csc_matrix(np.abs(rng.rand(24, V)) / V),
            "weights": np.abs(rng.rand(V, 24)), "f": rng.randint(0, V, (F, 3)).astype(np.uint32),
            "bs_style": "lbs"}
    data["weights"] /= data["weights"].sum(-1, keepdims=True)
    with open(path, "wb") as fh:
        pickle.dump(data, fh)


# ------------------------------------------------------------------ SMPL LBS

@pytest.mark.parametrize("model", ["procedural", "pkl"])
@pytest.mark.parametrize("pose_kind", ["zero", "random"])
def test_smpl_forward_and_its_pose_gradient_match_jax(rng, tmp_path, humans, model, pose_kind):
    if model == "pkl":
        path = str(tmp_path / "model.pkl")
        _synthetic_pkl(path, rng)
        jm, pm = jax_smpl.load_smpl_pkl(path), smpl.load_smpl_pkl(path)
        for key in ("v_template", "shapedirs", "posedirs", "joint_regressor", "lbs_weights",
                    "faces"):
            np.testing.assert_array_equal(getattr(pm, key), getattr(jm, key), err_msg=key)
        betas = (0.5 * rng.randn(10)).astype(np.float32)
    else:
        jm, pm = humans
        betas = np.zeros(10, np.float32)
    pose = (np.zeros(69, np.float32) if pose_kind == "zero"
            else (0.4 * rng.randn(69)).astype(np.float32))
    jax_forward = jax.jit(lambda p: jax_smpl.smpl_forward(jm, jnp.asarray(betas), p))
    want = np.asarray(jax_forward(jnp.asarray(pose)))
    got = smpl.smpl_forward(pm, betas, torch.from_numpy(pose))
    np.testing.assert_allclose(to_np(got), want, atol=LBS_ATOL)
    # a batch of poses gives each pose's vertices
    batch = smpl.smpl_forward(pm, betas, torch.from_numpy(np.stack([pose, 0.5 * pose])))
    np.testing.assert_allclose(to_np(batch[0]), want, atol=LBS_ATOL)

    weights = rng.randn(*want.shape).astype(np.float32)
    want_g = np.asarray(jax.jit(jax.grad(lambda p: jnp.sum(jax_forward(p) * weights)))(
        jnp.asarray(pose)))
    p = torch.from_numpy(pose).requires_grad_(True)
    (smpl.smpl_forward(pm, betas, p) * torch.from_numpy(weights)).sum().backward()
    assert np.isfinite(to_np(p.grad)).all()
    np.testing.assert_allclose(to_np(p.grad), want_g, atol=LBS_GRAD_RTOL * np.abs(want_g).max())


def test_procedural_human_and_pose_helpers_match_jax(humans):
    jm, pm = humans
    assert pm.num_vertices == jm.num_vertices == 3120
    for key in ("v_template", "lbs_weights", "faces", "joint_regressor", "vertex_colors",
                "rest_joints", "parents"):
        np.testing.assert_array_equal(getattr(pm, key), getattr(jm, key), err_msg=key)
    np.testing.assert_array_equal(smpl.get_human_poses([38, 41], -20, 40, 4),
                                  jax_smpl.get_human_poses([38, 41], -20, 40, 4))
    np.testing.assert_array_equal(smpl.default_betas(), jax_smpl.default_betas())
    for kw in ({"var": 0.3}, {"mean": 0.2}, {"beta0": 1.5}):
        np.testing.assert_array_equal(
            smpl.distorted_betas(smpl.default_betas(), rng=np.random.RandomState(3), **kw),
            jax_smpl.distorted_betas(jax_smpl.default_betas(), rng=np.random.RandomState(3), **kw))


# --------------------------------------------------------- vertex attention

def _attention_inputs(rng, humans, n_rays=6, n_samples=5):
    _, pm = humans
    poses = (0.3 * rng.randn(3, 69)).astype(np.float32)
    verts = to_np(smpl.smpl_forward(pm, np.zeros(10), torch.from_numpy(poses)))
    ray_verts = verts[rng.randint(0, 3, n_rays)]                       # [R, V, 3]
    anchor = ray_verts[np.arange(n_rays)[:, None], rng.randint(0, pm.num_vertices,
                                                               (n_rays, n_samples))]
    samples = (anchor + 0.004 * rng.randn(n_rays, n_samples, 3)).astype(np.float32)
    warps = (0.1 * rng.randn(*ray_verts.shape)).astype(np.float32)
    return samples, ray_verts, warps


@pytest.mark.parametrize("temperature", [1e4, 100.0])
def test_vertex_attention_warp_matches_jax(rng, humans, temperature):
    samples, verts, warps = _attention_inputs(rng, humans)
    chunk = 500                                   # does not divide V = 3120
    want = np.asarray(jax_va.vertex_attention_warp(
        jnp.asarray(samples), jnp.asarray(verts), jnp.asarray(warps), 0.01, temperature,
        chunk_size=chunk))
    got = vertex_attention.vertex_attention_warp(
        torch.from_numpy(samples), torch.from_numpy(verts), torch.from_numpy(warps), 0.01,
        temperature, chunk_size=chunk)
    atol = ATT_REL[temperature] * np.abs(warps).max()
    assert np.abs(want).max() > 30 * atol            # the warp is active
    np.testing.assert_allclose(to_np(got), want, atol=atol)
    # the chunk does not change the result beyond rounding
    whole = vertex_attention.vertex_attention_warp(
        torch.from_numpy(samples), torch.from_numpy(verts), torch.from_numpy(warps), 0.01,
        temperature, chunk_size=4096)
    np.testing.assert_allclose(to_np(whole), to_np(got), atol=ATT_REL[temperature] * 0.1)


def test_vertex_attention_max_is_global_over_the_batch(rng, humans):
    """The dense formula with modified_softmax over the whole [R, S, V] tensor:
    a per-row max would give other numbers."""
    samples, verts, warps = _attention_inputs(rng, humans, n_rays=3, n_samples=2)
    s, v, w = (torch.from_numpy(a).double() for a in (samples, verts, warps))
    dist = torch.linalg.norm(s[:, :, None] - v[:, None], dim=-1)
    att = torch.relu(0.01 - dist) * 100.0
    want = torch.einsum("rsv,rvd->rsd", gmm.modified_softmax(att), w)
    got = vertex_attention.vertex_attention_warp(s.float(), v.float(), w.float(), 0.01, 100.0,
                                                 chunk_size=700)
    np.testing.assert_allclose(to_np(got), want.numpy(), atol=1e-6)


def test_relu_attention_warp_and_its_vertex_gradient_match_jax(rng, humans):
    samples, verts, warps = _attention_inputs(rng, humans)
    args = (jnp.asarray(samples), jnp.asarray(verts[0]), jnp.asarray(warps[0]), 0.01)
    want = np.asarray(jax_va.relu_attention_warp(*args, chunk_size=500))
    v = torch.from_numpy(verts[0]).requires_grad_(True)
    got = vertex_attention.relu_attention_warp(torch.from_numpy(samples), v,
                                               torch.from_numpy(warps[0]), 0.01, chunk_size=500)
    np.testing.assert_allclose(to_np(got), want, atol=1e-6)
    got.sum().backward()
    want_g = np.asarray(jax.grad(lambda vv: jnp.sum(jax_va.relu_attention_warp(
        args[0], vv, args[2], 0.01, chunk_size=500)))(args[1]))
    np.testing.assert_allclose(to_np(v.grad), want_g, atol=1e-4 * np.abs(want_g).max())


def test_modified_softmax_and_gmm_pdf_match_jax(rng, humans):
    x = np.maximum(rng.randn(4, 5, 7), 0).astype(np.float32) * 3.0
    np.testing.assert_allclose(to_np(gmm.modified_softmax(torch.from_numpy(x))),
                               np.asarray(jax_gmm.modified_softmax(jnp.asarray(x))), atol=1e-7)
    assert float(gmm.modified_softmax(torch.zeros(2, 3)).abs().max()) == 0.0    # f(0) = 0
    means = humans[0].v_template[::7]
    samples = (means[rng.randint(0, len(means), (6, 5))]
               + 0.05 * rng.randn(6, 5, 3)).astype(np.float32)
    want = np.asarray(jax_gmm.GaussianMixture(means, 0.07).pdf(jnp.asarray(samples)))
    got = to_np(gmm.GaussianMixture(means, 0.07).pdf(torch.from_numpy(samples)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * want.max())
    with pytest.raises(ValueError, match="sample dim"):
        gmm.GaussianMixture(means, 0.07).pdf(torch.zeros(3, 2))


# ------------------------------------------------ estimators and the embedder

def test_dummy_estimators_and_vertex_embedder_match_jax(rng):
    table = rng.randn(5, 69).astype(np.float32)
    jmod = jax_est.DummySmplEstimatorModel(goal_poses=table, betas=np.zeros(10, np.float32))
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray([0]))
    port = dummy_estimators.DummySmplEstimatorModel(np.zeros((2, 69)))
    port.load_state_dict(checkpoints.params_from_jax({"e": jax.device_get(jvars)})["e"])
    assert [n for n, _ in port.named_parameters()] == []        # a buffer, never trained
    idx = np.asarray([3, 0, 4, 4])
    np.testing.assert_array_equal(to_np(port(torch.from_numpy(idx))),
                                  np.asarray(jmod.apply(jvars, jnp.asarray(idx))))

    canonical = rng.randn(69).astype(np.float32)
    jiw = jax_est.DummyImageWiseEstimator(canonical_pose=canonical, initial_arm_angle_l=0.3,
                                          initial_arm_angle_r=-0.2)
    jiv = jax.device_get(jiw.init(jax.random.PRNGKey(0)))
    piw = dummy_estimators.DummyImageWiseEstimator(canonical)
    piw.load_state_dict(checkpoints.params_from_jax({"e": jiv})["e"])
    np.testing.assert_array_equal(to_np(piw()), np.asarray(jiw.apply(jiv)))
    gt = rng.randn(69).astype(np.float32)
    assert dummy_estimators.DummyImageWiseEstimator.pose_error(piw.state_dict(), gt) == \
        pytest.approx(jax_est.DummyImageWiseEstimator.pose_error(jiv, gt), abs=1e-7)

    jemb = jax_factory.VertexEmbedder(width=32, embedding_dim=64)
    jev = jax.device_get(jemb.init(jax.random.PRNGKey(1), jnp.zeros((2, 90))))
    pemb = factory.VertexEmbedder(90, width=32)
    pemb.load_state_dict(checkpoints.params_from_jax({"e": jev})["e"])
    assert sorted(dict(pemb.named_children())) == ["embed_0", "embed_out"]
    x = rng.randn(7, 90).astype(np.float32)
    np.testing.assert_allclose(to_np(pemb(torch.from_numpy(x))),
                               np.asarray(jemb.apply(jev, jnp.asarray(x))), atol=1e-5)


# --------------------------------------------------------------- pipelines

def _argv(model_type, images_per_batch=0, extra=()):
    return ["--config=/dev/null", f"--model_type={model_type}", "--netdepth=2",
            "--netwidth=32", "--skips=0", "--netdepth_fine=2", "--netwidth_fine=32",
            "--skips_fine=0", "--run_fine=1", f"--number_coarse_samples={S}",
            "--number_fine_samples=8", "--number_frequencies_postitional=4",
            "--number_frequencies_directional=2", "--sigma_noise_std=0",
            "--white_background=1", "--near=1", "--far=4", "--warp_radius=0.3",
            "--warp_temperature=100", f"--images_per_batch={images_per_batch}",
            "--batchsize=64", "--batchsize_val=64", "--lrate=1e-3", *extra]


def _both(model_type, goal_poses, humans, images_per_batch=0, extra=(), seed=0):
    """(JAX pipeline, its params, port pipeline, extras of each) on shared weights."""
    jm, pm = humans
    betas = np.zeros(10, np.float32)
    argv = _argv(model_type, images_per_batch, extra)
    jargs = jax_config.config_parser().parse_args(argv)
    jextras = {"smpl_model": jm, "betas": betas, "num_images": len(goal_poses),
               "goal_poses": goal_poses, "num_vertices": jm.num_vertices}
    jmodels, params, jenc = jax_factory.build_models_and_params(
        jargs, jax.random.PRNGKey(seed), jextras)
    rs = np.random.RandomState(seed + 1)       # non-zero biases: a misplaced one shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                         if path[-1].key == "bias" else 0.0),
        jax.device_get(params))
    jpipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs), jmodels,
                                         jenc, jextras)
    pargs = port_config.config_parser().parse_args(argv)
    pextras = {"smpl_model": pm, "betas": betas, "num_images": len(goal_poses),
               "goal_poses": goal_poses, "num_vertices": pm.num_vertices}
    models, encoders = factory.build_models_and_params(pargs, device="cpu", extras=pextras)
    for name, sd in checkpoints.params_from_jax(params).items():
        models[name].load_state_dict(sd)
    ppipe = pipelines.build_pipeline(pipelines.RenderConfig.from_args(pargs), models,
                                     encoders, pextras)
    return jpipe, params, ppipe, jargs, pargs


def _batch(rng, humans, goal_poses, image_indices):
    """Rays from a camera at z = 2.4 toward vertices of each ray's goal mesh."""
    _, pm = humans
    verts = to_np(smpl.smpl_forward(pm, np.zeros(10), torch.from_numpy(goal_poses)))
    n = len(image_indices)
    origins = np.tile(np.asarray([[0.0, 0.0, 2.4]], np.float32), (n, 1))
    target = verts[image_indices, rng.randint(0, pm.num_vertices, n)]
    dirs = (target - origins).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return {"ray_translation": origins, "ray_direction": dirs, "rgb": rgb,
            "image_indices": np.asarray(image_indices, np.int32)}


def _image_indices(rng, images_per_batch, single_image):
    if single_image:
        return np.full(R, 2, np.int32)
    return rng.choice([1, 3], R) if images_per_batch else rng.randint(0, N_IMG, R)


@pytest.mark.parametrize("model_type", ["dummy_dynamic", "append_vertex_locations_to_nerf"])
@pytest.mark.parametrize("images_per_batch,single_image", [(0, False), (2, False), (2, True)])
def test_pipeline_matches_jax_build_pipeline(rng, humans, model_type, images_per_batch,
                                             single_image):
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    extra = ("--use_pallas=1",) if model_type == "append_vertex_locations_to_nerf" else ()
    jpipe, params, ppipe, _, _ = _both(model_type, goal_poses, humans, images_per_batch, extra)
    batch = _batch(rng, humans, goal_poses, _image_indices(rng, images_per_batch, single_image))
    want = jpipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    with torch.no_grad():
        got = ppipe({k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    np.testing.assert_allclose(to_np(got["rgb_coarse"]), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)
    np.testing.assert_allclose(to_np(got["rgb_fine"]), np.asarray(want["rgb_fine"]),
                               atol=RGB_FINE_ATOL)
    if model_type == "dummy_dynamic":
        assert np.abs(np.asarray(want["warp"])).max() > 1e-3          # the warp is active
        np.testing.assert_allclose(to_np(got["warp"]), np.asarray(want["warp"]), atol=1e-5)
        np.testing.assert_allclose(to_np(got["rgb_fine"]), to_np(got["rgb_coarse"]))


@pytest.mark.parametrize("mode", [1, -1, 2])
def test_append_vertices_prefix_runs_through_the_fused_modes_on_cpu(rng, humans, mode):
    """Kernel D's plain version (mode 1), kernels B's and C's on raw rows with
    the 64-wide embedding as their prefix (mode 2) and auto (mode 0 on the
    CPU) give the plain net's render: in_dim 64 + 24 + 12."""
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    jpipe, params, ppipe, _, _ = _both("append_vertex_locations_to_nerf", goal_poses, humans,
                                       extra=(f"--use_fused_mlp={mode}",))
    spec = pipelines.fused_mod.spec_from_model(ppipe.models["model_coarse"])
    assert spec.in_dim == 64 + 24 + 12
    batch = _batch(rng, humans, goal_poses, rng.randint(0, N_IMG, R))
    want = jpipe(params, {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    with torch.no_grad():
        got = ppipe({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(to_np(got["rgb_coarse"]), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)


def test_unique_padded_is_jnp_unique_with_size_and_fill(rng):
    for x, size in ((rng.randint(0, 9, 40), 3), (np.full(40, 4), 3), (rng.randint(0, 3, 40), 3)):
        want = np.asarray(jnp.unique(jnp.asarray(x), size=size, fill_value=-1))
        np.testing.assert_array_equal(pipelines.unique_padded(torch.from_numpy(x), size).numpy(),
                                      want)


def test_swap_pose_table_renders_with_the_split_table_like_jax(rng, humans):
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    jpipe, params, ppipe, _, _ = _both("dummy_dynamic", goal_poses, humans)
    val_poses = (0.25 * rng.randn(2, 69)).astype(np.float32)
    batch = _batch(rng, humans, val_poses, rng.randint(0, 2, R))
    want = jpipe(jax_solver.swap_pose_table(params, val_poses),
                 {k: jnp.asarray(v) for k, v in batch.items()}, None, False)
    table = ppipe.models["smpl_estimator"].goal_poses
    with torch.no_grad(), solver.swap_pose_table(ppipe.models, val_poses):
        assert pipelines.get_pose_table(ppipe.models).shape == (2, 69)
        got = ppipe({k: torch.from_numpy(v) for k, v in batch.items()})
    assert pipelines.get_pose_table(ppipe.models) is table             # put back
    np.testing.assert_allclose(to_np(got["rgb_coarse"]), np.asarray(want["rgb_coarse"]),
                               atol=RGB_COARSE_ATOL)
    with solver.swap_pose_table({}, val_poses):                           # no table: no-op
        pass


# ------------------------------------------------ the skinned pose table

def _port_pipeline(model_type, goal_poses, humans, images_per_batch=0, extra=()):
    """(port pipeline, its args): the nets as the factory draws them."""
    _, pm = humans
    pargs = port_config.config_parser().parse_args(_argv(model_type, images_per_batch, extra))
    pextras = {"smpl_model": pm, "betas": np.zeros(10, np.float32),
               "num_images": len(goal_poses), "goal_poses": goal_poses,
               "num_vertices": pm.num_vertices}
    models, encoders = factory.build_models_and_params(pargs, seed=0, device="cpu",
                                                       extras=pextras)
    return pipelines.build_pipeline(pipelines.RenderConfig.from_args(pargs), models, encoders,
                                    pextras), pargs


def _counts():
    return pipelines.goal_table_builds, pipelines.goal_table_hits, smpl.lbs_calls


@pytest.mark.parametrize("model_type", ["dummy_dynamic", "append_vertex_locations_to_nerf"])
@pytest.mark.parametrize("images_per_batch", [0, 2])
def test_skinned_table_gives_the_per_step_lbs_over_training_steps(rng, humans, model_type,
                                                                  images_per_batch):
    """Three training steps on the skinned table and on the per-step path (the
    same weights, a table that needs a gradient): the same goal rows, per-ray
    conditioning and losses, to float32 rounding."""
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    cached, pargs = _port_pipeline(model_type, goal_poses, humans, images_per_batch)
    per_step, _ = _port_pipeline(model_type, goal_poses, humans, images_per_batch)
    per_step.models["smpl_estimator"].goal_poses.requires_grad_(True)
    solvers = [solver.Solver(p, pargs) for p in (cached, per_step)]
    b0, h0, _ = _counts()
    for step in range(3):
        idx = rng.choice([1, 3], R) if images_per_batch else rng.randint(0, N_IMG, R)
        batch = {k: torch.from_numpy(v)
                 for k, v in _batch(rng, humans, goal_poses, idx).items()}
        (got, got_pos), (want, want_pos) = (p.passes.goal_verts_table(batch["image_indices"])
                                            for p in (cached, per_step))
        assert got.shape == want.shape == (images_per_batch or N_IMG, 3120, 3)
        torch.testing.assert_close(got_pos, want_pos, rtol=0, atol=0)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=0, atol=1e-6)
        conditioning = [p.passes.pose(batch) for p in (cached, per_step)]
        if model_type == "dummy_dynamic":
            for a, b in zip(*conditioning):
                np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-6)
        else:
            np.testing.assert_allclose(to_np(conditioning[0]), to_np(conditioning[1]),
                                       rtol=0, atol=1e-6)
        got_loss, want_loss = (sol.train_step(batch, None) for sol in solvers)
        for key in want_loss:
            assert float(got_loss[key]) == pytest.approx(float(want_loss[key]), abs=1e-6), key
    # one build, then every lookup (three goal_verts_table, three pose, three steps) hits
    assert _counts()[:2] == (b0 + 1, h0 + 8)


def test_skinned_table_follows_a_swapped_or_loaded_table(rng, humans):
    """Inside swap_pose_table the rows are the validation table's, after it
    the train table's again (kept, not skinned anew); an in-place load of the
    buffer and a load that replaces it each skin anew."""
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    ppipe, _ = _port_pipeline("dummy_dynamic", goal_poses, humans, images_per_batch=2)
    passes, est = ppipe.passes, ppipe.models["smpl_estimator"]
    _, pm = humans

    def rows_of(poses, idx):
        verts, ray_pos = passes.goal_verts_table(torch.from_numpy(np.asarray(idx, np.int32)))
        want = smpl.smpl_forward(pm, np.zeros(10), torch.from_numpy(poses))
        np.testing.assert_allclose(to_np(verts[ray_pos]), to_np(want[list(idx)]),
                                   rtol=0, atol=LBS_ATOL)

    val_poses = (0.25 * rng.randn(3, 69)).astype(np.float32)
    b0, h0, _ = _counts()
    rows_of(goal_poses, [0, 3, 3])
    with torch.no_grad(), solver.swap_pose_table(ppipe.models, val_poses):
        rows_of(val_poses, [2, 1])
        rows_of(val_poses, [0, 2])
    rows_of(goal_poses, [1, 2, 1])
    assert _counts()[:2] == (b0 + 2, h0 + 2)                  # the train table outlived the swap
    with torch.no_grad(), solver.swap_pose_table(ppipe.models, val_poses):
        rows_of(val_poses, [1])                               # a new table object: built anew
    rows_of(goal_poses, [0, 1])                               # and the train table kept again
    assert _counts()[:2] == (b0 + 3, h0 + 3)
    moved = goal_poses + 0.2
    table = est.goal_poses
    est.load_state_dict({"goal_poses": torch.from_numpy(moved)})       # in place
    assert est.goal_poses is table
    rows_of(moved, [3, 0])
    longer = (0.25 * rng.randn(N_IMG + 2, 69)).astype(np.float32)
    est.load_state_dict({"goal_poses": torch.from_numpy(longer)})      # replaces the buffer
    rows_of(longer, [5, 4])
    assert _counts()[:2] == (b0 + 5, h0 + 3)
    assert len(passes._skinned) == 2


def test_skinned_table_builds_once_per_table_version(rng, humans):
    """N steps on one table: one build, N - 1 hits, one smpl_forward call
    (the canonical mesh, skinned once per device, made before counting)."""
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    ppipe, pargs = _port_pipeline("dummy_dynamic", goal_poses, humans, images_per_batch=2)
    ppipe.passes.canonical_vertices(torch.device("cpu"))
    sol = solver.Solver(ppipe, pargs)
    n = 4
    batches = [{k: torch.from_numpy(v) for k, v in
                _batch(rng, humans, goal_poses, rng.choice([0, 2], R)).items()}
               for _ in range(n)]                             # _batch skins to aim its rays
    b0, h0, l0 = _counts()
    for batch in batches:
        sol.train_step(batch, None)
    assert _counts() == (b0 + 1, h0 + n - 1, l0 + 1)


@pytest.mark.parametrize("model_type", ["dummy_dynamic", "image_wise_dynamic"])
def test_pose_that_takes_a_gradient_keeps_lbs_in_every_step(rng, humans, model_type):
    """A pose table that needs a gradient, and the image-wise estimator's
    trainable pose, run smpl_forward in every step, and the loss's gradient
    reaches the pose."""
    n_img = N_IMG if model_type == "dummy_dynamic" else 1
    goal_poses = (0.25 * rng.randn(n_img, 69)).astype(np.float32)
    ppipe, _ = _port_pipeline(model_type, goal_poses, humans, images_per_batch=0,
                              extra=("--warp_radius=0.05",))
    est = ppipe.models["smpl_estimator"]
    if model_type == "dummy_dynamic":
        est.goal_poses.requires_grad_(True)
        pose_leaves = [est.goal_poses]
    else:
        pose_leaves = [est.arm_angle_l, est.arm_angle_r]
    ppipe.passes.canonical_vertices(torch.device("cpu"))
    batches = [_batch(rng, humans, goal_poses, rng.randint(0, n_img, R)) for _ in range(3)]
    b0, h0, l0 = _counts()
    for step, batch in enumerate(batches):
        for leaf in pose_leaves:
            leaf.grad = None
        out = ppipe({k: torch.from_numpy(v) for k, v in batch.items()})
        ((out["rgb_coarse"] - torch.from_numpy(batch["rgb"])) ** 2).mean().backward()
        assert _counts() == (b0, h0, l0 + step + 1)
        grads = torch.cat([leaf.grad.reshape(-1) for leaf in pose_leaves])
        assert torch.isfinite(grads).all() and float(grads.abs().max()) > 0


@pytest.mark.parametrize("model_type", ["dummy_dynamic", "smpl_nerf"])
def test_gmm_loss_step_matches_jax(rng, humans, model_type):
    """One loss with the GMM prior, an Adam step on it, and the loss after."""
    jm, pm = humans
    goal_poses = (0.25 * rng.randn(N_IMG, 69)).astype(np.float32)
    jpipe, params, ppipe, jargs, pargs = _both(model_type, goal_poses, humans,
                                               extra=("--use_gmm_loss=1", "--gmm_std=0.2"))
    want_canon = np.asarray(jax_smpl.smpl_forward(jm, jnp.zeros(10), jnp.zeros(69)))
    canon = smpl.smpl_forward(pm, np.zeros(10), torch.zeros(69))
    np.testing.assert_allclose(to_np(canon), want_canon, atol=LBS_ATOL)
    batch = _batch(rng, humans, goal_poses, rng.randint(0, N_IMG, R))
    if model_type == "smpl_nerf":
        batch["human_pose"] = goal_poses[batch["image_indices"]]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jax_solver.make_loss_fn(jpipe, want_canon)
    tx = jax_solver.make_optimizer(params, jargs, model_type)

    @jax.jit
    def jax_two_losses(params):
        (_, aux1), grads = jax.value_and_grad(jloss, has_aux=True)(params, jbatch, None, True)
        params2 = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])
        return aux1, jloss(params2, jbatch, None, True)[1]

    want1, want2 = jax_two_losses(params)

    sol = solver.Solver(ppipe, pargs, canonical_vertices=canon)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got1 = sol.train_step(tbatch, None)
    _, got2 = sol.loss_fn(tbatch, None, True)
    assert set(got1) == set(want1) and "loss_gmm" in got1
    assert float(want1["loss_gmm"]) > 1e-4                   # the prior takes part
    for key in want1:
        assert float(got1[key]) == pytest.approx(float(want1[key]), abs=LOSS_ATOL), key
        assert float(got2[key].detach()) == pytest.approx(float(want2[key]), abs=LOSS_ATOL), key


# -------------------------------------------------- the solver's draws and guards

def _ray_data(rng, n_img, res):
    hw = res * res
    cams = np.stack([np.eye(4, dtype=np.float32)] * n_img)
    data = datasets.rays_from_cameras(cams, res, res, 1.0)
    data.rgb = rng.uniform(0, 1, (n_img * hw, 3)).astype(np.float32)
    data.rgb[::3] = 1.0                          # a white background for the fg split
    data.human_poses = np.zeros((n_img, 69), np.float32)
    return data


def _record_jax_draws(monkeypatch, jargs, jpipe, params, train_data, val_data):
    seen = []
    sol = jax_solver.Solver(jpipe, params, jargs)
    monkeypatch.setattr(sol, "_gather_batch", lambda arrays, idx: seen.append(np.asarray(idx)))
    monkeypatch.setattr(sol, "_train_step", lambda p, o, b, r: (p, o, {"loss": 0.0}))
    monkeypatch.setattr(sol, "_validate", lambda *a, **k: 0.0)
    sol.train(train_data, val_data)
    return seen


@pytest.mark.parametrize("fg_ratio", [0.0, 0.5])
def test_images_per_batch_draws_the_jax_indices(rng, humans, monkeypatch, fg_ratio):
    n_img, res, K = 6, 8, 2
    train_data, val_data = _ray_data(rng, n_img, res), _ray_data(rng, 2, res)
    goal_poses = train_data.human_poses
    extra = (f"--foreground_sample_ratio={fg_ratio}", "--num_epochs=2", "--steps_per_epoch=3",
             "--white_background=1", "--batchsize_val=64")
    jpipe, params, ppipe, jargs, pargs = _both("dummy_dynamic", goal_poses, humans, K, extra)
    want = _record_jax_draws(monkeypatch, jargs, jpipe, params, train_data, val_data)

    sol = solver.Solver(ppipe, pargs)
    got = []
    monkeypatch.setattr(sol, "gather", lambda arrays, idx: got.append(np.asarray(idx)))
    monkeypatch.setattr(sol, "train_step", lambda batch, gen: {"loss": torch.zeros(())})
    monkeypatch.setattr(sol, "_validate", lambda *a, **k: 0.0)
    sol.train(train_data, val_data)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert len(np.unique(train_data.image_indices[g])) <= K


def test_images_per_batch_guards_raise_where_jax_does(rng, humans, monkeypatch):
    n_img, res, K = 6, 8, 2
    train_data, val_data = _ray_data(rng, n_img, res), _ray_data(rng, 4, res)
    goal_poses = train_data.human_poses
    # a validation batch of 128 rays spans 2 images of 64: more than K - 1 = 1
    jpipe, params, ppipe, jargs, pargs = _both("dummy_dynamic", goal_poses, humans, K,
                                               ("--batchsize_val=128",))
    with pytest.raises(ValueError, match="batchsize_val"):
        _record_jax_draws(monkeypatch, jargs, jpipe, params, train_data, val_data)
    with pytest.raises(ValueError, match="batchsize_val"):
        solver.Solver(ppipe, pargs).train(train_data, val_data)
    # the per-batch guard: a strided batch over three images
    jsol = jax_solver.Solver(jpipe, params, jargs)
    img = val_data.image_indices
    for idx, raises in ((np.arange(0, 64), False), (np.arange(0, 128, 2), False),
                        (np.arange(0, 192, 3), True)):
        outcome = []
        for check in (lambda: jsol._check_batch_images(idx, img),
                      lambda: solver.check_batch_images(ppipe.cfg, idx, img)):
            try:
                check()
                outcome.append(False)
            except ValueError as e:
                assert "images_per_batch=2" in str(e)
                outcome.append(True)
        assert outcome == [raises, raises], idx


# ------------------------------------------------------ ray-mesh, image-wise

def test_intersect_rays_matches_jax(rng, humans):
    jm, pm = humans
    verts = jax_smpl.smpl_forward(jm, jnp.zeros(10), jnp.asarray(0.2 * rng.randn(69),
                                                                 jnp.float32))
    origins = np.tile(np.asarray([[0.0, 0.1, 2.4]], np.float32), (40, 1))
    dirs = np.concatenate([rng.uniform(-0.3, 0.3, (40, 2)), -np.ones((40, 1))], 1)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    want = jax_raymesh.intersect_rays(jnp.asarray(origins), jnp.asarray(dirs), verts,
                                      jnp.asarray(jm.faces), chunk_size=16)
    got = raymesh.intersect_rays(torch.from_numpy(origins), torch.from_numpy(dirs),
                                 torch.from_numpy(np.array(verts)), pm.faces, chunk_size=16)
    hit = np.asarray(want.hit)
    assert 0 < hit.sum() < 40
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.face_idx.numpy(), np.asarray(want.face_idx))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], atol=1e-5)
    assert np.isinf(got.t.numpy()[~hit]).all()
    np.testing.assert_allclose(got.bary.numpy()[hit], np.asarray(want.bary)[hit], atol=1e-5)


def test_make_pose_loss_and_its_pose_gradient_match_jax(rng, humans):
    jm, pm = humans
    goal_poses = np.zeros((1, 69), np.float32)
    jpipe, params, ppipe, jargs, pargs = _both("image_wise_dynamic", goal_poses, humans,
                                               extra=("--warp_radius=0.05",))
    jmodels, _, jenc = jax_factory.build_models_and_params(
        jargs, jax.random.PRNGKey(0), {"canonical_pose": np.zeros(69)})
    cfg = jax_pipelines.RenderConfig.from_args(jargs)
    jloss = jax_image_wise.make_pose_loss(jm, jnp.zeros(10), cfg, jmodels["model_coarse"],
                                          jenc["position"], jenc["direction"])
    ploss = image_wise.make_pose_loss(pm, torch.zeros(10), ppipe.cfg,
                                      ppipe.models["model_coarse"], ppipe.encoders["position"],
                                      ppipe.encoders["direction"])
    pose = np.zeros(69, np.float32)
    pose[[38, 41]] = [0.3, -0.25]
    batch = _batch(rng, humans, pose[None], np.zeros(R, np.int32))
    z = np.sort(rng.uniform(2.0, 2.8, (R, S)), -1).astype(np.float32)
    jargs_ = [jnp.asarray(batch[k]) for k in ("ray_translation", "ray_direction")]
    want, want_g = jax.jit(jax.value_and_grad(jloss, argnums=1))(
        params["model_coarse"], jnp.asarray(pose), *jargs_, jnp.asarray(z),
        jnp.asarray(batch["rgb"]))
    p = torch.from_numpy(pose).requires_grad_(True)
    got = ploss(p, torch.from_numpy(batch["ray_translation"]),
                torch.from_numpy(batch["ray_direction"]), torch.from_numpy(z),
                torch.from_numpy(batch["rgb"]))
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), abs=LOSS_ATOL)
    want_g = np.asarray(want_g)
    assert np.abs(want_g[[38, 41]]).max() > 0                    # the arm angles move the loss
    np.testing.assert_allclose(to_np(p.grad), want_g, atol=1e-3 * np.abs(want_g).max())


# -------------------------------------------------- train_torch / inference_torch

def _write_data(rng, root, n_train=3, n_val=2, res=16):
    """train/ and val/ splits: a camera circle, arm poses per image, betas."""
    from smpl_nerf_tpu_torch.cli import render_path
    n = n_train + n_val
    data = render_path.camera_path_data("circle", n, 2.4, -90, 90, res, [41, 38], 0.0)
    poses = np.zeros((n, 69), np.float32)
    poses[:, 38] = np.linspace(0.0, 0.6, n)
    poses[:, 41] = -poses[:, 38]
    images = rng.uniform(0, 1, (n, res, res, 3)).astype(np.float32)
    for split, sl in (("train", slice(0, n_train)), ("val", slice(n_train, n))):
        datasets.write_dataset(os.path.join(root, split), images[sl],
                               data.camera_transforms[sl], np.pi / 3, poses[sl])
    return root


@pytest.mark.parametrize("model_type,ipb", [("dummy_dynamic", 0), ("dummy_dynamic", 2),
                                            ("append_vertex_locations_to_nerf", 0)])
def test_train_torch_on_cpu_saves_a_run_that_inference_torch_scores(rng, tmp_path, model_type,
                                                                    ipb):
    data_dir = _write_data(rng, str(tmp_path / "data"))
    run_dir = str(tmp_path / "run")
    argv = _argv(model_type, ipb, (f"--dataset_dir={data_dir}", "--num_epochs=1",
                                   "--steps_per_epoch=2", "--batchsize=32", "--use_pallas=0",
                                   "--batchsize_val=256",
                                   "--render_gif=1", "--use_gmm_loss=1"))
    sol = train_cli.train(argv, log_dir=run_dir, device="cpu")
    assert len(sol.history["step_loss"]) == 2 and np.isfinite(sol.history["step_loss"]).all()
    names = set(os.listdir(run_dir))
    assert {"config.txt", "model_coarse.pt", "model_smpl_estimator.pt"} <= names
    assert ("model_vertex_embedder.pt" in names) == (model_type != "dummy_dynamic")
    assert "inference.gif" not in names                   # not a GIF family, as in JAX
    table = torch.load(os.path.join(run_dir, "model_smpl_estimator.pt"))["goal_poses"]
    assert table.shape == (3, 69)
    save_dir = str(tmp_path / "inf")
    scores = inference.inference([f"--inf_run_dir={run_dir}",
                                  f"--inf_ground_truth_dir={data_dir}/val",
                                  f"--inf_save_dir={save_dir}", "--inf_batchsize=256",
                                  "--device=cpu"])
    with open(os.path.join(save_dir, "scores.json")) as fh:
        saved = json.load(fh)
    assert np.isfinite(saved["psnr"]) and saved["psnr"] == pytest.approx(scores["psnr"])
    assert sorted(n for n in os.listdir(save_dir) if n.endswith(".png")) == [
        "img_000.png", "img_001.png"]
    # the culled renderers render these families in full, as the JAX package's do
    for fast in (1, 2):
        culled = inference.inference([f"--inf_run_dir={run_dir}",
                                      f"--inf_ground_truth_dir={data_dir}/val",
                                      f"--inf_save_dir={tmp_path / f'fast{fast}'}",
                                      "--inf_batchsize=256", f"--inf_fast={fast}",
                                      "--device=cpu"])
        assert culled == scores


def test_image_wise_train_torch_moves_the_arm_angles(rng, tmp_path):
    data_dir = _write_data(rng, str(tmp_path / "data"), n_train=2)
    coarse_run = str(tmp_path / "coarse")
    train_cli.train(_argv("dummy_dynamic", 0, (f"--dataset_dir={data_dir}", "--num_epochs=1",
                                                "--steps_per_epoch=1", "--batchsize=32",
                                                "--render_gif=0")),
                    log_dir=coarse_run, device="cpu")
    run_dir = str(tmp_path / "image_wise")
    final, errors = train_cli.train(
        _argv("image_wise_dynamic", 0, (f"--dataset_dir={data_dir}", "--num_epochs=2",
                                        "--batchsize=32", f"--load_coarse_model={coarse_run}",
                                        "--lrate_pose=0.05", "--warp_radius=0.05")),
        log_dir=run_dir, device="cpu")
    assert len(errors) == 2 and np.isfinite(errors).all()
    est = final["smpl_estimator"]
    assert float(est["arm_angle_l"].abs() + est["arm_angle_r"].abs()) > 0   # they moved
    coarse = torch.load(os.path.join(coarse_run, "model_coarse.pt"))
    for key, value in final["model_coarse"].items():                         # frozen
        assert torch.equal(value, coarse[key]), key
    with open(os.path.join(run_dir, "pose_errors.json")) as fh:
        assert json.load(fh)["pose_errors"] == pytest.approx(errors)
    assert inference.setup_from_run_dir(run_dir).model_type == "image_wise_dynamic"
