"""The port's smpl, warp and vertex_sphere families against the JAX package, on the CPU.

Both vertex-sphere warp functions (nearest and mean, ties, the radius edge, a
vertex count that is no multiple of the 512-vertex chunk), the loaders of the
three families on JAX-generated splits (array by array: the four z paths of
vertex_sphere and its in-step path with and without --images_per_batch),
their pipelines on shared weights (`params_from_jax`), `gather_batch` with an
'_itable' key, the in-step guard of `check_batch_images`, the supervised warp
loss and its step (the nets do not move), tiny `train_torch.train` runs of
every family from a JAX-written run (--load_run), whose losses equal JAX's on
the same batches, and `inference()` on JAX-written run dirs.

Sizes: 16x16 views (6 train, 3 val from a 3-camera circle x 2 arm angles),
2-layer 32-wide nets, 8 coarse samples, the procedural human at rings=3,
segments=6 (the loaders and pipelines) or the default one (the CLI runs, as
both CLIs pick it). Every comparison feeds both sides the same inputs.

Tolerances, each with its reason:
  * vertex-sphere warps: the same float32 distances in both packages (ties
    exact by construction); the mean path sums in another order: 1e-6.
  * loaders: z values and samples 1e-6 (the disparity bins come out of
    jnp.linspace and torch.linspace, an ulp apart); warps 1e-5 (LBS vertices
    differ by float32 rounding, ~6e-8). The intersection z paths take the JAX
    package's hits (`_jax_hits`), so that both loaders draw from one stream.
  * pipelines: rgb 1e-5, warp 1e-5, densities 1e-4 relative to their largest.
  * training losses: the first step's 1e-5 relative, the second's (after one
    Adam step from the same weights) 1e-4.
  * inference scores 1e-4 relative (as tests/test_torch_port_inference.py).
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.cli import inference as jax_inference
from smpl_nerf_tpu.cli import train as jax_train_cli
from smpl_nerf_tpu.data import datasets as jax_datasets
from smpl_nerf_tpu.data import generate as jax_generate
from smpl_nerf_tpu.models import smpl as jax_smpl
from smpl_nerf_tpu.ops import raymesh as jax_raymesh
from smpl_nerf_tpu.ops import vertex_sphere as jax_vs
from smpl_nerf_tpu.training import checkpoints as jax_checkpoints
from smpl_nerf_tpu.training import factory as jax_factory
from smpl_nerf_tpu.training import solver as jax_solver
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch import pipelines
from smpl_nerf_tpu_torch.cli import inference
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models import smpl
from smpl_nerf_tpu_torch.ops import raymesh, vertex_sphere
from smpl_nerf_tpu_torch.training import checkpoints, factory, solver

RES = 16
WARP_ATOL, Z_ATOL, FIELD_ATOL = 1e-6, 1e-6, 1e-5
RGB_ATOL, DENSITY_REL, LOSS_REL, LOSS_REL_2, SCORE_REL = 1e-5, 1e-4, 1e-5, 1e-4, 1e-4


def to_np(t):
    return t.detach().float().cpu().numpy()


# ------------------------------------------------------ vertex-sphere warps

def _sphere_inputs(rng, R=5, S=7, V=600):
    goal = rng.uniform(-0.5, 0.5, (V, 3)).astype(np.float32)
    warps = rng.uniform(-0.2, 0.2, (V, 3)).astype(np.float32)
    samples = (goal[rng.randint(0, V, (R, S))]
               + 0.04 * rng.randn(R, S, 3)).astype(np.float32)
    return samples, goal, warps


@pytest.mark.parametrize("by_mean", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
def test_vertex_sphere_warps_match_jax(rng, by_mean, per_ray):
    """600 vertices (a 512 chunk and a padded one), radius 0.05: some samples
    in one sphere, some in several, some in none."""
    samples, goal, warps = _sphere_inputs(rng)
    R = samples.shape[0]
    if per_ray:
        goal = np.stack([goal + 0.01 * i for i in range(R)])
        warps = np.stack([warps * (1 + 0.1 * i) for i in range(R)])
        jfn = jax_vs.sample_warps_by_vertex_sphere_rays
        pfn = vertex_sphere.sample_warps_by_vertex_sphere_rays
    else:
        jfn = jax_vs.sample_warps_by_vertex_sphere
        pfn = vertex_sphere.sample_warps_by_vertex_sphere
    want = np.asarray(jfn(jnp.asarray(samples), jnp.asarray(goal), jnp.asarray(warps), 0.05,
                          by_mean))
    got = to_np(pfn(torch.from_numpy(samples), torch.from_numpy(goal), torch.from_numpy(warps),
                    0.05, by_mean))
    moved = np.abs(want).max(-1) > 0
    assert 0.2 < moved.mean() < 1.0                     # inside and outside both occur
    np.testing.assert_allclose(got, want, atol=WARP_ATOL)


def test_the_two_nearest_vertex_rules_on_a_tie_and_the_radius_edge():
    """A sample equidistant from two vertices (exactly, by symmetry): the
    precompute path takes the first vertex, the in-step path the mean of the
    two; a sample at exactly the radius gets no warp (strict <)."""
    goal = np.zeros((700, 3), np.float32) + 5.0
    goal[10] = [-0.125, 0.0, 0.0]
    goal[600] = [0.125, 0.0, 0.0]                         # in the second (padded) chunk
    goal[20] = [2.0, 0.0, 0.0]
    warps = np.zeros((700, 3), np.float32)
    warps[10] = [1.0, 0.0, 0.0]
    warps[600] = [0.0, 2.0, 0.0]
    warps[20] = [0.0, 0.0, 3.0]
    goal[30] = [-0.125, 0.5, 0.0]
    goal[40] = [0.125, 0.5, 0.0]                          # a tie inside one chunk
    warps[30] = [4.0, 0.0, 0.0]
    warps[40] = [0.0, 4.0, 0.0]
    samples = np.asarray([[[0.0, 0.0, 0.0], [0.0, 0.5, 0.0], [2.25, 0.0, 0.0]]], np.float32)
    radius = 0.25                                         # the third sample sits on the edge
    args = (jnp.asarray(samples), jnp.asarray(goal), jnp.asarray(warps), radius)
    want_pre = np.asarray(jax_vs.sample_warps_by_vertex_sphere(*args))
    want_rays = np.asarray(jax_vs.sample_warps_by_vertex_sphere_rays(
        jnp.asarray(samples), jnp.asarray(goal[None]), jnp.asarray(warps[None]), radius))
    pre = to_np(vertex_sphere.sample_warps_by_vertex_sphere(
        torch.from_numpy(samples), torch.from_numpy(goal), torch.from_numpy(warps), radius))
    rays = to_np(vertex_sphere.sample_warps_by_vertex_sphere_rays(
        torch.from_numpy(samples), torch.from_numpy(goal[None]), torch.from_numpy(warps[None]),
        radius))
    np.testing.assert_array_equal(pre, want_pre)
    np.testing.assert_array_equal(rays, want_rays)
    # across chunks the earlier chunk keeps the tie in both paths
    np.testing.assert_array_equal(pre[0, 0], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(rays[0, 0], [1.0, 0.0, 0.0])
    # inside a chunk: the first index, against the mean
    np.testing.assert_array_equal(pre[0, 1], [4.0, 0.0, 0.0])
    np.testing.assert_array_equal(rays[0, 1], [2.0, 2.0, 0.0])
    np.testing.assert_array_equal(pre[0, 2], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(rays[0, 2], [0.0, 0.0, 0.0])


# ------------------------------------------------------------------ datasets

def _generate(root, dataset_type):
    parser = jax_config.dataset_config_parser()
    args = parser.parse_args([
        f"--save_dir={root}", f"--dataset_type={dataset_type}", f"--resolution={RES}",
        "--camera_path=circle", "--number_steps=3", "--multi_human_pose=1",
        "--human_number_steps=3", "--human_start_angle=0", "--human_end_angle=60",
        "--train_val_ratio=0.67"])
    jax_generate.create_dataset(args, parser)
    return str(root)


@pytest.fixture(scope="module")
def smpl_dir(tmp_path_factory):
    return _generate(tmp_path_factory.mktemp("ds_smpl"), "smpl")


@pytest.fixture(scope="module")
def smpl_nerf_dir(tmp_path_factory):
    return _generate(tmp_path_factory.mktemp("ds_smpl_nerf"), "smpl_nerf")


@pytest.fixture(scope="module")
def small_humans():
    return jax_smpl.procedural_human(3, 6), smpl.procedural_human(3, 6)


def _argv(model_type, extra=()):
    return ["--config=/dev/null", f"--model_type={model_type}", "--netdepth=2",
            "--netwidth=32", "--skips=0", "--netdepth_fine=2", "--netwidth_fine=32",
            "--skips_fine=0", "--netwidth_warp=16", "--number_coarse_samples=8",
            "--number_frequencies_postitional=4", "--number_frequencies_directional=2",
            "--number_frequencies_pose=2", "--human_pose_encoding=1", "--sigma_noise_std=0",
            "--white_background=1", "--near=1", "--far=4", "--vertex_sphere_radius=0.08",
            "--std_dev_coarse_sample_prior=0.05", "--batchsize=64", "--batchsize_val=128",
            "--lrate=1e-3", "--number_validation_images=0", "--render_gif=0", *extra]


def _load_both(directory, model_type, extra, humans, seed=5):
    """(JAX RayData, port RayData) of one split, the global numpy generator
    seeded the same before each load."""
    jargs = jax_config.config_parser().parse_args(_argv(model_type, extra))
    pargs = port_config.config_parser().parse_args(_argv(model_type, extra))
    jargs._smpl_model, pargs._smpl_model = humans
    np.random.seed(seed)
    want = jax_datasets.load_dataset(directory, model_type, jargs)
    np.random.seed(seed)
    got = datasets.load_dataset(directory, model_type, pargs, device="cpu")
    return want, got, jargs, pargs


def _jax_hits(monkeypatch, want, humans, multi):
    """Make the port loader intersect through the JAX package, image by image
    on JAX's goal meshes, so both loaders place their samples from the same
    hits. (The GMM prior draws `randint(0, n_hits)` per ray from one stream,
    so a single ray whose hit count differs would shift every later draw; the
    intersections themselves are held against JAX in
    tests/test_torch_port_generate.py.)"""
    jm, _ = humans
    goals = iter([np.asarray(jax_smpl.smpl_forward(jm, jnp.zeros(10), jnp.asarray(pose)))
                  for pose in want.human_poses])
    faces = jnp.asarray(jm.faces)

    def multi_hits(o, d, verts, f, **kw):
        t, hit = jax_raymesh.intersect_rays_multi(jnp.asarray(to_np(o)), jnp.asarray(to_np(d)),
                                                  jnp.asarray(next(goals)), faces)
        return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(hit))

    def first_hits(o, d, verts, f, **kw):
        h = jax_raymesh.intersect_rays(jnp.asarray(to_np(o)), jnp.asarray(to_np(d)),
                                       jnp.asarray(next(goals)), faces)
        return raymesh.RayHits(*(torch.from_numpy(np.array(x)) for x in h))

    if multi:
        monkeypatch.setattr(raymesh, "intersect_rays_multi", multi_hits)
    else:
        monkeypatch.setattr(raymesh, "intersect_rays", first_hits)


def _assert_same_batch_arrays(want, got, model_type):
    wa, ga = want.batch_arrays(model_type), got.batch_arrays(model_type)
    assert set(ga) == set(wa)
    for key, value in wa.items():
        np.testing.assert_allclose(np.asarray(ga[key], np.float64), np.asarray(value, np.float64),
                                   atol=FIELD_ATOL, err_msg=key)


@pytest.mark.parametrize("model_type", ["smpl", "warp"])
def test_single_sample_loaders_match_jax(smpl_dir, small_humans, model_type):
    for split in ("train", "val"):
        want, got, _, _ = _load_both(os.path.join(smpl_dir, split), model_type, (), small_humans)
        for field in ("origins", "directions", "rgb", "image_indices", "human_poses",
                      "surface_samples", "warp", "depth"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
        assert got.depth.dtype == np.float32 and (got.depth == 4.0).any()     # misses at --far
        _assert_same_batch_arrays(want, got, model_type)


@pytest.mark.parametrize("extra,multi", [
    ((), None), (("--warp_by_vertex_mean=1",), None),
    (("--coarse_samples_from_prior=1",), True), (("--coarse_samples_from_intersect=1",), False),
    (("--number_coarse_samples=1",), False)])
def test_vertex_sphere_precompute_loader_matches_jax(monkeypatch, smpl_nerf_dir, small_humans,
                                                     extra, multi):
    """The shared jitter, the GMM prior, the intersection path and S == 1."""
    directory = os.path.join(smpl_nerf_dir, "train")
    if multi is not None:
        want, _, _, _ = _load_both(directory, "vertex_sphere", extra, small_humans)
        _jax_hits(monkeypatch, want, small_humans, multi)
    want, got, _, _ = _load_both(directory, "vertex_sphere", extra, small_humans)
    assert got.vs_goal_verts is None and want.vs_goal_verts is None
    np.testing.assert_array_equal(got.directions, want.directions)
    np.testing.assert_allclose(np.linalg.norm(got.directions, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got.z_vals, want.z_vals, atol=Z_ATOL)
    np.testing.assert_allclose(got.ray_samples, want.ray_samples, atol=Z_ATOL)
    np.testing.assert_allclose(got.sample_warps, want.sample_warps, atol=FIELD_ATOL)
    assert np.abs(want.sample_warps).max() > 1e-2            # some samples warp
    _assert_same_batch_arrays(want, got, "vertex_sphere")


@pytest.mark.parametrize("ipb", [0, 2])
def test_vertex_sphere_in_step_loader_and_gather_match_jax(smpl_nerf_dir, small_humans, ipb):
    """--vertex_sphere_in_step=1: the goal meshes and the jitter, the two
    splits drawing their jitter in turn; gather_batch passes the '_itable'
    through whole, as JAX's does."""
    extra = ("--vertex_sphere_in_step=1", f"--images_per_batch={ipb}")
    jargs = jax_config.config_parser().parse_args(_argv("vertex_sphere", extra))
    pargs = port_config.config_parser().parse_args(_argv("vertex_sphere", extra))
    jargs._smpl_model, pargs._smpl_model = small_humans
    loads = {}
    for name, loader, args, kw in (("jax", jax_datasets.load_dataset, jargs, {}),
                                   ("port", datasets.load_dataset, pargs, {"device": "cpu"})):
        np.random.seed(7)
        loads[name] = [loader(os.path.join(smpl_nerf_dir, s), "vertex_sphere", args, **kw)
                       for s in ("train", "val")]
    for want, got in zip(loads["jax"], loads["port"]):
        assert got.ray_samples is None and got.vs_goal_verts.shape == want.vs_goal_verts.shape
        np.testing.assert_allclose(got.vs_z, want.vs_z, atol=Z_ATOL)
        np.testing.assert_allclose(got.vs_goal_verts, want.vs_goal_verts, atol=FIELD_ATOL)
        _assert_same_batch_arrays(want, got, "vertex_sphere")
    assert not np.allclose(loads["port"][0].vs_z, loads["port"][1].vs_z)    # one draw per split
    want, got = loads["jax"][0], loads["port"][0]
    hw = RES * RES
    idx = np.concatenate([np.arange(5, 25), 3 * hw + np.arange(40, 50)])
    wbatch = jax_solver.gather_batch({k: jnp.asarray(v) for k, v in
                                      want.batch_arrays("vertex_sphere").items()},
                                     jnp.asarray(idx))
    gbatch = solver.gather_batch({k: torch.as_tensor(v) for k, v in
                                  got.batch_arrays("vertex_sphere").items()}, torch.as_tensor(idx))
    assert set(gbatch) == set(wbatch) == {"ray_translation", "ray_direction", "rgb",
                                          "image_indices", "human_pose", "goal_verts_itable",
                                          "vs_z"}
    assert gbatch["goal_verts_itable"].shape == got.vs_goal_verts.shape          # whole
    for key, value in wbatch.items():
        np.testing.assert_allclose(to_np(gbatch[key]), np.asarray(value), atol=FIELD_ATOL,
                                   err_msg=key)


def test_check_batch_images_guards_in_step_vertex_sphere_like_jax(smpl_nerf_dir, small_humans):
    extra = ("--vertex_sphere_in_step=1", "--images_per_batch=2")
    want, got, jargs, pargs = _load_both(os.path.join(smpl_nerf_dir, "train"), "vertex_sphere",
                                         extra, small_humans)
    jpipe, params, ppipe = _both("vertex_sphere", extra, small_humans)
    jsol = jax_solver.Solver(jpipe, params, jargs)
    img = got.image_indices
    hw = RES * RES
    for arrays_kind in ("in_step", "precomputed"):
        arrays = got.batch_arrays("vertex_sphere") if arrays_kind == "in_step" else {}
        for idx, raises in ((np.arange(0, 2 * hw), False), (np.arange(0, 3 * hw, 3), True)):
            outcome = []
            for check in (lambda: jsol._check_batch_images(idx, img, arrays),
                          lambda: solver.check_batch_images(ppipe.cfg, idx, img, arrays)):
                try:
                    check()
                    outcome.append(False)
                except ValueError as e:
                    assert "images_per_batch=2" in str(e)
                    outcome.append(True)
            assert outcome == [raises and arrays_kind == "in_step"] * 2, (arrays_kind, idx[:3])


# ----------------------------------------------------------------- pipelines

def _both(model_type, extra, humans, seed=0):
    """(JAX pipeline, its params, port pipeline) on shared weights."""
    jm, pm = humans
    argv = _argv(model_type, extra)
    jargs = jax_config.config_parser().parse_args(argv)
    jextras = {"smpl_model": jm, "betas": np.zeros(10, np.float32), "num_vertices": jm.num_vertices}
    jmodels, params, jenc = jax_factory.build_models_and_params(jargs, jax.random.PRNGKey(seed),
                                                                jextras)
    rs = np.random.RandomState(seed + 1)       # non-zero biases: a misplaced one shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                         if path[-1].key == "bias" else 0.0),
        jax.device_get(params))
    jpipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs), jmodels,
                                         jenc, jextras)
    pargs = port_config.config_parser().parse_args(argv)
    pextras = {"smpl_model": pm, "betas": np.zeros(10, np.float32), "num_vertices": pm.num_vertices}
    models, encoders = factory.build_models_and_params(pargs, device="cpu", extras=pextras)
    for name, sd in checkpoints.params_from_jax(params).items():
        models[name].load_state_dict(sd)
    ppipe = pipelines.build_pipeline(pipelines.RenderConfig.from_args(pargs), models, encoders,
                                     pextras)
    return jpipe, params, ppipe


def _batches(data, model_type, idx):
    arrays = data.batch_arrays(model_type)
    jbatch = jax_solver.gather_batch({k: jnp.asarray(v) for k, v in arrays.items()},
                                     jnp.asarray(idx))
    pbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jbatch, pbatch


def _assert_outputs(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        if key == "densities":
            np.testing.assert_allclose(to_np(got[key]), value,
                                       atol=DENSITY_REL * max(1.0, np.abs(value).max()))
        else:
            np.testing.assert_allclose(to_np(got[key]), value, atol=RGB_ATOL, err_msg=key)


@pytest.mark.parametrize("model_type,extra,ipb_idx", [
    ("smpl", (), False), ("smpl", ("--use_fused_mlp=1",), False), ("warp", (), False),
    ("warp", ("--human_pose_encoding=0",), False),
    ("vertex_sphere", (), False), ("vertex_sphere", ("--use_fused_mlp=1",), False),
    ("vertex_sphere", ("--vertex_sphere_in_step=1",), False),
    ("vertex_sphere", ("--vertex_sphere_in_step=1", "--images_per_batch=2"), True),
    ("vertex_sphere", ("--vertex_sphere_in_step=1", "--warp_by_vertex_mean=1"), False)])
def test_family_pipelines_match_jax(smpl_dir, smpl_nerf_dir, small_humans, rng, model_type,
                                    extra, ipb_idx):
    """smpl runs the plain net even under --use_fused_mlp=1 (as JAX's .apply);
    vertex_sphere under mode 1 runs kernel D's plain version on the CPU."""
    directory = smpl_dir if model_type in ("smpl", "warp") else smpl_nerf_dir
    want_data, _, _, _ = _load_both(os.path.join(directory, "train"), model_type, extra,
                                    small_humans)
    jpipe, params, ppipe = _both(model_type, extra, small_humans)
    # mostly rays that see the body (not the white background)
    fg = np.any(want_data.rgb < 0.98, -1)
    if ipb_idx:                                    # the rays of two images
        fg &= np.isin(want_data.image_indices, [1, 4])
    fg_idx, bg_idx = np.where(fg)[0], np.where(~fg)[0]
    idx = np.concatenate([rng.choice(fg_idx, 40), rng.choice(bg_idx, 8)])
    if ipb_idx:
        idx[40:] = rng.choice(np.where(np.isin(want_data.image_indices, [1, 4]))[0], 8)
    jbatch, pbatch = _batches(want_data, model_type, idx)
    want = jpipe(params, jbatch, None, False)
    with torch.no_grad():
        got = ppipe(pbatch)
    _assert_outputs(got, want)
    if model_type == "vertex_sphere":
        assert np.abs(np.asarray(want["warp"])).max() > 1e-2
        assert not ppipe.cfg.has_fine


# ------------------------------------------------------------ loss and steps

def test_warp_loss_and_step_train_the_warp_field_only(smpl_dir, small_humans, rng):
    """The warp loss equals JAX's before and after one Adam step from the same
    weights; the coarse and fine nets come out of the step unchanged."""
    want_data, _, jargs, pargs = _load_both(os.path.join(smpl_dir, "train"), "warp", (),
                                            small_humans)
    jpipe, params, ppipe = _both("warp", (), small_humans)
    jbatch, pbatch = _batches(want_data, "warp", rng.randint(0, want_data.num_rays, 64))
    jloss = jax_solver.make_loss_fn(jpipe)
    tx = jax_solver.make_optimizer(params, jargs, "warp")

    @jax.jit
    def jax_step(params):
        (_, aux1), grads = jax.value_and_grad(jloss, has_aux=True)(params, jbatch, None, True)
        params2 = optax.apply_updates(params, tx.update(grads, tx.init(params), params)[0])
        return aux1, jloss(params2, jbatch, None, True)[1], params2

    aux1, aux2, params2 = jax_step(params)
    sol = solver.Solver(ppipe, pargs)
    before = {k: {n: v.clone() for n, v in m.state_dict().items()} for k, m in ppipe.models.items()}
    got1 = sol.train_step(pbatch, None)
    _, got2 = sol.loss_fn(pbatch, None, True)
    assert set(got1) == set(aux1) == {"loss", "loss_coarse", "loss_fine"}
    assert float(got1["loss"]) == pytest.approx(float(aux1["loss"]), rel=LOSS_REL)
    assert float(got2["loss"].detach()) == pytest.approx(float(aux2["loss"]), rel=LOSS_REL_2)
    assert float(got2["loss"].detach()) < float(got1["loss"])
    for key in ("model_coarse", "model_fine"):
        for name, value in ppipe.models[key].state_dict().items():
            assert torch.equal(value, before[key][name]), (key, name)
        for a, b in zip(jax.tree_util.tree_leaves(params2[key]),
                        jax.tree_util.tree_leaves(params[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert any(not torch.equal(v, before["model_warp_field"][n])
               for n, v in ppipe.models["model_warp_field"].state_dict().items())


# ------------------------------------------------------- the CLI, end to end

def _jax_run_dir(root, model_type, extra):
    """A JAX-written run dir (msgpack + the exported model_*.pt) of seeded weights."""
    parser = jax_config.config_parser()
    args = parser.parse_args(_argv(model_type, extra))
    extras = {"smpl_model": jax_smpl.procedural_human(), "betas": np.zeros(10, np.float32)}
    _, params, _ = jax_factory.build_models_and_params(args, jax.random.PRNGKey(3), extras)
    rs = np.random.RandomState(4)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + (0.05 * rs.randn(*p.shape).astype(np.float32)
                                   if p.ndim == 1 else 0.0), jax.device_get(params))
    run_dir = str(root / f"jax_{model_type}_{len(extra)}")
    jax_checkpoints.save_run(run_dir, params, args, parser)
    jax_checkpoints.export_torch_run(run_dir, run_dir)
    return run_dir


@pytest.mark.parametrize("model_type,extra", [
    ("smpl", ()), ("warp", ()), ("vertex_sphere", ()),
    ("vertex_sphere", ("--vertex_sphere_in_step=1",)),
    ("vertex_sphere", ("--vertex_sphere_in_step=1", "--images_per_batch=2",
                       "--batchsize_val=64"))])
def test_train_torch_matches_jax_losses_and_inference_scores(smpl_dir, smpl_nerf_dir, tmp_path,
                                                             model_type, extra):
    """Both CLIs train 2 epochs of one step from the same JAX-written weights
    (--load_run): the same batches (RandomState(seed) permutation or the
    --images_per_batch draws), no sigma noise, the same shared jitter (numpy
    seeded by both CLIs). Then inference() on the JAX run dir, numpy seeded
    the same before each (vertex_sphere's loader draws its jitter there)."""
    directory = smpl_dir if model_type in ("smpl", "warp") else smpl_nerf_dir
    start = _jax_run_dir(tmp_path, model_type, extra)
    argv = _argv(model_type, extra) + [f"--dataset_dir={directory}", "--num_epochs=2",
                                       "--steps_per_epoch=1", f"--load_run={start}"]
    want = jax_train_cli.train(argv, log_dir=str(tmp_path / "jax_run")).history
    sol = train_cli.train(argv, log_dir=str(tmp_path / "port_run"), device="cpu")
    got = sol.history
    assert len(got["step_loss"]) == 2
    assert got["step_loss"][0] == pytest.approx(want["train_loss"][0], rel=LOSS_REL)
    assert got["step_loss"][1] == pytest.approx(want["train_loss"][1], rel=LOSS_REL_2)
    for a, b in zip(got["val_loss"], want["val_loss"]):
        assert a == pytest.approx(b, rel=LOSS_REL_2)
    assert os.path.exists(os.path.join(tmp_path, "port_run", "model_coarse.pt"))

    inf = [f"--inf_run_dir={start}", f"--inf_ground_truth_dir={os.path.join(directory, 'val')}",
           "--inf_batchsize=64"]
    if "--images_per_batch=2" in extra:
        # JAX's render_rays_batched names an undefined `val_arrays` in its
        # --images_per_batch guard, so JAX's inference cannot render this run;
        # the port's renders every batch within one image
        got_scores = inference.inference(inf + [f"--inf_save_dir={tmp_path / 'port_inf'}",
                                                "--device=cpu"])
        assert all(np.isfinite(v) for v in got_scores.values())
        return
    np.random.seed(11)
    want_scores = jax_inference.inference(inf + [f"--inf_save_dir={tmp_path / 'jax_inf'}"])
    np.random.seed(11)
    got_scores = inference.inference(inf + [f"--inf_save_dir={tmp_path / 'port_inf'}",
                                            "--device=cpu"])
    assert list(got_scores) == list(want_scores)
    for key, value in want_scores.items():
        assert got_scores[key] == pytest.approx(value, rel=SCORE_REL, abs=1e-7), key
    assert sorted(os.listdir(tmp_path / "port_inf")) == sorted(os.listdir(tmp_path / "jax_inf"))
