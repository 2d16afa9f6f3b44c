"""The port's occupancy grid and culled renderers against the JAX package.

`ops/occupancy.py` (lattice, bake, dilation, trilinear and nearest lookups,
ray_scores and its probe-count checks), `render/fast.py`
(`make_fast_renderer`, `make_occupancy_renderer`, their top-K order) and the
auto cull budget of `cli/inference.py` (`_worst_batch_count`,
`_auto_cap_fraction`) against their JAX counterparts. Sizes follow
tests/test_torch_port_slice.py: 3 layers of width 32, 8 coarse + 16 fine
samples, 64 rays, G=16 where the caller picks the grid (the budget helpers
bake at the JAX default, G=64); weights drawn by the JAX factory and carried
over with `params_from_jax`; the port runs on device="cpu".

Tolerances: grid values, lookups and ray scores 1e-6 (the same float32
arithmetic; the probe distances bit for bit); rgb 2e-3, as the slice's
rgb_fine (a fine sample can flip an inverse-CDF bin); cap 1.0 against the
port's own full pipeline 1e-5 (the same computation on the same rays).
"""
import _torch_threads  # noqa: F401

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smpl_nerf_tpu import config as jax_config
from smpl_nerf_tpu import pipelines as jax_pipelines
from smpl_nerf_tpu.cli import inference as jax_inference
from smpl_nerf_tpu.ops import occupancy as jax_occ
from smpl_nerf_tpu.render import fast as jax_fast
from smpl_nerf_tpu_torch import config as port_config
from smpl_nerf_tpu_torch.cli import inference, render_path
from smpl_nerf_tpu_torch.ops import occupancy
from smpl_nerf_tpu_torch.render import fast
from smpl_nerf_tpu_torch.training import checkpoints, factory
from tests.test_torch_port_slice import _argv, _jax_params, _port_pipeline

AABB = ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0))
G = 16
N_RAYS = 64
FAMILIES = ("nerf", "smpl_nerf", "append_smpl_params")


def _sphere(r=0.5):
    return lambda pts: (pts.norm(dim=-1) < r).float() * 10.0


def _jax_sphere(r=0.5):
    return lambda pts: jnp.where(jnp.linalg.norm(pts, axis=-1) < r, 10.0, 0.0)


# ------------------------------------------------------------ occupancy ops

def test_lattice_bake_and_dilation_match_jax():
    np.testing.assert_allclose(occupancy.lattice(AABB, G).numpy(),
                               np.asarray(jax_occ.lattice(AABB, G)), atol=1e-6)
    for dilate in (0, 1, 2):
        got = occupancy.build_density_grid(_sphere(), AABB, 32, dilate_voxels=dilate)
        want = jax.jit(lambda: jax_occ.build_density_grid(_jax_sphere(), AABB, 32,
                                                          dilate_voxels=dilate))()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    grid = np.random.RandomState(0).uniform(-1, 1, (9, 7, 5)).astype(np.float32)
    np.testing.assert_array_equal(occupancy._dilate_max(torch.from_numpy(grid)).numpy(),
                                  np.asarray(jax_occ._dilate_max(jnp.asarray(grid))))


@pytest.mark.parametrize("lookup", ["trilinear", "nearest"])
def test_lookups_match_jax_inside_and_outside(rng, lookup):
    grid = rng.uniform(0, 5, (G, G, G)).astype(np.float32)
    pts = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    pts[:8] = [[-2, -2, -2], [2, 2, 2], [0, 0, 0], [0.25, 0.25, 0.25], [2.0001, 0, 0],
               [-1.875, 1.875, 0.125], [1.99, -1.99, 1.99], [0, -2, 2]]
    got = getattr(occupancy, lookup)(torch.from_numpy(grid), AABB, torch.from_numpy(pts))
    want = getattr(jax_occ, lookup)(jnp.asarray(grid), AABB, jnp.asarray(pts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[4]) == 0.0                      # outside the box


def test_probe_distances_are_jax_linspace_bit_for_bit():
    for near, far in ((1.0, 4.0), (0.5, 6.0), (2.0, 6.0), (0.1, 3.7), (1.0, 12.0)):
        for n in (2, 3, 17, 49, 97, 193):
            want = jax.jit(lambda: jnp.linspace(near, far, n, dtype=jnp.float32))()
            np.testing.assert_array_equal(occupancy.probe_distances(near, far, n).numpy(),
                                          np.asarray(want))


@pytest.mark.parametrize("method", ["nearest", "trilinear"])
def test_ray_scores_match_jax_on_every_ray(rng, method):
    grid = jax.jit(lambda: jax_occ.build_density_grid(_jax_sphere(0.6), AABB, 64))()
    # axis-aligned rays whose probes (spacing = the voxel size) sit on voxel
    # faces, and random rays
    origins = np.tile(np.asarray([[0.0, 0.0, 2.0]], np.float32), (300, 1))
    dirs = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32)
    dirs[:, 2] = -1.0
    dirs[:40, :2] = np.round(dirs[:40, :2] * 16) / 16
    want = jax.jit(lambda g, o, d: jax_occ.ray_scores(g, AABB, o, d, 1.0, 4.0,
                                                      method=method))(grid, origins, dirs)
    got = occupancy.ray_scores(torch.from_numpy(np.array(grid)), AABB,
                               torch.from_numpy(origins), torch.from_numpy(dirs), 1.0, 4.0,
                               method=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert (got.numpy() > 1.0).any() and (got.numpy() == 0.0).any()


@pytest.mark.parametrize("near,far,n_probe", [(1.0, 4.0, 16), (1.0, 4.0, 48), (1.0, 4.0, 49),
                                              (1.0, 12.0, None), (0.5, 6.0, 89), (0.5, 6.0, 90)])
def test_probe_count_checks_raise_where_jax_raises(near, far, n_probe):
    assert occupancy.required_probes(AABB, 64, near, far) == jax_occ.required_probes(
        AABB, 64, near, far)
    o = np.asarray([[0.0, 0.0, 2.0]], np.float32)
    d = np.asarray([[0.0, 0.0, -1.0]], np.float32)
    try:
        want = np.asarray(jax_occ.ray_scores(jnp.zeros((64, 64, 64)), AABB, o, d, near, far,
                                             n_probe))
    except ValueError:
        with pytest.raises(ValueError, match="not be conservative"):
            occupancy.ray_scores(torch.zeros(64, 64, 64), AABB, torch.from_numpy(o),
                                 torch.from_numpy(d), near, far, n_probe)
        return
    got = occupancy.ray_scores(torch.zeros(64, 64, 64), AABB, torch.from_numpy(o),
                               torch.from_numpy(d), near, far, n_probe)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_orders_ties_like_jax(rng):
    scores = np.zeros(200, np.float32)
    scores[rng.choice(200, 30, replace=False)] = rng.choice([0.5, 1.0, 2.0], 30)
    for k in (1, 10, 30, 31, 77, 200):
        want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
        got_v, got_i = fast.top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------------- renderers

def _pair(model_type, white=1, extra=()):
    """(JAX pipeline, JAX params, port pipeline) on shared weights."""
    argv = _argv(model_type, white_background=white, extra=extra)
    jargs = jax_config.config_parser().parse_args(argv)
    models, params, encoders = _jax_params(jargs, seed=11)
    jax_pipe = jax_pipelines.build_pipeline(jax_pipelines.RenderConfig.from_args(jargs),
                                            models, encoders, {})
    return jax_pipe, params, _port_pipeline(argv, params)


def _batch(rng, n=N_RAYS, spread=0.4):
    origins = np.tile(np.asarray([[0, 0, 2.4]], np.float32), (n, 1))
    dirs = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    dirs[:, 2] = -1
    pose = np.zeros((n, 69), np.float32)
    pose[:, [38, 41]] = rng.uniform(-0.5, 0.5, (1, 2))
    return {"ray_translation": origins, "ray_direction": dirs, "human_pose": pose}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _occ(make, pipe, **kw):
    return make(pipe, grid_resolution=G, aabb=AABB, **kw)


def _shift_sigma(port, params, delta):
    """The coarse and fine sigma heads' bias shifted by delta on both sides."""
    for key in ("model_coarse", "model_fine"):
        params[key]["params"]["sigma_out_layer"]["bias"] = (
            params[key]["params"]["sigma_out_layer"]["bias"] + delta)
        with torch.no_grad():
            port.models[key].sigma_out_layer.bias += delta
    return params


def _boundary(scores: torch.Tensor, k: int) -> tuple:
    """The k-th and (k+1)-th largest scores."""
    s = torch.sort(scores, descending=True)[0]
    return float(s[k - 1]), float(s[k])


# (family, sigma bias shift, cap): a random net's coarse opacity is exactly 1
# (within an ulp) on every ray whose last sample has density (its interval is
# 1e10 long), so the budget's boundary must fall where the opacities are
# apart, or on exact zeros, whose order both packages take from the index
@pytest.mark.parametrize("model_type,delta,cap", [
    ("nerf", 0.0, 0.5), ("smpl_nerf", 0.0, 0.5), ("append_smpl_params", -0.5, 0.75),
    ("nerf", -0.5, 0.5),          # 5 rays with opacity, the budget's rest on tied zeros
])
def test_fast_render_matches_jax(rng, model_type, delta, cap):
    jax_pipe, params, port = _pair(model_type)
    params = _shift_sigma(port, params, delta)
    batch = _batch(rng)
    k = int(N_RAYS * cap)
    passes = port.passes
    with torch.no_grad():
        tb = _torch(batch)
        acc = passes.coarse(tb["ray_translation"], tb["ray_direction"], passes.pose(tb))[0].acc
    kth, next_ = _boundary(acc, k)
    assert kth - next_ > 1e-4 or kth == next_ == 0.0
    want = jax.jit(jax_fast.make_fast_renderer(jax_pipe, cap))(params, _jax(batch))
    got = fast.make_fast_renderer(port, cap)(_torch(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_occupancy_render_matches_jax(rng, model_type):
    jax_pipe, params, port = _pair(model_type)
    batch = _batch(rng)
    render = _occ(fast.make_occupancy_renderer, port, cap_fraction=0.5)
    tb = _torch(batch)
    kth, next_ = _boundary(render.ray_scores(render.build_grid(tb), tb["ray_translation"],
                                             tb["ray_direction"]), N_RAYS // 2)
    assert kth - next_ > 1e-4 or kth == next_     # apart, or one voxel's value in both
    want = jax.jit(_occ(jax_fast.make_occupancy_renderer, jax_pipe, cap_fraction=0.5))(
        params, _jax(batch))
    np.testing.assert_allclose(render(tb).numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_grid_bake_matches_jax_and_a_prebuilt_grid_is_reused(rng, model_type):
    jax_pipe, params, port = _pair(model_type)
    batch = _batch(rng)
    jax_render = _occ(jax_fast.make_occupancy_renderer, jax_pipe, cap_fraction=0.5)
    render = _occ(fast.make_occupancy_renderer, port, cap_fraction=0.5)
    grid = render.build_grid(_torch(batch))
    want = np.asarray(jax.jit(jax_render.build_grid)(params, _jax(batch)))
    assert grid.shape == (G, G, G)
    np.testing.assert_allclose(grid.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(render(_torch(batch), grid).numpy(),
                                  render(_torch(batch)).numpy())


@pytest.mark.parametrize("model_type", FAMILIES)
def test_cap_one_equals_the_full_pipeline(rng, model_type):
    _, _, port = _pair(model_type)
    batch = _torch(_batch(rng))
    with torch.no_grad():
        full = port(batch)["rgb_fine"].numpy()
    np.testing.assert_allclose(fast.make_fast_renderer(port, 1.0)(batch).numpy(), full,
                               atol=1e-5)
    occ = _occ(fast.make_occupancy_renderer, port, cap_fraction=1.0)
    np.testing.assert_allclose(occ(batch).numpy(), full, atol=1e-5)


def test_occupancy_selects_the_rays_jax_selects_on_tied_zero_scores(rng):
    """A small sphere grid: most rays score 0, and the budget takes some of
    them; JAX's top_k takes the lowest indices among the ties, so must the port."""
    jax_pipe, params, port = _pair("nerf")
    batch = _batch(rng, spread=0.6)
    grid = jax.jit(lambda: jax_occ.build_density_grid(_jax_sphere(0.3), AABB, G))()
    scores = np.asarray(jax.jit(lambda g, o, d: jax_occ.ray_scores(g, AABB, o, d, 1.0, 4.0))(
        grid, batch["ray_translation"], batch["ray_direction"]))
    hits = int((scores > 0).sum())
    assert 0 < hits < N_RAYS // 2
    want = np.asarray(jax.jit(_occ(jax_fast.make_occupancy_renderer, jax_pipe,
                                   cap_fraction=0.5))(params, _jax(batch), grid))
    got = _occ(fast.make_occupancy_renderer, port, cap_fraction=0.5)(
        _torch(batch), torch.from_numpy(np.array(grid))).numpy()
    selected_want, selected_got = (want != 1.0).any(-1), (got != 1.0).any(-1)
    assert selected_want.sum() == N_RAYS // 2
    np.testing.assert_array_equal(selected_got, selected_want)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("delta,warned", [(5.0, True), (-100.0, False)])
def test_saturation_warning_like_jax(rng, capfd, delta, warned):
    jax_pipe, params, port = _pair("nerf")
    params = _shift_sigma(port, params, delta)
    batch = _batch(rng)
    jax.jit(_occ(jax_fast.make_occupancy_renderer, jax_pipe, cap_fraction=0.25))(
        params, _jax(batch))
    jax.effects_barrier()
    jax_out = capfd.readouterr()
    got = _occ(fast.make_occupancy_renderer, port, cap_fraction=0.25)(_torch(batch))
    port_out = capfd.readouterr().out
    assert ("saturated" in jax_out.out + jax_out.err) is warned
    assert ("saturated" in port_out) is warned
    silent = _occ(fast.make_occupancy_renderer, port, cap_fraction=0.25,
                  warn_saturation=False)(_torch(batch))
    assert "saturated" not in capfd.readouterr().out
    np.testing.assert_array_equal(silent.numpy(), got.numpy())


def test_no_fine_pass_renders_the_full_pipeline_and_background_warns(rng):
    jax_pipe, params, port = _pair("nerf", white=0, extra=("--run_fine=0",))
    batch = _batch(rng)
    with torch.no_grad():
        full = port(_torch(batch))["rgb_fine"].numpy()
    for render in (fast.make_fast_renderer(port),
                   _occ(fast.make_occupancy_renderer, port)):
        np.testing.assert_array_equal(render(_torch(batch)).numpy(), full)
    np.testing.assert_allclose(
        full, np.asarray(jax.jit(jax_fast.make_fast_renderer(jax_pipe))(params, _jax(batch))),
        atol=2e-4)
    _, _, port = _pair("nerf", white=0)
    with pytest.warns(UserWarning, match="white_background"):
        _occ(fast.make_occupancy_renderer, port)


# ------------------------------------------------------ the auto cull budget

def test_worst_batch_count_equals_jax(rng):
    for n, bs in ((100, 64), (100, 7), (64, 64), (37, 100), (1000, 48)):
        for density in (0.0, 0.05, 0.5, 1.0):
            fg = rng.uniform(size=n) < density
            fg[-1] = rng.uniform() < 0.5
            assert inference._worst_batch_count(fg, bs) == jax_inference._worst_batch_count(
                fg, bs)


class _Rays:
    def __init__(self, origins, dirs, num_images):
        self.origins, self.directions = origins, dirs
        self.num_rays, self.num_images = origins.shape[0], num_images


@pytest.mark.parametrize("delta", [5.0, 0.0])
@pytest.mark.parametrize("per_pose", [False, True])
def test_auto_cap_fraction_equals_jax(rng, delta, per_pose):
    jax_pipe, params, port = _pair("append_smpl_params")
    params = _shift_sigma(port, params, delta)
    n_img, per_img = 2, 40
    batch = _batch(rng, n_img * per_img, spread=0.8)
    poses = rng.uniform(-0.5, 0.5, (n_img, 69)).astype(np.float32)
    data = _Rays(batch["ray_translation"], batch["ray_direction"], n_img)
    want, want_grids = jax_inference._auto_cap_fraction(
        jax_pipe, params, data, poses, per_pose, 16, return_grids=True)
    got, got_grids = inference._auto_cap_fraction(port, data, poses, per_pose, 16)
    assert got == want
    assert len(got_grids) == len(want_grids) == (n_img if per_pose else 1)
    for g, w in zip(got_grids, want_grids):
        assert g.device.type == "cpu"
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_auto_cap_scores_in_chunks_as_in_one_piece(rng):
    """Over SCORE_CHUNK rays the probe pass scores in chunks; the derived
    budget equals the one from scoring every ray at once."""
    _, params, port = _pair("nerf")
    n, bs = 70000, 100
    batch = _batch(rng, n, spread=0.8)
    data = _Rays(batch["ray_translation"], batch["ray_direction"], 1)
    got, grids = inference._auto_cap_fraction(port, data, None, False, bs)
    probe = fast.make_occupancy_renderer(port, 1.0, warn_saturation=False,
                                         warn_background=False)
    fg = (probe.ray_scores(grids[0], *(torch.from_numpy(batch[k]) for k in (
        "ray_translation", "ray_direction"))) > probe.threshold).numpy()
    assert inference.SCORE_CHUNK < n
    worst = inference._worst_batch_count(fg, bs)
    assert got == min(bs, int(worst * 1.2) + 64) / bs


# ------------------------------------------------- render_path --fast, four families

@pytest.mark.parametrize("model_type", ["nerf", "smpl_nerf", "append_to_nerf",
                                        "append_smpl_params"])
def test_render_path_fast_renders_every_family(tmp_path, capsys, model_type):
    parser = port_config.config_parser()
    args = parser.parse_args(_argv(model_type, white_background=1))
    models, _ = factory.build_models_and_params(args, seed=1, device="cpu")
    run_dir = str(tmp_path / "run")
    checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()}, args,
                         parser)

    def views(*extra):
        return render_path.main(["--run_dir", run_dir, "--number_steps", "2",
                                 "--resolution", "6", "--human_pose_angle", "20",
                                 "--out", str(tmp_path / "v.npy"), "--batch_size", "24",
                                 "--device", "cpu", *extra])

    full = views()
    for mode in ("1", "2"):
        np.testing.assert_allclose(views("--fast", mode, "--cap_fraction", "1"), full,
                                   atol=1e-5)
    auto = views("--fast", "2", "--save_dir", str(tmp_path / "png"))
    assert "auto cull budget" in capsys.readouterr().out
    assert auto.shape == full.shape and np.isfinite(auto).all()
    assert sorted(os.listdir(tmp_path / "png")) == ["img_000.png", "img_001.png",
                                                    "walking.gif"]
