"""Foreground-culled hierarchical rendering (counterpart of smpl_nerf_tpu/render/fast.py).

The fine pass is most of a render's cost, but on the synthetic human scenes
most rays never hit the subject: their coarse opacity is about 0 and the fine
pass cannot change their colour. Two renderers send only K = max(1,
int(R * cap_fraction)) rays of an R-ray batch through the fine pass:

  * `make_fast_renderer` (`--fast 1`): the coarse pass on every ray, the K
    rays of largest accumulated opacity through the fine pass; the rest keep
    their coarse colour. Exact for rays of zero coarse weight.
  * `make_occupancy_renderer` (`--fast 2`): the density field baked into a
    G^3 grid (`ops/occupancy.py`) scores every ray by grid probes; the K rays
    of largest score go through the full coarse + fine path, the rest take
    the background colour. No net runs on a culled ray.

Both cover the four families the port builds (nerf and original_nerf,
smpl_nerf with its warp field, append_to_nerf and append_smpl_params with the
per-ray pose prefix gathered with the ray). They run the pipeline's own
coarse and fine passes (`pipeline.passes`, `pipelines.FamilyPasses`) on the
rays they select, so their nets run on the same kernels as the full pipeline
(B in mode 2, D in mode 1) and their fine samples on kernel A. A
configuration without a fine pass, and every family the JAX renderers do not
cull (the SMPL-driven ones), renders through the full pipeline, as it does
in the JAX package.

The top K are taken by a stable descending sort, not `torch.topk`:
`jax.lax.top_k` puts the lower index first among equal scores, and occupancy
scores tie at 0 on every background ray, so any other order would send other
rays through the fine pass than the JAX package does.
"""
from __future__ import annotations

import warnings
from typing import Tuple

import torch

from smpl_nerf_tpu_torch.ops import occupancy
from smpl_nerf_tpu_torch.pipelines import Pipeline

# the families the culled renderers take; every other one renders in full
CULLED_FAMILIES = ("nerf", "original_nerf", "smpl_nerf", "append_to_nerf",
                   "append_smpl_params")


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest scores, the lower index first among
    equal values, as `jax.lax.top_k` orders them."""
    vals, idx = torch.sort(scores, descending=True, stable=True)
    return vals[:k], idx[:k]


def _budget(R: int, cap_fraction: float) -> int:
    return max(1, int(R * cap_fraction))


def _culls(pipeline: Pipeline) -> bool:
    return pipeline.cfg.model_type in CULLED_FAMILIES and pipeline.cfg.run_fine


def _full_pipeline_renderer(pipeline: Pipeline):
    @torch.no_grad()
    def render(batch, grid=None):
        return pipeline(batch)["rgb_fine"]
    render.build_grid = lambda batch: None
    render.ray_scores = lambda grid, origins, dirs: None
    render.threshold = None
    return render


def make_fast_renderer(pipeline: Pipeline, cap_fraction: float = 0.25):
    """render(batch) -> rgb [R, 3]: coarse pass everywhere, fine pass on the K
    rays of largest coarse opacity."""
    if not _culls(pipeline):
        return _full_pipeline_renderer(pipeline)
    passes = pipeline.passes

    @torch.no_grad()
    def render(batch):
        origins, dirs = batch["ray_translation"], batch["ray_direction"]
        pose = passes.pose(batch)
        out, z_vals, _ = passes.coarse(origins, dirs, pose)
        _, fg = top_k(out.acc, _budget(origins.shape[0], cap_fraction))
        out_f, _ = passes.fine(origins[fg], dirs[fg], None if pose is None else pose[fg],
                               z_vals[fg], out.weights[fg])
        rgb = out.rgb.clone()
        rgb[fg] = out_f.rgb
        return rgb

    return render


def make_occupancy_renderer(pipeline: Pipeline, cap_fraction: float = 0.25,
                            grid_resolution: int = 64, aabb=None, n_probe=None,
                            warn_saturation: bool = True, warn_background: bool = True):
    """Occupancy-grid culled renderer: render(batch, grid=None) -> rgb [R, 3].

    Pass `grid` (from the returned renderer's `.build_grid(batch)`) to share
    one bake across batches of the same body pose; with grid=None it is baked
    per call (G^3 coarse-net evaluations). `.ray_scores(grid, origins, dirs)`
    and `.threshold` let a caller size the budget from probe counts
    (`cli/inference._auto_cap_fraction`).

    Assumes empty space carries about zero density, which holds for a model
    trained with --white_background=1; building it for another run warns
    (unless `warn_background` is off, for secondary instances). With
    `warn_saturation`, each batch reads the K-th selected score back to the
    host once and prints a warning when it is above the threshold: there may
    be more foreground rays than the budget.
    """
    cfg = pipeline.cfg
    aabb = occupancy.DEFAULT_AABB if aabb is None else aabb
    if n_probe is None:
        n_probe = occupancy.required_probes(aabb, grid_resolution, cfg.near, cfg.far)
    if not _culls(pipeline):
        return _full_pipeline_renderer(pipeline)
    if not cfg.white_background and warn_background:
        warnings.warn(
            "make_occupancy_renderer: the run was trained WITHOUT --white_background: "
            "empty space likely carries density, so the occupancy grid cannot tell "
            "background from subject and culled rays collapse to a flat colour. Use "
            "make_fast_renderer (coarse-colour fallback) for such models.", stacklevel=2)
    passes = pipeline.passes

    @torch.no_grad()
    def build_grid(batch) -> torch.Tensor:
        """Bake the density field at the batch's first body pose into [G, G, G]."""
        def density_fn(pts):
            S = grid_resolution
            rows = pts.shape[0] // S
            samples = pts.reshape(rows, S, 3)
            pose = passes.pose(batch)
            pose = None if pose is None else pose[:1].expand(rows, pose.shape[-1])
            if cfg.model_type == "smpl_nerf":
                samples = samples + passes.warp(samples, pose)
            # sigma comes off the trunk before the direction branch, so any
            # unit direction gives the same density
            dirs_unit = torch.tensor([0.0, 0.0, 1.0], device=pts.device).expand(rows, 1, 3)
            raw = passes.run("model_coarse", samples, dirs_unit, prefix=passes.prefix(pose))
            return torch.relu(raw[..., 3].float()).reshape(-1)

        device = next(pipeline.models["model_coarse"].parameters()).device
        return occupancy.build_density_grid(density_fn, aabb, grid_resolution, device=device)

    def ray_scores(grid, origins, dirs):
        return occupancy.ray_scores(grid, aabb, origins, dirs, cfg.near, cfg.far, n_probe)

    @torch.no_grad()
    def render(batch, grid=None):
        origins, dirs = batch["ray_translation"], batch["ray_direction"]
        R = origins.shape[0]
        K = _budget(R, cap_fraction)
        if grid is None:
            grid = build_grid(batch)
        vals, fg = top_k(ray_scores(grid, origins, dirs), K)
        if K < R and warn_saturation and float(vals[K - 1]) > occupancy.OCC_THRESHOLD:
            print(f"WARNING: occupancy cull budget saturated (K={K} of R={R} rays, "
                  f"cap_fraction={cap_fraction:g}): foreground rays may be clipped to "
                  "background; raise cap_fraction (or use auto budgeting / image-scale "
                  "batches)")
        o_k, d_k = origins[fg], dirs[fg]
        pose = passes.pose(batch)
        pose_k = None if pose is None else pose[fg]
        out, z_vals, _ = passes.coarse(o_k, d_k, pose_k)
        rgb_f = passes.fine(o_k, d_k, pose_k, z_vals, out.weights)[0].rgb
        bg = 1.0 if cfg.white_background else 0.0
        rgb = torch.full((R, 3), bg, dtype=rgb_f.dtype, device=rgb_f.device)
        rgb[fg] = rgb_f
        return rgb

    render.build_grid = build_grid
    render.ray_scores = ray_scores
    render.threshold = occupancy.OCC_THRESHOLD
    return render
