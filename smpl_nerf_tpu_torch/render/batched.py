"""Batched rendering of a whole ray dataset (counterpart of
smpl_nerf_tpu/training/solver.py:Solver.render_rays_batched).

Rays are cut into chunks of `batch_size` (`batch_bounds`); the last chunk is
padded with its LAST ray (`padded_rows`), and each batch is gathered from the
split's `batch_arrays` as a training batch is (`solver.gather_batch`: each
ray's `human_pose` through its image index, and the arrays of the smpl, warp
and vertex_sphere families). The
SMPL-driven families look their poses up in the table of the split being
rendered (`solver.swap_pose_table`), and with --images_per_batch no batch
may span more images than that (`solver.check_batch_images`). The
occupancy renderer's auto budget (`cli/inference._auto_cap_fraction`)
replays the same batches through the same two functions. A culled renderer
(`render/fast.py`) takes the pipeline's place through `render_fn`, or
through `render_fn_per_image`, which aligns the batches to image boundaries
and is called once per image, so that the occupancy renderer bakes one grid
per body pose and only one is alive at a time. `cli/inference.render_dataset`
renders a run directory through it.

Spans (`tracing`): `render.view` holds a call, numbered by the call as its
request; inside it `render.upload` (the arrays to the device), one
`render.batch` per batch, and `render.readback` (the result to the host).
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.data.datasets import RayData
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.parallel import multihost
from smpl_nerf_tpu_torch.pipelines import Pipeline, RenderConfig, build_pipeline
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params
from smpl_nerf_tpu_torch.training.solver import (check_batch_images, gather_batch,
                                                 swap_pose_table)

_calls = itertools.count()      # render_rays_batched's calls, the spans' request


def image_spans(num_rays: int, num_images: int, per_image: bool) -> List[tuple]:
    """(image, lo, hi) of the spans that no batch crosses: with per_image one
    per image, the rays cut into num_images equal spans, else the whole
    dataset as one span with image None."""
    if not per_image:
        return [(None, 0, num_rays)]
    hw = num_rays // max(1, num_images)
    return [(i, i * hw, (i + 1) * hw) for i in range(num_images)]


def batch_bounds(num_rays: int, num_images: int, batch_size: int,
                 per_image: bool) -> Iterator[tuple]:
    """(image, lo, hi) of every batch in render order: rays lo..hi-1 of one
    span (`image_spans`), padded to batch_size by `padded_rows`."""
    for image, span_lo, span_hi in image_spans(num_rays, num_images, per_image):
        for lo in range(span_lo, span_hi, batch_size):
            yield image, lo, min(lo + batch_size, span_hi)


def padded_rows(lo: int, hi: int, batch_size: int, device=None) -> torch.Tensor:
    """The ray indices of one batch: lo..hi-1, then its last ray hi-1 repeated
    up to batch_size (never ray 0, whose duplicates would compete in a culled
    renderer's top-K)."""
    return torch.arange(lo, lo + batch_size, device=device).clamp_(max=hi - 1)


@torch.no_grad()
def render_rays_batched(pipeline: Pipeline, data: RayData, batch_size: int,
                        device: torch.device, render_fn: Optional[Callable] = None,
                        render_fn_per_image: Optional[Callable] = None,
                        mesh: Optional[mesh_mod.Mesh] = None) -> np.ndarray:
    """rgb_fine [N, 3] of every ray of `data`, on the host.

    render_fn: batch -> rgb [batch_size, 3] in place of the pipeline.
    render_fn_per_image: image index -> such a render_fn; batches then never
    mix two images' rays. mesh: split each batch's rows over its data axis.
    """
    with tracing.span("render.view", next(_calls)):
        mesh = mesh or mesh_mod.Mesh()
        batch_size = mesh_mod.pad_to_multiple(batch_size, mesh.data)
        lo_r, hi_r = (multihost.local_row_range(mesh, batch_size) if mesh.distributed
                      else (0, batch_size))
        cfg = getattr(pipeline, "cfg", None)        # any batch -> outputs callable renders
        with tracing.span("render.upload"):
            arrays = {k: torch.as_tensor(v, device=device)
                      for k, v in data.batch_arrays(cfg.model_type if cfg else "nerf").items()}
            arrays["image_indices"] = arrays["image_indices"].long()
            out = torch.empty((data.num_rays, 3), dtype=torch.float32, device=device)
        fn, current = render_fn, None
        with swap_pose_table(getattr(pipeline, "models", {}), data.human_poses):
            for image, lo, hi in batch_bounds(data.num_rays, data.num_images, batch_size,
                                              render_fn_per_image is not None):
                with tracing.span("render.batch"):
                    if image is not None and image != current:
                        # the factory is called lazily per image: one baked grid at a time
                        fn, current = render_fn_per_image(image), image
                    if cfg is not None and cfg.images_per_batch:
                        check_batch_images(cfg, padded_rows(lo, hi, batch_size).numpy(),
                                           data.image_indices, arrays)
                    rows = padded_rows(lo, hi, batch_size, device)
                    if fn is not None:
                        rgb = fn(gather_batch(arrays, rows))
                    else:
                        rgb = pipeline(gather_batch(arrays, rows[lo_r:hi_r]))["rgb_fine"]
                        rgb = multihost.all_gather_rows(rgb, mesh)
                    out[lo:hi] = rgb[:hi - lo]
        with tracing.span("render.readback"):
            return out.cpu().numpy()


def build_from_run(run_dir: str, args, device: torch.device,
                   extras: Optional[dict] = None) -> Pipeline:
    """The run's pipeline with its weights loaded from model_*.pt (extras:
    `factory.dataset_extras`, for the SMPL-driven families)."""
    models, encoders = build_models_and_params(args, device=device, extras=extras)
    state_dicts = checkpoints.load_run(run_dir)
    for name, model in models.items():
        if name not in state_dicts:
            raise FileNotFoundError(f"{run_dir} has no {checkpoints.weights_file(name)}")
        model.load_state_dict(state_dicts[name])
    return build_pipeline(RenderConfig.from_args(args), models, encoders, extras)
