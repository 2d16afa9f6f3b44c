"""Inference: load a run directory, re-render a dataset, score it, save PNGs
and a GIF (counterpart of smpl_nerf_tpu/cli/inference.py).

    python inference_torch.py --inf_run_dir runs/<run> --inf_ground_truth_dir data/val \
        --inf_save_dir renders_test [--inf_fast 0|1|2] [--inf_cap_fraction C] [--device cuda]

`inference()` rebuilds the pipeline from the run's config.txt and model_*.pt,
renders the ground-truth split in order through the full pipeline
(`--inf_fast 0`), the foreground-culled renderer (1) or the occupancy-grid
renderer (2), prints MSE / PSNR / SSIM / rLPIPS / LPIPS and writes
img_XXX.png, walking.gif and scores.json into --inf_save_dir.
`inference_gif()` re-renders train + val in the order the dataset was
created (train_index / val_index of create_dataset_config.txt) into
<run_dir>/img_XXX.png and <run_dir>/inference.gif; the post-training step of
`cli/train.py` calls it. It names its GIF inference.gif, as the JAX
function's docstring says, where the JAX function's code writes
walking.gif through `save_rerenders`.

Runs on the card unless `--device cpu` asks for the plain PyTorch versions.
The SMPL-driven families (dummy_dynamic, append_vertex_locations_to_nerf,
image_wise_dynamic) render with the SMPL model the run trained with and the
pose table of the split being rendered. smpl, warp and vertex_sphere render
from the arrays their loader builds for the split (the surface samples and
warps; vertex_sphere's z values and warps, precomputed or in-step as the
run's flags pick); a `warp` run's render is the split's own colours, as in the
JAX package. The culled renderers render all of these in full, as the JAX
package's do. smpl_estimator has no render pipeline: `render_dataset`
raises, where the JAX package's fails building one.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch import config as config_mod
from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import datasets, gif, png
from smpl_nerf_tpu_torch.data.datasets import RayData
from smpl_nerf_tpu_torch.evaluation.scores import print_scores
from smpl_nerf_tpu_torch.parallel import mesh as mesh_mod
from smpl_nerf_tpu_torch.pipelines import SMPL_MODEL_FAMILIES
from smpl_nerf_tpu_torch.render import batched
from smpl_nerf_tpu_torch.render import fast as fast_mod
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import dataset_extras, smpl_model_for
# the families whose occupancy grid depends on the body pose
POSE_FAMILIES = ("smpl_nerf", "append_to_nerf", "append_smpl_params")
# the auto cull budget covers the worst batch's foreground rays times
# CAP_SAFETY plus CAP_SLACK rays; its probe pass scores SCORE_CHUNK rays at once
CAP_SAFETY, CAP_SLACK, SCORE_CHUNK = 1.2, 64, 65536


def inference_parser() -> config_mod.ConfigArgumentParser:
    parser = config_mod.ConfigArgumentParser()
    parser.add_argument("--inf_run_dir", default="runs/latest", help="path to load model")
    parser.add_argument("--inf_ground_truth_dir", default="data/val")
    parser.add_argument("--inf_model_type", default=None, type=str,
                        help="defaults to the run's trained model_type")
    parser.add_argument("--inf_save_dir", default="renders_test")
    parser.add_argument("--inf_batchsize", default=800, type=int)
    parser.add_argument("--inf_fast", default=0, type=int,
                        help="1: foreground-culled hierarchical renderer (render/fast.py) "
                             "for the nerf/smpl_nerf/append families; 2: occupancy-grid "
                             "culled renderer: density baked into a voxel grid (per body "
                             "pose), no MLP work on background rays")
    parser.add_argument("--inf_cap_fraction", default=0.0, type=float,
                        help="fine-pass cull budget as a fraction of the batch. <=0 "
                             "(default): derive it per dataset from occupancy probe counts "
                             "(inf_fast=2) or use 0.25 (inf_fast=1)")
    parser.add_argument("--mesh_shape", default=None, type=str,
                        help="the mesh to render on, in place of the run's own "
                             "(--mesh_shape= : the whole world on the data axis)")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu (the plain PyTorch versions)")
    return parser


def setup_from_run_dir(run_dir: str, model_type: Optional[str] = None):
    """The run's resolved flags from run_dir/config.txt (model_type overridden
    when given); for the SMPL-driven families and vertex_sphere with the SMPL
    model loaded onto them (`factory.smpl_model_for`), as the JAX function
    loads it."""
    args = checkpoints.load_config(run_dir)
    if model_type:
        args.model_type = model_type
    if args.model_type not in config_mod.MODEL_TYPES:
        raise ValueError(f"unknown model_type {args.model_type!r}")
    if args.model_type in SMPL_MODEL_FAMILIES:
        smpl_model_for(args)
    return args


def _worst_batch_count(fg: np.ndarray, bs: int) -> int:
    """Largest per-batch foreground count over the `bs`-ray batches of one
    span `fg`, each padded as `render_rays_batched` pads it (a foreground
    last ray counts once per duplicate too)."""
    fg = torch.as_tensor(fg)
    return max((int(fg[batched.padded_rows(lo, hi, bs)].sum())
                for _, lo, hi in batched.batch_bounds(len(fg), 1, bs, False)), default=0)


def _auto_cap_fraction(pipeline, data: RayData, poses: Optional[np.ndarray], per_pose: bool,
                       batch_size: int):
    """(cap_fraction, grids): the occupancy cull budget from probe counts, and
    the baked grids as host copies (one per image, or one shared) for the
    renderer to upload again instead of baking every pose twice.

    Counts each ray whose score clears the threshold, replays the batches
    `render_rays_batched` will cut (the same spans, chunks and padding), and
    returns the fraction that covers the worst batch with a margin:
    min(bs, int(worst * CAP_SAFETY) + CAP_SLACK) / bs. Costs one grid bake per
    distinct pose and probe work, no net on any ray. Scores SCORE_CHUNK rays
    at a time.
    """
    probe = fast_mod.make_occupancy_renderer(pipeline, cap_fraction=1.0,
                                             warn_saturation=False, warn_background=False)
    if probe.threshold is None:
        return 1.0, None
    device = next(pipeline.models["model_coarse"].parameters()).device
    bs = batch_size
    grids, worst = [], 0
    for image, span_lo, span_hi in batched.image_spans(data.num_rays, data.num_images,
                                                       per_pose):
        pose = {} if poses is None else {
            "human_pose": torch.as_tensor(poses[image or 0][None], device=device)}
        grid = probe.build_grid(pose)
        grids.append(grid.cpu())
        fg_parts = []
        for lo in range(span_lo, span_hi, SCORE_CHUNK):
            hi = min(lo + SCORE_CHUNK, span_hi)
            scores = probe.ray_scores(grid, torch.as_tensor(data.origins[lo:hi], device=device),
                                      torch.as_tensor(data.directions[lo:hi], device=device))
            fg_parts.append((scores > probe.threshold).cpu().numpy())
        worst = max(worst, _worst_batch_count(np.concatenate(fg_parts), bs))
    cap = min(bs, int(worst * CAP_SAFETY) + CAP_SLACK) / bs
    print(f"auto cull budget: worst batch has {worst}/{bs} foreground rays -> "
          f"cap_fraction={cap:.3f}")
    return cap, grids


def render_dataset(args, run_dir: str, data: RayData, fast: int = 0, cap_fraction: float = 0.0,
                   batch_size: Optional[int] = None, device=DEFAULT_DEVICE) -> np.ndarray:
    """Render every image of `data` through the run's weights -> [N, h, w, 3].

    On the run's mesh (args.mesh_shape, as the JAX package reads it): a mesh
    that does not hold the world raises; across processes every rank calls
    this and gets the whole render.

    fast=1: the foreground-culled renderer (cap_fraction <= 0 means 0.25);
    fast=2: the occupancy-grid renderer, whose budget is derived from probe
    counts over exactly this call's batches when cap_fraction <= 0, and which
    warns when an explicit cap_fraction lies below that derived budget.
    """
    dev = resolve_device(device)
    if args.model_type == "smpl_estimator":
        raise ValueError("smpl_estimator runs have no render pipeline to render or score "
                         "(training/estimator.load_estimator reads the run)")
    mesh = mesh_mod.make_mesh(getattr(args, "mesh_shape", "") or "", dev)
    pipeline = batched.build_from_run(run_dir, args, dev, dataset_extras(args, data))
    bs = mesh_mod.pad_to_multiple(int(batch_size or args.batchsize_val), mesh.data)
    render_fn = render_fn_per_image = None
    if int(fast) >= 2:
        poses = data.human_poses
        # the grid depends on the body pose only for the conditioned families
        pose_dep = args.model_type in POSE_FAMILIES and bool(int(args.run_fine))
        per_pose = (pose_dep and poses is not None
                    and not bool(np.all(poses == poses[:1])))
        derived, baked_grids = _auto_cap_fraction(pipeline, data, poses, per_pose, bs)
        if cap_fraction <= 0:
            cap_fraction = derived
        elif cap_fraction < derived:
            print(f"WARNING: --inf_cap_fraction={cap_fraction:g} is below the derived safe "
                  f"cull budget {derived:.3f} for this dataset's batching: foreground rays "
                  "may be clipped to background. Raise it, or pass a value <= 0 to size "
                  "the budget automatically.")
        # the probe pre-pass above replaces the renderer's per-batch saturation check
        occ = fast_mod.make_occupancy_renderer(pipeline, cap_fraction, warn_saturation=False)
        if per_pose:
            # one grid per image, re-uploaded from the pre-pass's host copy:
            # only one is on the card at a time
            def render_fn_per_image(i):
                grid = baked_grids[i].to(dev)
                return lambda batch: occ(batch, grid)
        else:
            # one shared body pose (a novel camera path) or a pose-independent
            # model: one grid for every batch
            grid = baked_grids[0].to(dev) if baked_grids else None
            render_fn = lambda batch: occ(batch, grid)     # noqa: E731
    elif fast:
        render_fn = fast_mod.make_fast_renderer(pipeline,
                                                cap_fraction if cap_fraction > 0 else 0.25)
    rgb = batched.render_rays_batched(pipeline, data, bs, dev, render_fn=render_fn,
                                      render_fn_per_image=render_fn_per_image, mesh=mesh)
    return rgb.reshape(data.num_images, data.h, data.w, 3)


def save_rerenders(rgb_images: np.ndarray, output_dir: str,
                   gif_name: Optional[str] = "walking.gif") -> None:
    """img_XXX.png per image and, unless gif_name is None, a GIF of them all
    (reference inference.py:268-276). Images are BGR in the pipeline; the
    files hold RGB, flipped once here as the JAX package flips them."""
    os.makedirs(output_dir, exist_ok=True)
    frames = []
    for i, img in enumerate(rgb_images):
        bgr8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        png.write_png(os.path.join(output_dir, f"img_{i:03d}.png"), bgr8)
        frames.append(np.ascontiguousarray(bgr8[..., ::-1]))
    if gif_name and frames:
        gif.write_gif(os.path.join(output_dir, gif_name), frames)


def inference(argv: Optional[Sequence[str]] = None) -> dict:
    inf_args, _ = inference_parser().parse_known_args(argv)
    dev = resolve_device(inf_args.device)
    args = setup_from_run_dir(inf_args.inf_run_dir, inf_args.inf_model_type)
    if inf_args.mesh_shape is not None:
        args.mesh_shape = inf_args.mesh_shape
    data = datasets.load_dataset(inf_args.inf_ground_truth_dir, args.model_type, args,
                                 device=dev)
    renders = render_dataset(args, inf_args.inf_run_dir, data, fast=int(inf_args.inf_fast),
                             cap_fraction=float(inf_args.inf_cap_fraction),
                             batch_size=int(inf_args.inf_batchsize), device=dev)
    truths = data.rgb.reshape(data.num_images, data.h, data.w, 3)
    scores = print_scores(renders, truths, device=dev)
    save_rerenders(renders, inf_args.inf_save_dir)
    with open(os.path.join(inf_args.inf_save_dir, "scores.json"), "w") as fh:
        json.dump({**scores, "run_dir": inf_args.inf_run_dir,
                   "ground_truth_dir": inf_args.inf_ground_truth_dir,
                   "fast": int(inf_args.inf_fast)}, fh, indent=1)
    print("Renders saved under", inf_args.inf_save_dir)
    return scores


def _creation_order(run_dir: str) -> Optional[np.ndarray]:
    """argsort of train_index + val_index from create_dataset_config.txt, or None."""
    path = os.path.join(run_dir, "create_dataset_config.txt")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        text = fh.read()

    def grab(key):
        m = re.search(rf"^{key} = \[(.*)\]$", text, re.M)
        return [int(v) for v in m.group(1).split(",") if v.strip()] if m else []

    train_idx, val_idx = grab("train_index"), grab("val_index")
    if not (train_idx or val_idx):
        return None
    return np.argsort(np.concatenate([train_idx, val_idx]))


def inference_gif(run_dir: str, args, train_data: RayData, val_data: RayData,
                  device=DEFAULT_DEVICE) -> np.ndarray:
    """Re-render train + val in the order the dataset was created ->
    <run_dir>/img_XXX.png and <run_dir>/inference.gif (reference
    inference.py:42-101)."""
    order = _creation_order(run_dir)
    renders = np.concatenate([render_dataset(args, run_dir, data, device=device)
                              for data in (train_data, val_data)])
    if order is not None and len(order) == len(renders):
        renders = renders[order]
    if mesh_mod.rank() == 0:
        save_rerenders(renders, run_dir, gif_name="inference.gif")
    return renders


if __name__ == "__main__":
    inference()
