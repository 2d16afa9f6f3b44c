"""Distill a TRAINED run into a KiloNeRF-style expert grid and measure it
(counterpart of tools/distill_run.py).

    python distill_torch.py --run_dir runs/<run> --dataset_dir data/<set>/val \
        --out_dir runs/distill_x --grid 16 --hidden 32 --steps 3000 [--device cuda]

Converts a trained static-scene run into a grid^3 field of tiny MLPs
(render/experts.py, arXiv:2103.13744) and measures, on the same val split:

  * distilled quality against ground truth (mse / psnr / ssim),
  * the distillation gap: distilled render against the TEACHER rendered with
    the identical uniform-z integration (isolates the field swap),
  * ms per view of the teacher trunk and of every serving form of the
    experts (tiled, ESS-culled, ESS-tiled, ESS-fused-kernel, ESS-bucketed, a
    tile-size sweep, the ray-culled forms), same chunking, same sample count:
    the median over --time_reps of a host clock around one whole view that
    ends in a device synchronise.

Static families (nerf) bake directly; the pose-conditioned append families
bake at ONE pose (--pose_image), scored on the views at that pose; the warp
families are refused. Phases are resumable: the fields (field.npz,
field_ft.npz, field_ft2.npz), the teacher render and each phase's scores are
cached in --out_dir, written through a temporary file; a cache that does not
load is deleted and recomputed.

On the card the fused-kernel leg is mandatory: a kernel that does not build,
launch or match the culled render within 5e-2 raises and the tool exits
non-zero. Nothing degrades silently: a failing occupancy probe raises too.

Writes <out_dir>/scores.json (quality + latency + configuration) and field.npz.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time
import types
import zipfile
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.core.integrate import raw2outputs
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.evaluation.scores import print_scores
from smpl_nerf_tpu_torch.pipelines import RenderConfig, _make_net_runner
from smpl_nerf_tpu_torch.render import experts as ex
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params

APPEND_FAMILIES = ("append_smpl_params", "append_to_nerf")
KERNEL_CHECK_MAX = 5e-2      # fused-kernel render against the culled render, one chunk
_BLOCK = 262144              # rows per teacher / probe call: bounds memory only


def build_teacher(run_dir: str, pose=None, device=DEFAULT_DEVICE):
    """(teacher_fn, cfg, args) from a trained run dir.

    Static families bake directly. The pose-conditioned append families bake
    at ONE fixed `pose` vector: the conditioning prefix is constant for a
    fixed pose, so the conditioned trunk restricted to that pose IS a static
    field. Serving then covers novel VIEWS at the baked pose."""
    device = resolve_device(device)
    args = checkpoints.load_config(run_dir)
    static = args.model_type in ("nerf", "original_nerf")
    append = args.model_type in APPEND_FAMILIES
    if not (static or append):
        raise ValueError(
            f"distillation bakes a (per-pose) static field; model_type="
            f"{args.model_type} is not supported — static nerf families bake "
            f"directly, append families bake per pose; the warp families "
            "would need the warp folded into the query (not implemented)")
    if append and pose is None:
        raise ValueError(f"{args.model_type} is pose-conditioned: pass "
                         "--pose_image to pick the pose to bake")
    models, encoders = build_models_and_params(args, device=device)
    for name, sd in checkpoints.load_run(run_dir).items():
        if name in models:
            models[name].load_state_dict(sd)
    cfg = RenderConfig.from_args(args)
    run = _make_net_runner(cfg, models, encoders)
    model_key = "model_fine" if cfg.run_fine else "model_coarse"

    prefix_row = None
    if append:
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)[None]   # [1, P]
        if args.model_type == "append_to_nerf":
            pose = pose[:, (38, 41)]     # two-joint conditioning
        prefix_row = (encoders["human_pose"].encode(pose) if cfg.human_pose_encoding
                      else pose)                                                    # [1, Pf]

    @torch.no_grad()
    def teacher_fn(pos, dirs):
        out = []
        for lo in range(0, pos.shape[0], _BLOCK):
            p, d = pos[lo:lo + _BLOCK], dirs[lo:lo + _BLOCK]
            prefix = None if prefix_row is None else prefix_row.expand(p.shape[0], -1)
            out.append(run(model_key, p[:, None, :], d[:, None, :], prefix=prefix)
                       .reshape(p.shape[0], -1))
        return out[0] if len(out) == 1 else torch.cat(out)

    return teacher_fn, cfg, args


def probe_sigma(teacher_fn, data, near, far, res, device):
    """(pts [res^3, 3], sigma [res^3], lo, hi): the teacher's density, clipped
    at 0, on a res^3 grid that spans the rays' extents."""
    ends = np.concatenate([data.origins + near * data.directions,
                           data.origins + far * data.directions])
    lo, hi = ends.min(0), ends.max(0)
    axes = [np.linspace(lo[i], hi[i], res, dtype=np.float32) for i in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    p = torch.as_tensor(pts, device=device)
    d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(p.shape)
    sigma = np.maximum(teacher_fn(p, d)[:, 3].cpu().numpy(), 0.0)
    return pts, sigma, lo, hi


def probe_aabb(teacher_fn, data, near, far, res=64, sigma_thresh=5.0, device=DEFAULT_DEVICE):
    """Tight scene AABB: the bounds of the probe points whose density clears
    `sigma_thresh`, plus one probe-cell margin."""
    pts, sigma, lo, hi = probe_sigma(teacher_fn, data, near, far, res, device)
    occ = pts[sigma > sigma_thresh]
    if occ.shape[0] == 0:
        raise ValueError(f"no density above {sigma_thresh}; is the run trained?")
    cell = (hi - lo) / (res - 1)
    return occ.min(0) - cell, occ.max(0) + cell


def _image_rays(data, i):
    n = data.h * data.w
    sl = slice(i * n, (i + 1) * n)
    return data.origins[sl], data.directions[sl]


def filter_images_by_pose(data, pose, tol=1e-5):
    """Restrict a RayData split to the images whose human_pose matches `pose`
    (a baked field only serves views AT its pose). Returns the kept original
    image indices."""
    if data.human_poses is None:
        raise ValueError("dataset has no image_pose_map — cannot pose-filter")
    keep = [i for i in range(data.num_images)
            if np.allclose(data.human_poses[i], pose, atol=tol)]
    if not keep:
        raise ValueError("no images in this split match the baked pose")
    n = data.h * data.w
    sel = np.concatenate([np.arange(i * n, (i + 1) * n) for i in keep])
    data.origins = data.origins[sel]
    data.directions = data.directions[sel]
    data.rgb = data.rgb[sel]
    data.image_indices = np.repeat(np.arange(len(keep), dtype=np.int32), n)
    data.human_poses = data.human_poses[keep]
    data.num_images = len(keep)
    return keep


def _cell_ids(pos, aabb_min, aabb_max, grid):
    u = (pos - aabb_min) / (aabb_max - aabb_min)
    c = np.clip((u * grid).astype(np.int64), 0, grid - 1)
    return (c[..., 0] * grid + c[..., 1]) * grid + c[..., 2]


def _chunk_counts(data, aabb_min, aabb_max, grid, z, chunk, occupied=None):
    """Yield per-expert in-AABB sample counts [E] for every chunk this render
    will execute (host numpy). With `occupied` [E] bool, empty cells' samples
    are dropped (they route to the skip id under ESS)."""
    E = grid ** 3
    z = np.asarray(z, np.float32)
    for i in range(data.num_images):
        o, d = _image_rays(data, i)
        for lo in range(0, len(o), chunk):
            pos = (o[lo:lo + chunk, None, :]
                   + z[None, :, None] * d[lo:lo + chunk, None, :]).reshape(-1, 3)
            inside = np.all((pos >= aabb_min) & (pos <= aabb_max), -1)
            counts = np.bincount(_cell_ids(pos[inside], aabb_min, aabb_max, grid), minlength=E)
            if occupied is not None:
                counts = counts * np.asarray(occupied, bool)
            yield counts


def tiled_budget(data, aabb_min, aabb_max, grid, z, chunk, tile, occupied=None):
    """Worst padded-slot count over every chunk for the sorted-tile serving
    path: sum over touched experts of ceil(count/tile)*tile, +2% margin,
    rounded to a tile multiple. Sizes `ep.sorted_tile_plan`'s static budget
    with no silent drops."""
    worst = 0
    for counts in _chunk_counts(data, aabb_min, aabb_max, grid, z, chunk, occupied):
        worst = max(worst, int((-(-counts // tile) * tile).sum()))
    return int(np.ceil(max(worst, tile) * 1.02 / tile) * tile)


def max_bucket_count(data, aabb_min, aabb_max, grid, z, chunk, occupied=None):
    """Worst per-expert in-AABB sample count over every chunk: sizes the
    static bucket capacity. With `occupied`, only occupied cells count."""
    worst = 0
    for counts in _chunk_counts(data, aabb_min, aabb_max, grid, z, chunk, occupied):
        worst = max(worst, int(counts.max()))
    return worst


def ray_fg_masks(data, aabb_min, aabb_max, grid, z, occupied):
    """Per-image boolean foreground masks: a ray is foreground iff ANY of its
    uniform z samples lands inside the AABB in an OCCUPIED cell. Host numpy;
    for a static (per-pose) field this is bake-time work."""
    occ = np.asarray(occupied, bool)
    z = np.asarray(z, np.float32)
    masks = []
    for i in range(data.num_images):
        o, d = _image_rays(data, i)
        fg = np.zeros(len(o), bool)
        for lo in range(0, len(o), 8192):
            pos = o[lo:lo + 8192, None, :] + z[None, :, None] * d[lo:lo + 8192, None, :]
            inside = np.all((pos >= aabb_min) & (pos <= aabb_max), -1)
            fg[lo:lo + 8192] = (inside & occ[_cell_ids(pos, aabb_min, aabb_max, grid)]).any(-1)
        masks.append(fg)
    return masks


def _write_atomic(path: str, write) -> None:
    """`write(tmp_path)` then rename: a cut run leaves no truncated cache."""
    tmp = f"{path}.tmp{os.path.splitext(path)[1]}"   # np.savez keeps names ending in .npz
    write(tmp)
    os.replace(tmp, path)


def _load_cache(path: str, read):
    """`read(path)`, or None when the file is absent; a file that does not
    load is deleted, so that the caller recomputes it."""
    if not os.path.exists(path):
        return None
    try:
        return read(path)
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
        print(f"cache {path} does not load ({type(e).__name__}: {e}) — deleted, recomputing")
        os.remove(path)
        return None


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_dir", required=True)
    p.add_argument("--dataset_dir", required=True,
                   help="split dir with transforms.json (e.g. .../val)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--grid", type=int, default=16)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--l_pos", type=int, default=4)
    p.add_argument("--l_dir", type=int, default=2)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--samples", type=int, default=192,
                   help="uniform z samples per ray for BOTH renders")
    p.add_argument("--chunk", type=int, default=4096, help="rays per chunk")
    p.add_argument("--tile", type=int, default=256,
                   help="sorted-tile size for the serving path")
    p.add_argument("--also_bucketed", type=int, default=1,
                   help="also TIME the bucketed ESS path (identical math)")
    p.add_argument("--images", type=int, default=0, help="cap val images (0=all)")
    p.add_argument("--time_reps", type=int, default=5)
    p.add_argument("--time_tiles", default="64,128,512",
                   help="comma list of extra tile sizes to TIME the ESS serving path at "
                        "(quality renders stay at --tile; '' disables)")
    p.add_argument("--finetune_steps", type=int, default=0,
                   help="stage 2: photometric fine-tuning steps on the train split "
                        "(0 = distillation only)")
    p.add_argument("--finetune_batch", type=int, default=4096)
    p.add_argument("--finetune_samples", type=int, default=96)
    p.add_argument("--finetune_lr", type=float, default=3e-4)
    p.add_argument("--finetune2_steps", type=int, default=0,
                   help="second fine-tune phase at cosine-decayed lr (resumes field_ft.npz)")
    p.add_argument("--finetune2_lr", type=float, default=1e-4)
    p.add_argument("--finetune_tile", type=int, default=32,
                   help="sorted-tile size for fine-tune steps (small: training batches "
                        "touch many cells sparsely)")
    p.add_argument("--train_dir", default=None,
                   help="train split for fine-tuning (default: <dataset_dir>/../train)")
    p.add_argument("--ess", type=int, default=1,
                   help="also serve through empty-space skipping: drop the experts of empty "
                        "cells (occupancy probed from the distilled field, 1-cell dilation) "
                        "and score + time that render")
    p.add_argument("--ess_thresh", type=float, default=1.0,
                   help="raw-sigma threshold for the cell-occupancy probe")
    p.add_argument("--ess_probe", type=int, default=3,
                   help="occupancy probe lattice points per cell axis")
    p.add_argument("--ray_cull", type=int, default=1,
                   help="also measure RAY-level culling: the field's cell occupancy marks "
                        "foreground rays per view at bake time; teacher AND expert paths "
                        "then render only those rays, background composited exactly")
    p.add_argument("--distill_bias", type=float, default=0.5,
                   help="fraction of distill samples drawn inside the TEACHER's occupied "
                        "cells (0 = uniform only)")
    p.add_argument("--sigma_thresh", type=float, default=5.0)
    p.add_argument("--probe_res", type=int, default=64)
    p.add_argument("--pose_image", type=int, default=-1,
                   help="append families: bake the field at the pose of this image of the "
                        "dataset split (the split is filtered to views AT that pose)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = arg_parser().parse_args(argv)
    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    os.makedirs(args.out_dir, exist_ok=True)
    data = datasets.load_dataset(args.dataset_dir, "nerf")
    baked_pose = None
    if args.pose_image >= 0:
        baked_pose = np.asarray(data.human_poses[args.pose_image], np.float32)
        kept = filter_images_by_pose(data, baked_pose)
        print(f"pose-baked serving: pose of image {args.pose_image}, "
              f"{len(kept)} same-pose views in this split: {kept}")
    teacher_fn, cfg, run_args = build_teacher(args.run_dir, pose=baked_pose, device=device)
    if args.images:
        n = args.images * data.h * data.w
        data.origins = data.origins[:n]
        data.directions = data.directions[:n]
        data.rgb = data.rgb[:n]
        data.image_indices = data.image_indices[:n]
        data.num_images = args.images

    t0 = time.time()
    aabb_min, aabb_max = probe_aabb(teacher_fn, data, cfg.near, cfg.far, args.probe_res,
                                    args.sigma_thresh, device)
    print(f"AABB {np.round(aabb_min, 3)} .. {np.round(aabb_max, 3)} "
          f"({time.time() - t0:.1f}s probe)")

    occ_teacher = None
    if args.distill_bias > 0:
        occ_teacher = ex.dilate_occupancy(
            ex.grid_occupancy(teacher_fn, aabb_min, aabb_max, args.grid,
                              samples_per_axis=args.ess_probe, sigma_thresh=args.ess_thresh,
                              device=device), args.grid)
        print(f"teacher occupancy on the distill grid: {int(occ_teacher.sum())}/"
              f"{args.grid ** 3} cells — {args.distill_bias:.0%} of distill samples "
              "biased there")

    def load_matching_field(path):
        """Resume a saved field if its geometry matches this invocation."""
        field = _load_cache(path, lambda p: ex.load_field(p, device))
        if field is None:
            return None
        if (field.grid != args.grid or field.l_pos != args.l_pos or field.l_dir != args.l_dir
                or field.experts.w0.shape[2] != args.hidden
                or not np.allclose(field.aabb_min.cpu().numpy(), aabb_min, atol=1e-4)
                or not np.allclose(field.aabb_max.cpu().numpy(), aabb_max, atol=1e-4)):
            print(f"saved field {path} does not match this run — refitting")
            return None
        print(f"resumed field from {path}")
        return field

    t0 = time.time()
    field = load_matching_field(os.path.join(args.out_dir, "field.npz"))
    loss = float("nan")
    distill_s = 0.0
    distill_history = []
    field_resumed = field is not None
    if not field_resumed:
        field, loss = ex.distill_experts(
            teacher_fn, aabb_min, aabb_max, args.grid, generator(args.seed),
            hidden=args.hidden, l_pos=args.l_pos, l_dir=args.l_dir, n_steps=args.steps,
            batch=args.batch, lr=args.lr, occupied=occ_teacher, bias_frac=args.distill_bias,
            history=distill_history)
        sync()
        distill_s = time.time() - t0
        print(f"distilled grid={args.grid}^3 hidden={args.hidden} in {distill_s:.1f}s, "
              f"final normalized mse {loss:.4f}")
        ex.save_field(os.path.join(args.out_dir, "field.npz"), field)

    S = args.samples
    z_np = np.linspace(cfg.near, cfg.far, S, dtype=np.float32)
    z_row = torch.as_tensor(z_np, device=device)
    budget_full = tiled_budget(data, aabb_min, aabb_max, args.grid, z_np, args.chunk, args.tile)
    print(f"tiled budget (full field) = {budget_full} slots of {args.chunk * S} "
          f"samples/chunk (tile {args.tile})")

    white = bool(int(getattr(run_args, "white_background", 0)))
    # the experts serve in the precision the teacher's nets compute in; the
    # quality cost (if any) shows in the scores
    serve_dtype = (torch.bfloat16 if getattr(run_args, "compute_dtype", "float32") == "bfloat16"
                   else None)

    def z_of(o):
        return z_row.expand(o.shape[0], S)

    @torch.no_grad()
    def render_teacher(o, d):
        z = z_of(o)
        pos = o[:, None, :] + z[..., None] * d[:, None, :]
        raw = teacher_fn(pos.reshape(-1, 3), d[:, None, :].expand(pos.shape).reshape(-1, 3))
        return raw2outputs(raw.reshape(-1, S, 4), z, d, white_background=white).rgb, None

    def expert_renderer(render_fn, fld, *budget_args, **kw):
        """fn(o, d) -> (rgb, n_overflow) through one serving form of `fld`."""
        @torch.no_grad()
        def fn(o, d):
            outs, n_over = render_fn(fld, o, d, z_of(o), *budget_args, white_background=white,
                                     compute_dtype=serve_dtype, **kw)
            return outs.rgb, n_over
        return fn

    def chunks(o, d):
        o = torch.as_tensor(o, device=device)
        d = torch.as_tensor(d, device=device)
        for lo in range(0, len(o), args.chunk):
            yield o[lo:lo + args.chunk], d[lo:lo + args.chunk]

    def render_rays(fn, o, d):
        """(rgb [N, 3] on the host, overflow count) of rays through fn, in chunks."""
        rows, total_over = [], 0
        for ch in chunks(o, d):
            out, n_over = fn(*ch)
            if n_over is not None:
                total_over += int(n_over)      # a sync per chunk, as in the JAX tool
            rows.append(out.cpu().numpy())
        return np.concatenate(rows), total_over

    def render_split(fn):
        imgs, total_over = [], 0
        for i in range(data.num_images):
            rgb, n_over = render_rays(fn, *_image_rays(data, i))
            total_over += n_over
            imgs.append(rgb.reshape(data.h, data.w, 3))
        return np.stack(imgs), total_over

    def score_experts(tag, fld, truths, teach_imgs):
        print(f"— {tag} render —")
        imgs, n_over = render_split(expert_renderer(ex.render_rays_with_experts_tiled, fld,
                                                    budget_full, args.tile))
        if n_over:
            raise RuntimeError(f"{n_over} samples overflowed the tiled budget {budget_full} "
                               "— raise the budget")
        scores = print_scores(imgs, truths)
        print(f"— {tag} gap vs teacher (same integration) —")
        return scores, print_scores(imgs, teach_imgs)

    # Fixed-cost caches: everything deterministic given out_dir (teacher
    # render, already-scored resumed phases) is cached on disk, so a rerun
    # after a cut pays only for NEW work.
    def scores_cache(fname):
        return os.path.join(args.out_dir, fname + ".scores.json")

    def read_scores(path):
        with open(path) as f:
            c = json.load(f)
        return c["scores"], c["gap"]

    def load_cached_scores(fname, tag):
        c = _load_cache(scores_cache(fname), read_scores)
        if c is not None:
            print(f"— {tag}: scores cached ({scores_cache(fname)}) — "
                  f"psnr {c[0].get('psnr', float('nan')):.4f}")
        return c

    def save_cached_scores(fname, scores, gap):
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump({"scores": scores, "gap": gap}, f)
        _write_atomic(scores_cache(fname), write)

    truths = data.rgb.reshape(data.num_images, data.h, data.w, 3)
    teach_cache = os.path.join(args.out_dir, "teacher_render.npz")

    def read_teacher(path):
        with np.load(path) as z:
            return z["imgs"], json.loads(str(z["scores"]))

    cached = _load_cache(teach_cache, read_teacher)
    teacher_resumed = cached is not None and cached[0].shape == truths.shape
    if teacher_resumed:
        teach_imgs, teacher_scores = cached
        print(f"teacher render cached ({teach_cache}) — "
              f"psnr {teacher_scores.get('psnr', float('nan')):.4f}")
    else:
        print("— teacher render (identical uniform-z integration) —")
        teach_imgs, _ = render_split(render_teacher)
        teacher_scores = print_scores(teach_imgs, truths)
        _write_atomic(teach_cache, lambda tmp: np.savez(tmp, imgs=teach_imgs,
                                                        scores=json.dumps(teacher_scores)))
    # a refit in this process (distill_s > 0) invalidates any older sidecar
    cached = None if distill_s > 0 else load_cached_scores("field.npz", "distilled")
    if cached is not None:
        dist_scores, gap_scores = cached
    else:
        dist_scores, gap_scores = score_experts("distilled", field, truths, teach_imgs)
        save_cached_scores("field.npz", dist_scores, gap_scores)

    # Stage 2: photometric fine-tuning on the train split, then re-score.
    # Phases are resumable (saved fields) and share one lazily built
    # train split + tiled budget.
    ft_env = {}

    def ft_setup():
        if ft_env:
            return ft_env["tdata"], ft_env["budget"]
        train_dir = args.train_dir or os.path.join(
            os.path.dirname(args.dataset_dir.rstrip("/")), "train")
        tdata = datasets.load_dataset(train_dir, "nerf")
        if baked_pose is not None:
            kept_t = filter_images_by_pose(tdata, baked_pose)
            print(f"fine-tune restricted to {len(kept_t)} same-pose train views")
        # tiled budget for random fine-tune batches: probe a few in numpy
        rng = np.random.RandomState(1)
        zmid = np.linspace(cfg.near, cfg.far, args.finetune_samples, dtype=np.float32)
        tl = args.finetune_tile
        worst = tl
        for _ in range(16):
            idx = rng.randint(0, tdata.num_rays, args.finetune_batch)
            pos = (tdata.origins[idx, None, :]
                   + zmid[None, :, None] * tdata.directions[idx, None, :]).reshape(-1, 3)
            inside = np.all((pos >= aabb_min) & (pos <= aabb_max), -1)
            counts = np.bincount(_cell_ids(pos[inside], aabb_min, aabb_max, args.grid),
                                 minlength=args.grid ** 3)
            worst = max(worst, int((-(-counts // tl) * tl).sum()))
        ft_env.update(tdata=tdata, budget=int(np.ceil(worst * 1.25 / tl) * tl))
        return ft_env["tdata"], ft_env["budget"]

    def run_finetune(tag, fname, steps, lr, seed_off):
        """One resumable fine-tune phase: load fname if saved, else train,
        save, and score. Moves `field` to the phase result."""
        nonlocal field
        resumed = load_matching_field(os.path.join(args.out_dir, fname))
        if resumed is not None:
            field = resumed
            cached = load_cached_scores(fname, f"{tag} (resumed)")
            if cached is None:
                cached = score_experts(f"{tag} (resumed)", field, truths, teach_imgs)
                save_cached_scores(fname, *cached)
            return {"steps": steps, "seconds": 0.0, "resumed": True, "final_pixel_mse": None,
                    "overflow": 0, "loss_history": [], "scores": cached[0], "gap": cached[1]}
        tdata, ft_budget = ft_setup()
        tl = args.finetune_tile
        print(f"{tag}: {steps} steps, batch {args.finetune_batch} x {args.finetune_samples} "
              f"samples, tiled budget {ft_budget} (tile {tl})")
        t0 = time.time()
        history = []
        # mid-phase checkpoint every 2000 steps: a cut costs at most one window
        part = os.path.join(args.out_dir, fname.replace(".npz", ".part.npz"))
        field, ft_loss, ft_over = ex.finetune_experts(
            field, tdata.origins, tdata.directions, tdata.rgb, generator(args.seed + seed_off),
            near=cfg.near, far=cfg.far, n_samples=args.finetune_samples, budget=ft_budget,
            tile=tl, n_steps=steps, batch=args.finetune_batch, lr=lr, white_background=white,
            checkpoint_path=part, checkpoint_every=2000, history=history)
        sync()
        ft_s = time.time() - t0
        print(f"{tag} in {ft_s:.1f}s, final pixel mse {ft_loss:.6f}, "
              f"overflowed samples {ft_over}")
        if ft_over:
            print(f"WARNING: {ft_over} fine-tune samples overflowed the tiled budget "
                  f"{ft_budget} and rendered as empty space")
        ex.save_field(os.path.join(args.out_dir, fname), field)
        scores, gap = score_experts(tag, field, truths, teach_imgs)
        save_cached_scores(fname, scores, gap)
        return {"steps": steps, "seconds": round(ft_s, 1), "resumed": False,
                "final_pixel_mse": round(float(ft_loss), 6), "overflow": ft_over,
                "loss_history": history, "scores": scores, "gap": gap}

    ft_meta = None
    if args.finetune_steps > 0:
        ft_meta = run_finetune("fine-tuned", "field_ft.npz", args.finetune_steps,
                               args.finetune_lr, 1)
    ft2_meta = None
    if args.finetune2_steps > 0:
        # phase 2 at a cosine-decayed rate: converges the Adam noise tail that
        # a constant rate leaves
        sched = ex.CosineDecay(args.finetune2_lr, args.finetune2_steps, alpha=0.03)
        ft2_meta = run_finetune("fine-tuned v2 (cosine lr)", "field_ft2.npz",
                                args.finetune2_steps, sched, 2)
        ft2_meta["lr"] = [args.finetune2_lr, round(args.finetune2_lr * 0.03, 8)]

    def time_view(fn, o, d):
        """Median seconds of one whole view through fn (host clock around the
        chunk loop, synchronised), after one warm-up view."""
        o = torch.as_tensor(o, device=device)
        d = torch.as_tensor(d, device=device)
        seconds = []
        for _ in range(args.time_reps + 1):
            sync()
            t0 = time.perf_counter()
            for ch in chunks(o, d):
                fn(*ch)
            sync()
            seconds.append(time.perf_counter() - t0)
        return statistics.median(seconds[1:])

    view0 = _image_rays(data, 0)
    t_teacher = time_view(render_teacher, *view0)
    t_expert = time_view(expert_renderer(ex.render_rays_with_experts_tiled, field, budget_full,
                                         args.tile), *view0)

    # Empty-space skipping: compact the final field to its occupied cells
    # (mask probed from the field itself + 1-cell dilation), re-score and time
    ess_meta, ray_cull_meta = None, None
    t_ess = t_ess_tiled = t_ess_kernel = t_ess_bucketed = None
    tile_sweep = {}
    if args.ess:
        occ = ex.dilate_occupancy(ex.cell_occupancy(field, args.ess_probe, args.ess_thresh),
                                  args.grid)
        cfield = ex.compact_field(field, occ)
        budget_ess = tiled_budget(data, aabb_min, aabb_max, args.grid, z_np, args.chunk,
                                  args.tile, occupied=occ)
        n_occ = int(occ.sum())
        print(f"ESS: {n_occ}/{args.grid ** 3} cells occupied "
              f"({100 * n_occ / args.grid ** 3:.1f}%), tiled budget {budget_ess}")

        # scored + headline-timed ESS path: cull-then-route
        render_ess = expert_renderer(ex.render_rays_with_experts_culled, cfield, budget_ess,
                                     args.tile)
        # head-to-head: the sort-the-raw-stream tiled path (same math)
        render_ess_tiled = expert_renderer(ex.render_rays_with_experts_tiled, cfield,
                                           budget_ess, args.tile)
        # the fused kernel (ops/expert_tiles.py): same plan, encoding + MLP in one kernel
        render_ess_kernel = expert_renderer(ex.render_rays_with_experts_culled, cfield,
                                            budget_ess, args.tile, use_kernel=True)
        print("— ESS render (culled) —")
        imgs, n_over = render_split(render_ess)
        if n_over:
            raise RuntimeError(f"{n_over} samples overflowed the ESS tiled budget {budget_ess}")
        ess_scores = print_scores(imgs, truths)
        print("— ESS gap vs teacher (same integration) —")
        ess_gap = print_scores(imgs, teach_imgs)

        # the kernel against the culled render on ONE chunk: a hard check
        ch = next(chunks(*view0))
        err = float((render_ess_kernel(*ch)[0] - render_ess(*ch)[0]).abs().max())
        if not err <= KERNEL_CHECK_MAX:
            raise RuntimeError(f"fused-kernel / culled rgb mismatch {err:.2e} "
                               f"(bound {KERNEL_CHECK_MAX})")
        print(f"fused-kernel ESS path validated (max |Δrgb| {err:.1e})")
        ess_meta = {"occupied_cells": n_occ, "total_cells": args.grid ** 3,
                    "budget": budget_ess, "tile": args.tile, "thresh": args.ess_thresh,
                    "scores": ess_scores, "gap": ess_gap, "kernel_check_max_abs_rgb": err}

        t_ess = time_view(render_ess, *view0)
        t_ess_tiled = time_view(render_ess_tiled, *view0)
        for tl2 in [int(t) for t in args.time_tiles.split(",") if t]:
            if tl2 == args.tile:
                continue
            b2 = tiled_budget(data, aabb_min, aabb_max, args.grid, z_np, args.chunk, tl2,
                              occupied=occ)
            tt = time_view(expert_renderer(ex.render_rays_with_experts_tiled, cfield, b2, tl2),
                           *view0)
            tile_sweep[str(tl2)] = {"budget": b2, "ms": round(tt * 1e3, 2)}
            print(f"  ESS tile={tl2}: budget {b2}, {tt * 1e3:.1f} ms")
        t_ess_kernel = time_view(render_ess_kernel, *view0)
        if args.also_bucketed:
            # the global-capacity bucketed ESS path (identical math, so time only)
            ess_cap = max_bucket_count(data, aabb_min, aabb_max, args.grid, z_np, args.chunk,
                                       occupied=occ)
            ess_cap = int(np.ceil(max(ess_cap, 1) * 1.02 / 64) * 64)
            t_ess_bucketed = time_view(
                expert_renderer(ex.render_rays_with_experts_compact, cfield, ess_cap), *view0)

    print(f"render latency ({data.h}x{data.w}, {S} samples/ray, median of {args.time_reps}): "
          f"teacher {t_teacher * 1e3:.1f} ms, tiled {t_expert * 1e3:.1f} ms "
          f"({t_teacher / t_expert:.1f}x)"
          + (f", ESS-culled {t_ess * 1e3:.1f} ms ({t_teacher / t_ess:.1f}x)" if t_ess else "")
          + (f", ESS-tiled {t_ess_tiled * 1e3:.1f} ms" if t_ess_tiled else "")
          + (f", ESS-fused-kernel {t_ess_kernel * 1e3:.1f} ms "
             f"({t_teacher / t_ess_kernel:.1f}x)" if t_ess_kernel else "")
          + (f", ESS-bucketed {t_ess_bucketed * 1e3:.1f} ms" if t_ess_bucketed else ""))

    # Ray-level culling head-to-head: both serving paths run only the rays
    # the field's cell occupancy marks as foreground; the background is
    # composited exactly (the white_background training contract).
    if ess_meta and args.ray_cull:
        masks = ray_fg_masks(data, aabb_min, aabb_max, args.grid, z_np, occ)
        R_view = data.h * data.w
        n_fg = max(int(m.sum()) for m in masks)
        RK = int(np.ceil(max(n_fg, args.chunk) * 1.02 / args.chunk) * args.chunk)
        RK = min(RK, (R_view // args.chunk) * args.chunk or R_view)
        print(f"ray cull: worst-view foreground {n_fg}/{R_view} rays "
              f"({100 * n_fg / R_view:.1f}%), padded stream {RK} "
              f"({RK // args.chunk} x {args.chunk}-ray chunks)")
        sel = []   # per image: RK ray indices (pad = repeat of a fg index: the
        #            duplicate writes carry the identical value)
        for m in masks:
            idx = np.flatnonzero(m)
            if idx.size == 0:
                idx = np.zeros(1, np.int64)
            if idx.size > RK:   # only possible when R_view % chunk != 0
                raise RuntimeError(f"ray cull stream {RK} < foreground count {idx.size} — "
                                   "foreground rays would be dropped (never silent)")
            sel.append(np.concatenate([idx, np.full(RK - idx.size, idx[-1], idx.dtype)]))

        def culled_rays(i):
            o, d = _image_rays(data, i)
            return o[sel[i]], d[sel[i]]

        # all-foreground chunks are denser than the original ray order's:
        # recompute the tiled budget over the culled stream
        rc_view = types.SimpleNamespace(
            num_images=data.num_images, h=1, w=RK,
            origins=np.concatenate([culled_rays(i)[0] for i in range(data.num_images)]),
            directions=np.concatenate([culled_rays(i)[1] for i in range(data.num_images)]))
        budget_rc = tiled_budget(rc_view, aabb_min, aabb_max, args.grid, z_np, args.chunk,
                                 args.tile, occupied=occ)
        render_ess_rc = expert_renderer(ex.render_rays_with_experts_culled, cfield, budget_rc,
                                        args.tile)
        render_kernel_rc = expert_renderer(ex.render_rays_with_experts_culled, cfield,
                                           budget_rc, args.tile, use_kernel=True)
        bg = 1.0 if white else 0.0

        def render_split_rc(fn):
            imgs, total_over = [], 0
            for i in range(data.num_images):
                rgb, n_over = render_rays(fn, *culled_rays(i))
                total_over += n_over
                canvas = np.full((R_view, 3), bg, np.float32)
                canvas[sel[i]] = rgb
                imgs.append(canvas.reshape(data.h, data.w, 3))
            return np.stack(imgs), total_over

        print("— ray-culled ESS render (fg rays only) —")
        rc_imgs, n_over = render_split_rc(render_ess_rc)
        if n_over:
            raise RuntimeError(f"{n_over} samples overflowed the ray-culled budget {budget_rc}")
        rc_scores = print_scores(rc_imgs, truths)
        print("— ray-culled ESS gap vs (all-rays) teacher render —")
        rc_gap = print_scores(rc_imgs, teach_imgs)
        print("— ray-culled TEACHER render (same fg rays) —")
        rc_t_scores = print_scores(render_split_rc(render_teacher)[0], truths)

        rc0 = culled_rays(0)
        t_rc_ess = time_view(render_ess_rc, *rc0)
        t_rc_teacher = time_view(render_teacher, *rc0)
        t_rc_kernel = time_view(render_kernel_rc, *rc0)
        print(f"ray-culled latency ({RK} of {R_view} rays/view, median of {args.time_reps}): "
              f"teacher-rc {t_rc_teacher * 1e3:.1f} ms, ESS-rc {t_rc_ess * 1e3:.1f} ms "
              f"({t_rc_teacher / t_rc_ess:.1f}x vs ray-culled teacher, "
              f"{t_teacher / t_rc_ess:.1f}x vs all-rays teacher), "
              f"fused-kernel-rc {t_rc_kernel * 1e3:.1f} ms")
        ray_cull_meta = {
            "worst_fg": n_fg, "stream": RK, "rays_per_view": R_view, "budget": budget_rc,
            "scores": rc_scores, "gap_vs_full_teacher": rc_gap, "teacher_scores": rc_t_scores,
            "latency_ms": {"teacher_rc": round(t_rc_teacher * 1e3, 2),
                           "ess_rc": round(t_rc_ess * 1e3, 2),
                           "ess_rc_vs_allrays_teacher": round(t_teacher / t_rc_ess, 2),
                           "ess_rc_kernel": round(t_rc_kernel * 1e3, 2)}}

    def ms(t):
        return round(t * 1e3, 2)

    latency = {"teacher": ms(t_teacher), "tiled": ms(t_expert),
               "speedup": round(t_teacher / t_expert, 2)}
    if ess_meta:
        latency.update(ess_culled=ms(t_ess), ess_culled_speedup=round(t_teacher / t_ess, 2),
                       ess_tiled=ms(t_ess_tiled), ess_fused_kernel=ms(t_ess_kernel),
                       ess_fused_speedup=round(t_teacher / t_ess_kernel, 2))
        if t_ess_bucketed:
            latency["ess_bucketed"] = ms(t_ess_bucketed)
        if tile_sweep:
            latency["ess_tile_sweep"] = tile_sweep
    out = {
        "run_dir": args.run_dir, "dataset_dir": args.dataset_dir,
        "grid": args.grid, "hidden": args.hidden, "steps": args.steps,
        "samples": S, "chunk": args.chunk, "tile": args.tile, "budget_full": budget_full,
        "model_type": run_args.model_type,
        "pose_image": args.pose_image if baked_pose is not None else None,
        "pose_views_scored": data.num_images,
        "distill_bias": args.distill_bias,
        "serve_dtype": "bfloat16" if serve_dtype is not None else "float32",
        "device": device.type,
        "distill_seconds": round(distill_s, 1),
        "distill_final_mse": None if np.isnan(loss) else round(float(loss), 5),
        "distill_loss_history": distill_history,
        "resumed": {"field": field_resumed, "teacher_render": teacher_resumed},
        "teacher": teacher_scores, "distilled": dist_scores, "distill_gap": gap_scores,
        "finetune": ft_meta, "finetune2": ft2_meta, "ess": ess_meta,
        "ray_cull": ray_cull_meta, "latency_ms": latency,
    }
    with open(os.path.join(args.out_dir, "scores.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print("wrote", os.path.join(args.out_dir, "scores.json"))
    return out


if __name__ == "__main__":
    main()
