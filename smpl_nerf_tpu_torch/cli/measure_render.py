"""Whole-image novel-view render latency of a trained run (counterpart of
scripts/measure_render_256.py).

    python measure_render_256_torch.py runs/<run> [256] [--device cuda]

Renders one res x res view of the run (the first camera of
`cameras.get_circle_poses(0, 30, 2, 2.4)`, field of view pi / 3; zero pose
and betas for the pose-conditioned families) as ONE batch of all res^2 rays,
through the four candidates of the JAX tool, on the same weights:

  * naive_all_rays: the full pipeline (coarse + fine) on every ray;
  * fg_culled: `render/fast.make_fast_renderer`, cap 0.25;
  * occupancy: `make_occupancy_renderer`, cap 0.25, grid baked in the call;
  * occupancy_prebaked: the same renderer on a grid baked once beforehand.

Each candidate is called once to warm up, then timed five times on the host
clock, each call ending in a copy of the render to the host (which also
waits for the card); the best of the five is printed in the JAX tool's
layout. The batch is not chunked, as the JAX tool does not chunk it: at 256^2
a `smpl_nerf` run (64 + 128 samples) sends 4,194,304 coarse and 12,582,912
fine rows through one net call each. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.cli.inference import setup_from_run_dir
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.render import batched
from smpl_nerf_tpu_torch.render.fast import make_fast_renderer, make_occupancy_renderer
from smpl_nerf_tpu_torch.training.factory import dataset_extras

CAP_FRACTION = 0.25
REPS = 5


def view_data(model_type: str, res: int) -> datasets.RayData:
    """The rays of the two-camera circle at res x res; the pose-conditioned
    families get zero poses and betas."""
    cams, _ = cameras.get_circle_poses(0, 30, 2, 2.4)
    data = datasets.rays_from_cameras(cams, res, res, np.pi / 3)
    if model_type not in ("nerf", "original_nerf"):
        data.human_poses = np.zeros((data.num_images, 69), np.float32)
        data.betas = np.zeros(10, np.float32)
    return data


def whole_image_batch(data: datasets.RayData, model_type: str, device) -> dict:
    """One batch of the first view's h*w rays: the per-ray arrays sliced, each
    per-image `_table` array's first row broadcast to every ray, no image
    indices (the JAX tool's batch)."""
    hw = data.h * data.w
    arrays = data.batch_arrays(model_type)
    batch = {k: torch.as_tensor(v[:hw], device=device) for k, v in arrays.items()
             if not k.endswith("_table") and k != "image_indices"}
    for k, v in arrays.items():
        if k.endswith("_table"):
            row = torch.as_tensor(np.asarray(v[0]), device=device)
            batch[k[:-len("_table")]] = row.expand((hw,) + tuple(row.shape))
    return batch


def candidates(pipeline, batch: dict) -> Dict[str, Callable[[], torch.Tensor]]:
    """name -> a call that renders `batch` to rgb [h*w, 3] on the device."""
    fast = make_fast_renderer(pipeline, CAP_FRACTION)
    occ = make_occupancy_renderer(pipeline, CAP_FRACTION)
    grid = occ.build_grid(batch)

    @torch.no_grad()
    def naive():
        return pipeline(batch)["rgb_fine"]

    return {"naive_all_rays": naive,
            "fg_culled": lambda: fast(batch),
            "occupancy": lambda: occ(batch),
            "occupancy_prebaked": lambda: occ(batch, grid)}


def best_of(fn: Callable[[], torch.Tensor], reps: int = REPS):
    """(best seconds of `reps` timed calls after one warm call, the last render
    on the host). Each call ends in a copy to the host, which waits for the
    device."""
    out = fn().float().cpu().numpy()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn().float().cpu().numpy()
        times.append(time.perf_counter() - t0)
    return min(times), out


def measure(run_dir: str, res: int = 256, device=DEFAULT_DEVICE) -> dict:
    """{'model_type', 'resolution', 'ms': {candidate: best ms}, 'rgb':
    {candidate: [res, res, 3] render, BGR}} of the run's whole-image view."""
    dev = resolve_device(device)
    args = setup_from_run_dir(run_dir)
    data = view_data(args.model_type, res)
    pipeline = batched.build_from_run(run_dir, args, dev, dataset_extras(args, data))
    batch = whole_image_batch(data, args.model_type, dev)
    result = {"model_type": args.model_type, "resolution": res, "ms": {}, "rgb": {}}
    for name, fn in candidates(pipeline, batch).items():
        seconds, rgb = best_of(fn)
        result["ms"][name] = seconds * 1e3
        result["rgb"][name] = rgb.reshape(res, res, 3)
        print(f"{res}x{res} {args.model_type} render [{name}]: "
              f"{seconds * 1e3:.1f} ms (best of {REPS})")
    return result


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dir")
    p.add_argument("resolution", nargs="?", type=int, default=256)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    args = p.parse_args(argv)
    return measure(args.run_dir, args.resolution, args.device)


if __name__ == "__main__":
    main()
