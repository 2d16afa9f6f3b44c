"""The nearest-neighbour baseline on a dataset's val split (counterpart of
tools/run_baselines.py).

    python run_baselines_torch.py --dataset_dir D [--out DIR] [--pose_weight W] [--device cuda]

Renders every val view by the training image of nearest (camera, pose)
(baselines/nearest_neighbors.py), prints MSE / PSNR / SSIM (and rLPIPS from
32 px, LPIPS with the local weights), and with --out writes img_XXX.png,
walking.gif (`cli/inference.save_rerenders`) and scores.json there. The
scores run on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.baselines.nearest_neighbors import evaluate_nearest_neighbors
from smpl_nerf_tpu_torch.cli.inference import save_rerenders
from smpl_nerf_tpu_torch.data import datasets


def main(argv: Optional[Sequence[str]] = None) -> Tuple[np.ndarray, dict]:
    """(renders [N, h, w, 3] BGR, scores)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--pose_weight", type=float, default=1.0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu: where the scores run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    train, val = (datasets.load_dataset(os.path.join(args.dataset_dir, split), "smpl_nerf",
                                        device=dev) for split in ("train", "val"))
    renders, scores = evaluate_nearest_neighbors(train, val, args.pose_weight, device=dev)
    if args.out:
        save_rerenders(renders, args.out)
        with open(os.path.join(args.out, "scores.json"), "w") as fh:
            json.dump(scores, fh, indent=1)
        print("NN baseline renders + scores ->", args.out)
    return renders, scores


if __name__ == "__main__":
    main()
