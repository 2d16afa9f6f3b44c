"""Compare pix2pix baseline renders and SMPL-NeRF renders with the ground
truth (counterpart of evaluate_pix2pix.py).

    python evaluate_pix2pix_torch.py --gt_dir G --nerf_dir N [--pix2pix_dir P] \
        [--out comparison.gif] [--device cuda]

Reads three directories of PNGs (through data/png.py) in file-name order,
prints MSE / PSNR / SSIM (rLPIPS from 32 px, LPIPS with the local weights)
of each method against the ground truth over the views both have, and
writes a side-by-side GIF [ground truth | smpl-nerf | pix2pix] (data/gif.py).
Pix2pix renders that hold [rgb | depth] side by side are cropped to their
rgb half. The scores run on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import gif, png
from smpl_nerf_tpu_torch.evaluation.scores import print_scores


def load_images(directory: str) -> np.ndarray:
    """[N, h, w, 3] RGB float32 in [0, 1] of a directory's PNGs."""
    paths = sorted(glob.glob(os.path.join(directory, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no PNGs in {directory}")
    return np.stack([png.read_png(p)[..., ::-1] for p in paths]).astype(np.float32) / 255.0


def plot_images_side_by_side(*image_stacks, labels=None, out_path: str = "comparison.gif"
                             ) -> None:
    """A GIF whose frame i holds image i of every stack, left to right."""
    n = min(len(s) for s in image_stacks)
    frames = [(np.concatenate([np.clip(s[i], 0, 1) for s in image_stacks], axis=1) * 255
               ).astype(np.uint8) for i in range(n)]
    gif.write_gif(out_path, frames, fps=5)
    print(f"side-by-side GIF ({labels}) -> {out_path}")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """{"smpl-nerf": scores, "pix2pix": scores (with --pix2pix_dir)}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--gt_dir", required=True)
    parser.add_argument("--nerf_dir", required=True)
    parser.add_argument("--pix2pix_dir", default=None)
    parser.add_argument("--out", default="comparison.gif")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        help="cuda (default) or cpu: where the scores run")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    gt = load_images(args.gt_dir)
    nerf = load_images(args.nerf_dir)
    stacks, labels, scores = [gt, nerf], ["ground truth", "smpl-nerf"], {}
    print("== SMPL-NeRF vs ground truth ==")
    scores["smpl-nerf"] = print_scores(nerf[:len(gt)], gt[:len(nerf)], device=dev)
    if args.pix2pix_dir:
        p2p = load_images(args.pix2pix_dir)
        if p2p.shape[2] == 2 * gt.shape[2]:
            p2p = p2p[:, :, :gt.shape[2]]
        print("== pix2pix vs ground truth ==")
        scores["pix2pix"] = print_scores(p2p[:len(gt)], gt[:len(p2p)], device=dev)
        stacks.append(p2p)
        labels.append("pix2pix")
    plot_images_side_by_side(*stacks, labels=labels, out_path=args.out)
    return scores


if __name__ == "__main__":
    main()
