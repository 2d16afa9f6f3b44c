"""Re-score persisted renders against their ground truth (counterpart of
tools/rescore_renders.py).

    python rescore_renders_torch.py --scan runs [--match S] [--force] [--dry_run] [--device cuda]
    python rescore_renders_torch.py --renders_dir D [--ground_truth_dir G] \
        [--model_type smpl_nerf|pix2pix|...] [--force] [--dry_run]

`inference_torch.py`, `run_baselines_torch.py` and `pix2pix_baseline_torch.py`
leave img_NNN.png renders and a scores.json beside them. This tool computes
the metrics again from those files (`evaluation/scores.print_scores` on the
chosen device) and merges them into scores.json: the old metrics win unless
--force (PSNR from 8-bit files drifts ~0.01 dB from the float scores), new
ones are added, and the ground-truth directory is recorded.

  * --scan DIR walks DIR/*/renders_val*/scores.json and DIR/*/scores.json;
    where the recorded ground_truth_dir still exists and rlpips is missing
    (or --force), it re-scores.
  * --renders_dir / --ground_truth_dir re-score one pair (the ground truth
    defaults to the one scores.json records).

Renders on disk are RGB PNGs (`save_rerenders` flips the pipeline's BGR);
`data/png.read_png` returns BGR, as the dataset loader does, so both sides
are compared in BGR. A pix2pix split's ground truth comes through
`cli/pix2pix.load_pairs` (RGB, flipped to BGR). Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import datasets, png
from smpl_nerf_tpu_torch.evaluation.scores import print_scores


def load_renders(renders_dir: str) -> np.ndarray:
    """[N, h, w, 3] BGR in [0, 1] from renders_dir/img_*.png, in name order."""
    paths = sorted(glob.glob(os.path.join(renders_dir, "img_*.png")))
    if not paths:
        raise FileNotFoundError(f"no img_*.png under {renders_dir}")
    return np.stack([png.read_png(p) for p in paths]).astype(np.float32) / 255.0


def load_truths(ground_truth_dir: str, model_type: str = "smpl_nerf",
                device=DEFAULT_DEVICE) -> np.ndarray:
    """[N, h, w, 3] BGR ground truth of a split, through the loader inference uses."""
    if model_type == "pix2pix":
        from smpl_nerf_tpu_torch.cli.pix2pix import load_pairs
        rgb, _ = load_pairs(ground_truth_dir)
        return np.asarray(rgb)[..., ::-1]
    data = datasets.load_dataset(ground_truth_dir, model_type, device=device)
    return np.asarray(data.rgb).reshape(data.num_images, data.h, data.w, 3)


def rescore(renders_dir: str, ground_truth_dir: str, model_type: str, force: bool = False,
            update: bool = True, device=DEFAULT_DEVICE) -> dict:
    """The merged scores of one renders directory; written back unless not `update`."""
    dev = resolve_device(device)
    scores_path = os.path.join(renders_dir, "scores.json")
    old = {}
    if os.path.exists(scores_path):
        with open(scores_path) as fh:
            old = json.load(fh)
    renders = load_renders(renders_dir)
    truths = load_truths(ground_truth_dir, model_type, dev)
    if len(renders) != len(truths):
        raise ValueError(f"{renders_dir}: {len(renders)} renders vs "
                         f"{len(truths)} ground-truth images")
    print(f"-- {renders_dir} vs {ground_truth_dir} ({len(renders)} images)")
    fresh = print_scores(renders, truths, device=dev)
    merged = {**fresh, **old} if not force else {**old, **fresh}
    merged.setdefault("ground_truth_dir", ground_truth_dir)
    if update:
        with open(scores_path, "w") as fh:
            json.dump(merged, fh, indent=1)
    return merged


def main(argv: Optional[Sequence[str]] = None) -> list:
    """The merged scores of every directory re-scored."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scan", default=None, help="runs dir to walk")
    ap.add_argument("--match", default="", help="substring filter for --scan")
    ap.add_argument("--renders_dir", default=None)
    ap.add_argument("--ground_truth_dir", default=None)
    ap.add_argument("--model_type", default="smpl_nerf")
    ap.add_argument("--force", action="store_true",
                    help="overwrite existing metrics instead of only adding")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.renders_dir:
        if not args.ground_truth_dir:
            with open(os.path.join(args.renders_dir, "scores.json")) as fh:
                args.ground_truth_dir = json.load(fh)["ground_truth_dir"]
        return [rescore(args.renders_dir, args.ground_truth_dir, args.model_type, args.force,
                        update=not args.dry_run, device=dev)]
    if not args.scan:
        ap.error("need --scan or --renders_dir")
    done = []
    for scores_path in sorted(
            glob.glob(os.path.join(args.scan, "*", "renders_val*", "scores.json"))
            + glob.glob(os.path.join(args.scan, "*", "scores.json"))):
        run = os.path.relpath(scores_path, args.scan)
        if args.match not in run:
            continue
        with open(scores_path) as fh:
            sc = json.load(fh)
        gt = sc.get("ground_truth_dir")
        renders_dir = os.path.dirname(scores_path)
        if not gt or not os.path.isdir(gt):
            print(f"-- {run}: no ground_truth_dir recorded/present — skipped "
                  "(use --renders_dir/--ground_truth_dir explicitly)")
            continue
        if "rlpips" in sc and not args.force:
            print(f"-- {run}: rlpips already present — skipped")
            continue
        try:
            done.append(rescore(renders_dir, gt, args.model_type, args.force,
                                update=not args.dry_run, device=dev))
        except (ValueError, FileNotFoundError) as e:
            print(f"-- {run}: {e}")
    return done


if __name__ == "__main__":
    main()
