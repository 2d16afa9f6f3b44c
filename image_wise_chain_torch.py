#!/usr/bin/env python3
"""The image-wise analysis-by-synthesis chain on the PyTorch/CUDA port
(counterpart of scripts/run_round3_extras.sh, stage 3b), then the tools that
read its trained runs.

    python image_wise_chain_torch.py [--out_dir runs/image_wise_chain] [--resolution 256] \
        [--canon_epochs 30] [--iw_epochs 40] [--steps_per_epoch 2000] [--device cuda]

Runs the port's entry points in turn, in this process:
  1. `create_dataset_torch` (cli.dataset): two smpl_nerf sets of --views
     circle views, `canonical` (arm 0 deg) and `arm25` (arm 25 deg);
  2. `train_torch` (cli.train): the canonical coarse-only `nerf` teacher with
     the shell's flags;
  3. `train_torch`: image_wise_dynamic on arm25 from the teacher's frozen
     coarse net (`--load_coarse_model=<teacher>/best --lrate_pose=3e-3
     --warp_radius=0.15`): the recovered arm angles;
  4. `pose_landscape_torch` on that run and arm25/train (-10..60 deg in 36
     steps, 8,192 rays) into <run>/landscape.json;
then, on the teacher's best weights: `measure_render_256_torch` (the four
whole-image candidates at --resolution), `inference_torch` on canonical/val
and `rescore_renders_torch` on its renders (forced, not written back: the
scores from the 8-bit files), `aliasing_floor_torch` on both val splits, and
`distill_torch` with the flags of tools/distill_run.py's usage (--grid 16
--hidden 32 --steps 3000), whose scores stand beside the teacher's.

Writes <out_dir>/chain.json with every number printed, each step's host
seconds and the card's name and power limit. --train_flags and
--distill_flags are appended to the training runs' and the distill run's
flags (later flags win; pass them as --train_flags="--netwidth=32 ...", since
a value that starts with "--" must follow "="): a run on the CPU passes small
nets there. Runs on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import time
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.cli import aliasing_floor, distill, inference, measure_render
from smpl_nerf_tpu_torch.cli import pose_landscape, rescore_renders
from smpl_nerf_tpu_torch.cli import dataset as dataset_cli
from smpl_nerf_tpu_torch.cli import train as train_cli
from smpl_nerf_tpu_torch.cli.mlp_roofline import card_line

# the shell's flags shared by both training runs (run_round3_extras.sh:51-68)
COMMON_TRAIN = ("--config=/dev/null", "--batchsize=2048", "--batchsize_val=4096",
                "--number_coarse_samples=64", "--run_fine=0", "--white_background=1",
                "--near=1.0", "--far=4.0", "--skips=4", "--compute_dtype=bfloat16",
                "--use_pallas=1", "--number_validation_images=0", "--render_gif=0")
TEACHER = ("--model_type=nerf", "--sigma_noise_std=1", "--lrate=5e-4", "--scan_steps=16",
           "--foreground_sample_ratio=0.5", "--val_rays=131072",
           "--experiment_name=canonical_nerf_256")
IMAGE_WISE = ("--model_type=image_wise_dynamic", "--sigma_noise_std=0", "--lrate_pose=3e-3",
              "--warp_radius=0.15", "--experiment_name=image_wise_256")
ARM_SETS = (("canonical", 0), ("arm25", 25))
LANDSCAPE = ("--angles", "-10", "60", "36", "--rays", "8192")
DISTILL = ("--grid=16", "--hidden=32", "--steps=3000")


def arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out_dir", default="runs/image_wise_chain")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--views", type=int, default=40, help="circle views per set")
    p.add_argument("--canon_epochs", type=int, default=30)
    p.add_argument("--iw_epochs", type=int, default=40)
    p.add_argument("--steps_per_epoch", type=int, default=2000,
                   help="the teacher's steps per epoch")
    p.add_argument("--train_flags", default="", help="appended to both training runs")
    p.add_argument("--distill_flags", default="", help="appended to the distill run")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    return p


class _Steps:
    """Host seconds of each step, printed as it ends."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, {}

    def run(self, name: str, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0
        print(f"[chain] {name}: {self.seconds[name]:.1f} s")
        return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out, device_flag = args.out_dir, f"--device={args.device}"
    data = {name: os.path.join(out, "data", name) for name, _ in ARM_SETS}
    teacher_dir = os.path.join(out, "canonical_nerf")
    teacher = os.path.join(teacher_dir, "best")
    iw_dir = os.path.join(out, "image_wise")
    train_extra = shlex.split(args.train_flags)
    steps = _Steps(dev)
    chain = {"card": card_line(dev), "device": str(dev),
             "cuts": {k: getattr(args, k) for k in ("resolution", "views", "canon_epochs",
                                                     "iw_epochs", "steps_per_epoch",
                                                     "train_flags", "distill_flags")}}

    for name, angle in ARM_SETS:
        steps.run(f"dataset_{name}", lambda n=name, a=angle: dataset_cli.main([
            f"--save_dir={data[n]}", "--dataset_type=smpl_nerf",
            f"--resolution={args.resolution}", "--camera_path=circle",
            f"--number_steps={args.views}", "--multi_human_pose=1", "--human_number_steps=1",
            f"--human_start_angle={a}", f"--human_end_angle={a}", device_flag]))

    solver = steps.run("teacher", lambda: train_cli.train(
        [*COMMON_TRAIN, *TEACHER, f"--dataset_dir={data['canonical']}",
         f"--steps_per_epoch={args.steps_per_epoch}", f"--num_epochs={args.canon_epochs}",
         *train_extra], log_dir=teacher_dir, device=dev))
    chain["teacher_train"] = {"val_loss": solver.history["val_loss"],
                              "final_step_loss": solver.history["step_loss"][-1]}

    final, pose_errors = steps.run("image_wise", lambda: train_cli.train(
        [*COMMON_TRAIN, *IMAGE_WISE, f"--dataset_dir={data['arm25']}",
         f"--load_coarse_model={teacher}", f"--num_epochs={args.iw_epochs}", *train_extra],
        log_dir=iw_dir, device=dev))
    arms = [float(np.rad2deg(float(final["smpl_estimator"][k])))
            for k in ("arm_angle_l", "arm_angle_r")]
    print(f"[chain] image_wise: recovered arm angles {arms[0]:.2f} / {arms[1]:.2f} deg "
          f"(ground truth 25)")
    chain["image_wise"] = {"arm_angles_deg": arms, "pose_errors": pose_errors}

    landscape = steps.run("landscape", lambda: pose_landscape.main(
        ["--run_dir", iw_dir, "--dataset_dir", os.path.join(data["arm25"], "train"),
         *LANDSCAPE, "--out", os.path.join(iw_dir, "landscape.json"), device_flag]))
    best = min(landscape["landscape"], key=lambda r: r["loss"])
    chain["landscape"] = {**landscape, "minimum_deg": best["angle_deg"],
                          "minimum_loss": best["loss"]}

    render = steps.run("measure_render", lambda: measure_render.measure(
        teacher, args.resolution, dev))
    chain["measure_render"] = {"resolution": render["resolution"], "ms": render["ms"]}

    renders_dir = os.path.join(out, "renders_val")
    chain["teacher_scores"] = steps.run("inference", lambda: inference.inference(
        [f"--inf_run_dir={teacher}", f"--inf_ground_truth_dir={data['canonical']}/val",
         f"--inf_save_dir={renders_dir}", "--inf_batchsize=4096", device_flag]))
    chain["rescored"] = steps.run("rescore", lambda: rescore_renders.main(
        [f"--renders_dir={renders_dir}", "--force", "--dry_run", device_flag]))[0]

    chain["aliasing_floor"] = {name: steps.run(f"aliasing_floor_{name}",
                                               lambda n=name: aliasing_floor.main(
                                                   [f"--dataset_dir={data[n]}/val",
                                                    device_flag]))
                               for name, _ in ARM_SETS}

    scores = steps.run("distill", lambda: distill.main(
        [f"--run_dir={teacher}", f"--dataset_dir={data['canonical']}/val",
         f"--out_dir={os.path.join(out, 'distill')}", *DISTILL,
         *shlex.split(args.distill_flags), device_flag]))
    chain["distill"] = {k: scores[k] for k in ("teacher", "distilled", "distill_gap",
                                               "latency_ms", "ess", "distill_seconds",
                                               "distill_final_mse")}
    lat = scores["latency_ms"]
    print(f"[chain] distilled {scores['distilled']} beside the teacher's {scores['teacher']}; "
          f"ms per view: teacher {lat['teacher']}, distilled (tiled) {lat['tiled']}, "
          f"ESS fused kernel {lat.get('ess_fused_kernel')}")
    chain["seconds"] = steps.seconds
    path = os.path.join(out, "chain.json")
    with open(path, "w") as fh:
        json.dump(chain, fh, indent=1, default=float)
    print("[chain] ->", path)
    return chain


if __name__ == "__main__":
    main()
