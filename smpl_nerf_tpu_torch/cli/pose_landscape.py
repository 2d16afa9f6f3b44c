"""Loss landscape of image-wise pose optimisation (counterpart of tools/pose_landscape.py).

    python pose_landscape_torch.py --run_dir runs/<image_wise_run> \
        --dataset_dir data/arm25_256/train --angles -10 60 36 --rays 8192 [--device cuda]

Sweeps the two arm angles (joints 38 and 41, the dims
`DummyImageWiseEstimator` trains) through the run's frozen coarse net and
prints the photometric loss of `training/image_wise.make_pose_loss` at each
angle, on a deterministic strided subset of the split's rays at the mid-bin
z values of the coarse sampling. Writes {'gt_deg', 'landscape'} to --out when
given, as the JAX tool does. The net runs as a plain module, as the JAX
tool's loss applies it: no kernel is on this path. Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.cli.inference import setup_from_run_dir
from smpl_nerf_tpu_torch.core.sampling import coarse_bins
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.models.dummy_estimators import LEFT_ARM_JOINT, RIGHT_ARM_JOINT
from smpl_nerf_tpu_torch.pipelines import RenderConfig
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params, dataset_extras
from smpl_nerf_tpu_torch.training.image_wise import make_pose_loss


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run_dir", required=True,
                    help="completed image_wise_dynamic run (frozen coarse NeRF)")
    ap.add_argument("--dataset_dir", required=True,
                    help="split dir rendered at the GOAL pose")
    ap.add_argument("--angles", nargs=3, type=float, default=(-10.0, 60.0, 36),
                    metavar=("START", "END", "STEPS"), help="degrees")
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    return ap


def mid_bin_z(near: float, far: float, S: int) -> np.ndarray:
    """[S] the coarse bins' midpoints, the last bin's far edge last."""
    base = coarse_bins(float(near), float(far), S).numpy()
    mids = 0.5 * (base[1:] + base[:-1])
    return np.concatenate([mids, base[-1:]]).astype(np.float32)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """{'gt_deg': [left, right], 'landscape': [{'angle_deg', 'loss'}, ...]}."""
    args = arg_parser().parse_args(argv)
    dev = resolve_device(args.device)
    run_args = setup_from_run_dir(args.run_dir)
    data = datasets.load_dataset(args.dataset_dir, run_args.model_type, run_args, device=dev)
    extras = dataset_extras(run_args, data)
    extras.setdefault("canonical_pose", np.zeros(69, np.float32))
    gt = (data.human_poses[0] if data.human_poses is not None
          else np.zeros(69, np.float32))
    models, encoders = build_models_and_params(run_args, device=dev, extras=extras)
    for name, sd in checkpoints.load_run(args.run_dir).items():
        if name in models:
            models[name].load_state_dict(sd)

    cfg = RenderConfig.from_args(run_args)
    betas = torch.as_tensor(extras["betas"], dtype=torch.float32, device=dev).reshape(-1)
    pose_loss = make_pose_loss(extras["smpl_model"], betas, cfg, models["model_coarse"],
                               encoders["position"], encoders["direction"])

    # deterministic strided ray subset + mid-bin z values
    n = data.num_rays
    idx = np.linspace(0, n - 1, min(args.rays, n)).astype(np.int64)
    origins = torch.as_tensor(data.origins[idx], device=dev)
    dirs = torch.as_tensor(data.directions[idx], device=dev)
    rgb = torch.as_tensor(data.rgb[idx], device=dev)
    S = int(run_args.number_coarse_samples)
    z = torch.as_tensor(mid_bin_z(run_args.near, run_args.far, S), device=dev)
    z = z.expand(len(idx), S)

    print(f"ground-truth arm angles: {np.rad2deg(gt[LEFT_ARM_JOINT]):.1f} / "
          f"{np.rad2deg(gt[RIGHT_ARM_JOINT]):.1f} deg; probing {len(idx)} rays")
    start, end, steps = args.angles
    rows = []
    with torch.no_grad():
        for a in np.linspace(start, end, int(steps)):
            pose = np.zeros(69, np.float32)
            pose[LEFT_ARM_JOINT] = pose[RIGHT_ARM_JOINT] = np.deg2rad(a)
            loss = float(pose_loss(torch.as_tensor(pose, device=dev), origins, dirs, z, rgb))
            rows.append({"angle_deg": round(float(a), 3), "loss": loss})
            print(f"angle {a:7.2f} deg  loss {loss:.6f}")
    best = min(rows, key=lambda r: r["loss"])
    print(f"minimum at {best['angle_deg']} deg (loss {best['loss']:.6f})")
    result = {"gt_deg": [float(np.rad2deg(gt[LEFT_ARM_JOINT])),
                         float(np.rad2deg(gt[RIGHT_ARM_JOINT]))],
              "landscape": rows}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
        print("landscape ->", args.out)
    return result


if __name__ == "__main__":
    main()
