"""Render a novel camera path from a run directory (counterpart of tools/render_path.py).

    python -m smpl_nerf_tpu_torch.cli.render_path --run_dir D --camera_path circle \
        --number_steps N --resolution 128 --human_pose_angle A --out X.npy \
        [--save_dir DIR] [--fast 0|1|2] [--cap_fraction C] [--device cuda]

Reads D/config.txt and D/model_*.pt, builds a circle / sphere /
circle-on-sphere camera path, writes the arm angle into every joint of
`human_joints` (pose-conditioned models), renders every view through the full
pipeline or, with --fast, the foreground-culled (1) or occupancy-grid (2)
renderer, and saves the renders [N, h, w, 3] (float32, BGR as the datasets
store them) as .npy; with --save_dir also img_XXX.png and walking.gif there,
as the JAX tool writes them.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE
from smpl_nerf_tpu_torch.cli.inference import render_dataset, save_rerenders
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import datasets
from smpl_nerf_tpu_torch.training import checkpoints


def camera_path_data(camera_path: str, number_steps: int, camera_radius: float,
                     start_angle: float, end_angle: float, resolution: int,
                     human_joints: Optional[Sequence[int]], human_pose_angle: float
                     ) -> datasets.RayData:
    """Rays of the camera path, with the pose table for pose-conditioned models."""
    if camera_path == "circle":
        cams, _ = cameras.get_circle_poses(start_angle, end_angle, number_steps, camera_radius)
    elif camera_path == "sphere":
        cams, _ = cameras.get_sphere_poses(start_angle, end_angle,
                                           int(np.sqrt(number_steps)) or 1, camera_radius)
    elif camera_path == "circle_on_sphere":
        cams, _ = cameras.get_circle_on_sphere_poses(number_steps, 10.0, camera_radius)
    else:
        raise ValueError(f"unknown camera_path {camera_path!r}")
    data = datasets.rays_from_cameras(cams, resolution, resolution, np.pi / 3)
    if human_joints is not None:
        pose = np.zeros((data.num_images, 69), np.float32)
        for j in human_joints:
            pose[:, int(j)] = np.deg2rad(human_pose_angle)
        data.human_poses = pose
    return data


def render_path(run_dir: str, camera_path: str = "circle", number_steps: int = 30,
                camera_radius: float = 2.4, start_angle: float = -90, end_angle: float = 90,
                resolution: int = 128, human_pose_angle: float = 0.0,
                batch_size: Optional[int] = None, device=DEFAULT_DEVICE, fast: int = 0,
                cap_fraction: float = 0.0) -> np.ndarray:
    """Renders [number_steps, resolution, resolution, 3] of the run's novel views."""
    run_args = checkpoints.load_config(run_dir)
    joints = (None if run_args.model_type in ("nerf", "original_nerf")
              else run_args.human_joints)
    data = camera_path_data(camera_path, number_steps, camera_radius, start_angle,
                            end_angle, resolution, joints, human_pose_angle)
    return render_dataset(run_args, run_dir, data, fast=fast, cap_fraction=cap_fraction,
                          batch_size=batch_size, device=device)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run_dir", required=True)
    p.add_argument("--camera_path", default="circle",
                   choices=["circle", "sphere", "circle_on_sphere"])
    p.add_argument("--number_steps", type=int, default=30)
    p.add_argument("--camera_radius", type=float, default=2.4)
    p.add_argument("--start_angle", type=float, default=-90)
    p.add_argument("--end_angle", type=float, default=90)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--human_pose_angle", type=float, default=0.0,
                   help="arm angle (deg) written into the varied joints for "
                        "pose-conditioned models")
    p.add_argument("--batch_size", type=int, default=None,
                   help="rays per render batch (default: the run's batchsize_val)")
    p.add_argument("--fast", type=int, default=0,
                   help="1: foreground-culled hierarchical renderer (render/fast.py); "
                        "2: occupancy-grid culled: cull scores from a baked density voxel "
                        "grid, no net on background rays")
    p.add_argument("--cap_fraction", type=float, default=0.0,
                   help="--fast: fraction of rays fine-rendered (top opacity). <=0: derive "
                        "from occupancy probe counts (fast=2) or use 0.25 (fast=1)")
    p.add_argument("--out", default="renders_path.npy")
    p.add_argument("--save_dir", default=None,
                   help="also write img_XXX.png and walking.gif into this directory")
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    args = p.parse_args(argv)
    renders = render_path(args.run_dir, args.camera_path, args.number_steps,
                          args.camera_radius, args.start_angle, args.end_angle,
                          args.resolution, args.human_pose_angle, args.batch_size,
                          args.device, args.fast, args.cap_fraction)
    np.save(args.out, renders)
    if args.save_dir:
        save_rerenders(renders, args.save_dir)
    print(f"{renders.shape[0]} novel views -> {args.out}")
    return renders


if __name__ == "__main__":
    main()
