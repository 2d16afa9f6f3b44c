"""Synthetic dataset generation (counterpart of smpl_nerf_tpu/data/generate.py).

    python create_dataset_torch.py --dataset_type=smpl --save_dir=D --resolution=64 \
        --camera_path=circle --number_steps=10 [--device cuda]

Camera paths sphere / circle / circle_on_sphere, human joint-angle sweeps or
AMASS pose sequences, the multi_human_pose / frames_per_view combinatorics, a
random disjoint train/val split drawn from the global numpy generator after
`np.random.seed(--seed)`, one PNG per view and a transforms.json per split, and
a resolved create_dataset_config.txt carrying train_index / val_index. The
four dataset types of the JAX generator: `nerf` (the canonical body),
`smpl_nerf` and `pix2pix` (posed; pix2pix puts the depth image beside the
render) and `smpl` (posed, with per-pixel `depth_XXX.npy` / `warp_XXX.npy`
companions from `render/raytrace.get_warp`; --supersample is ignored for it,
with a message, because those companions are centre-ray quantities).

Rendering runs on `render/raytrace.py`, LBS on `models/smpl.py`, both on the
device the caller names, with the procedural human unless --smpl_model_path
names the licensed pkl. PNGs go through `data/png.py` and hold what
`cv2.imwrite(cvtColor(img, RGB2BGR))` writes. A texture (only used with the
pkl) must be a PNG: the JAX generator reads any format through cv2, which
the port does not carry.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.core import cameras
from smpl_nerf_tpu_torch.data import png
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.render import raytrace

DATASET_TYPES = ("nerf", "pix2pix", "smpl_nerf", "smpl")
POSED_TYPES = ("smpl_nerf", "smpl", "pix2pix")


def disjoint_indices(size: int, ratio: float, random: bool = True):
    """(first int(size * ratio) indices, the rest) of a shuffled arange(size);
    the shuffle draws from the global numpy generator."""
    indices = np.arange(size)
    if random:
        np.random.shuffle(indices)
    split = int(size * ratio)
    return indices[:split], indices[split:]


def load_pose_sequence(path: str, start: int = 0, end: int = -1, skip: int = 1):
    """AMASS .npz -> (body poses [n, 1, 69], global orientations [n, 1, 3]):
    SMPL-H dims 3:66 are the 21 body joints, the first 63 of SMPL's 69 (the
    hands stay zero); dims 0:3 the root orientation. Frames start:end:skip."""
    data = np.load(path)
    poses = np.asarray(data["poses"], np.float32)
    body = np.zeros((len(poses), 1, 69), np.float32)
    body[:, 0, :63] = poses[:, 3:66]
    orients = poses[:, None, 0:3].astype(np.float32)
    sl = slice(start, None if end == -1 else end, skip)
    return body[sl], orients[sl]


def _camera_transforms(args) -> np.ndarray:
    if args.camera_path == "sphere":
        return cameras.get_sphere_poses(args.start_angle, args.end_angle,
                                        args.number_steps, args.camera_radius)[0]
    if args.camera_path == "circle":
        return cameras.get_circle_poses(args.start_angle, args.end_angle,
                                        args.number_steps, args.camera_radius)[0]
    if args.camera_path == "circle_on_sphere":
        return cameras.get_circle_on_sphere_poses(
            args.number_steps, args.circle_on_sphere_radius, args.camera_radius,
            args.center_theta, args.center_phi)[0]
    raise ValueError(f"unknown camera path {args.camera_path}")


def load_texture(path: Optional[str]) -> Optional[np.ndarray]:
    """uint8 RGB [h, w, 3] of a PNG texture, or None without a path."""
    if path is None:
        return None
    if not path.lower().endswith(".png"):
        raise ValueError(f"texture {path}: the port reads PNG textures only "
                         "(convert it to PNG)")
    return np.ascontiguousarray(png.read_png(path)[..., ::-1])


def _vertices(model: smpl_mod.SmplModel, betas, pose, device) -> np.ndarray:
    """[V, 3] numpy LBS vertices of one 69-dim pose, computed on `device`."""
    pose = torch.as_tensor(np.asarray(pose, np.float32).reshape(-1), device=device)
    return smpl_mod.smpl_forward(model, np.asarray(betas).reshape(-1), pose).cpu().numpy()


def save_split(save_dir: str, split: str, model: smpl_mod.SmplModel,
               camera_transforms: np.ndarray, indices, resolution: int,
               camera_angle_x: float, far: float, dataset_type: str,
               human_poses: Optional[np.ndarray], betas: np.ndarray, expression: np.ndarray,
               texture: Optional[np.ndarray] = None, supersample: int = 1,
               device=DEFAULT_DEVICE) -> None:
    """Render and write one split: img_XXX.png per index (XXX the index in
    creation order), transforms.json, and for `smpl` the depth / warp arrays."""
    if dataset_type not in DATASET_TYPES:
        raise ValueError(f"unknown dataset type {dataset_type!r}")
    directory = os.path.join(save_dir, split)
    os.makedirs(directory, exist_ok=True)
    indices = list(indices)
    cams = camera_transforms[indices]
    image_names = [f"img_{i:03d}.png" for i in indices]
    h = w = resolution
    meta = {"camera_angle_x": camera_angle_x,
            "image_transform_map": {name: cam.tolist() for name, cam in zip(image_names, cams)}}
    if dataset_type in POSED_TYPES:
        poses = human_poses[indices]
        meta["image_pose_map"] = {name: pose.reshape(-1).tolist()
                                  for name, pose in zip(image_names, poses)}
        meta["betas"] = np.asarray(betas).reshape(-1).tolist()
        meta["expression"] = np.asarray(expression).reshape(-1).tolist()

    canonical_verts = _vertices(model, betas, np.zeros(69, np.float32), device)
    ss = max(1, int(supersample))
    if ss > 1 and dataset_type == "smpl":
        print("supersample ignored for dataset_type=smpl (center-ray "
              "warp/depth companions must match the RGB ray exactly)")
        ss = 1

    def downsample(img_hi: np.ndarray) -> np.ndarray:
        """Box average of ss x ss subpixels -> [h, w, C] uint8."""
        hi = img_hi.astype(np.float32).reshape(h, ss, w, ss, -1).mean((1, 3))
        return np.clip(np.rint(hi), 0, 255).astype(np.uint8)

    render_kwargs = dict(vertex_colors=model.vertex_colors)
    if texture is not None and model.uv is not None:
        render_kwargs = dict(uv=model.uv, texture=texture)
    for k, (name, cam) in enumerate(zip(image_names, cams)):
        verts = (canonical_verts if dataset_type == "nerf"
                 else _vertices(model, betas, human_poses[indices[k]], device))
        if dataset_type == "pix2pix":
            img, depth = raytrace.render_scene(verts, model.faces, cam, h * ss, w * ss,
                                               camera_angle_x, return_depth=True,
                                               device=device, **render_kwargs)
            depth_vis = (np.clip(depth / far, 0, 1) * 255).astype(np.uint8)
            if ss > 1:
                img = downsample(img)
                depth_vis = downsample(depth_vis[..., None])[..., 0]
            img = np.concatenate([img, np.repeat(depth_vis[..., None], 3, -1)], 1)
        elif dataset_type == "smpl":
            img = raytrace.render_scene(verts, model.faces, cam, h, w, camera_angle_x,
                                        device=device, **render_kwargs)
            warp, depth = raytrace.get_warp(canonical_verts, verts, model.faces, cam, h, w,
                                            camera_angle_x, device=device)
            stem = f"{indices[k]:03d}"
            np.save(os.path.join(directory, f"warp_{stem}.npy"), warp)
            np.save(os.path.join(directory, f"depth_{stem}.npy"), depth)
        else:
            img = raytrace.render_scene(verts, model.faces, cam, h * ss, w * ss,
                                        camera_angle_x, device=device, **render_kwargs)
            if ss > 1:
                img = downsample(img)
        # img is RGB; write_png takes BGR, as cv2.imwrite does
        png.write_png(os.path.join(directory, name), np.ascontiguousarray(img[..., ::-1]))
    with open(os.path.join(directory, "transforms.json"), "w") as fh:
        json.dump(meta, fh)
    print(f"Saved {len(image_names)} {split} images under {directory}")


def create_dataset(args, parser=None, device=DEFAULT_DEVICE):
    """Generate the dataset `args` (config.dataset_config_parser) describes
    into args.save_dir; returns (train_indices, val_indices)."""
    dev = resolve_device(device)
    np.random.seed(int(getattr(args, "seed", 0)))
    camera_angle_x = np.pi / 3
    human_poses = None
    if args.camera_path == "sphere":
        dataset_size = camera_number_steps = args.number_steps ** 2
    elif args.camera_path in ("circle", "circle_on_sphere"):
        dataset_size = camera_number_steps = args.number_steps
    else:
        raise ValueError(f"unknown camera path {args.camera_path}")

    if args.smpl_sequence_file is not None:
        human_poses, _ = load_pose_sequence(args.smpl_sequence_file, args.sequence_start,
                                            args.sequence_end, args.sequence_skip)
        args.human_number_steps = len(human_poses)
        dataset_size = (dataset_size * args.human_number_steps if args.multi_human_pose
                        else len(human_poses))
    elif args.dataset_type in POSED_TYPES:
        if args.multi_human_pose:
            dataset_size = dataset_size * args.human_number_steps
        elif args.frames_per_view:
            dataset_size = args.human_number_steps
    far = args.camera_radius * 2

    camera_transforms = _camera_transforms(args)
    if args.dataset_type in POSED_TYPES and args.smpl_sequence_file is None:
        joints = [int(j) for j in args.joints]
        if args.multi_human_pose:
            human_poses = smpl_mod.get_human_poses(joints, args.human_start_angle,
                                                   args.human_end_angle,
                                                   args.human_number_steps)
            human_poses = np.tile(human_poses, (camera_number_steps, 1, 1))
            camera_transforms = np.repeat(camera_transforms, args.human_number_steps, axis=0)
        else:
            human_poses = smpl_mod.get_human_poses(joints, args.human_start_angle,
                                                   args.human_end_angle, dataset_size)
            if args.frames_per_view:
                reps = int(np.ceil(args.human_number_steps / camera_number_steps))
                camera_transforms = np.repeat(camera_transforms, reps, axis=0)
    elif args.smpl_sequence_file is not None:
        if args.multi_human_pose:
            human_poses = np.tile(human_poses, (camera_number_steps, 1, 1))
            camera_transforms = np.repeat(camera_transforms, args.human_number_steps, axis=0)
        else:
            reps = int(np.ceil(args.human_number_steps / camera_number_steps))
            if args.frames_per_view == 1:
                camera_transforms = np.concatenate([camera_transforms] * reps, axis=0)
            else:
                camera_transforms = np.repeat(camera_transforms, reps, axis=0)

    # the licensed SMPL pkl if given, else the procedural human
    smpl_path = getattr(args, "smpl_model_path", None)
    texture = None
    if smpl_path and os.path.exists(smpl_path):
        model = smpl_mod.load_smpl_pkl(smpl_path)
        texture = load_texture(getattr(args, "texture_path", None))
        betas, expression = smpl_mod.default_betas(), smpl_mod.default_expression()
    else:
        model = smpl_mod.procedural_human()
        betas = np.zeros((1, 10), np.float32)
        expression = np.zeros((1, 10), np.float32)

    train_indices, val_indices = disjoint_indices(dataset_size, args.train_val_ratio)
    train_indices, val_indices = sorted(train_indices), sorted(val_indices)
    for split, indices in (("train", train_indices), ("val", val_indices)):
        save_split(args.save_dir, split, model, camera_transforms, indices, args.resolution,
                   camera_angle_x, far, args.dataset_type, human_poses, betas, expression,
                   texture, supersample=int(getattr(args, "supersample", 1) or 1), device=dev)
    args.train_index = list(map(int, train_indices))
    args.val_index = list(map(int, val_indices))
    if parser is not None:
        parser.write_config_file(args, [os.path.join(args.save_dir,
                                                     "create_dataset_config.txt")])
    return train_indices, val_indices
