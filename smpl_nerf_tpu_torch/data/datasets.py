"""Ray datasets (counterpart of smpl_nerf_tpu/data/datasets.py).

`RayData` is a bundle of dense numpy ray arrays for one split. A trainer or a
render moves the arrays of `batch_arrays` to the device once; a batch is an
index gather (`training.solver.gather_batch`).

`load_dataset` reads a split directory in the reference's file format:
`transforms.json` {camera_angle_x, image_transform_map[, image_pose_map,
betas, expression]} beside the PNGs it names. Images are read with
`data/png.py` in the reference's contract: float32 in [0, 1], **BGR** channel
order, alpha dropped (the reference trains in BGR and flips only for
display). Ported for nerf, smpl_nerf, append_to_nerf and append_smpl_params;
the single-sample, vertex-sphere, estimator and original_nerf loaders are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np

from smpl_nerf_tpu_torch.core import rays as rays_mod
from smpl_nerf_tpu_torch.data import png

LOADABLE_MODEL_TYPES = ("nerf", "smpl_nerf", "append_to_nerf", "append_smpl_params")


@dataclasses.dataclass
class RayData:
    """Dense ray arrays for one split (numpy)."""
    origins: np.ndarray          # [N, 3]
    directions: np.ndarray       # [N, 3]
    image_indices: np.ndarray    # [N] int32
    h: int
    w: int
    focal: float
    num_images: int
    camera_transforms: np.ndarray            # [N_img, 4, 4]
    human_poses: Optional[np.ndarray] = None  # [N_img, 69]
    rgb: Optional[np.ndarray] = None          # [N, 3] in [0,1], BGR (reference contract)
    betas: Optional[np.ndarray] = None
    expression: Optional[np.ndarray] = None

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def batch_arrays(self, model_type: str) -> dict:
        """The arrays a pipeline batch gathers from, keyed by batch-dict names.

        Keys ending in '_table' are PER-IMAGE arrays: a batch gather maps them
        through image_indices instead of the ray index. Poses are stored once
        per image, not once per ray.
        """
        if model_type not in LOADABLE_MODEL_TYPES + ("original_nerf",):
            raise NotImplementedError(f"batch arrays of model_type {model_type!r} are not "
                                      "ported yet to smpl_nerf_tpu_torch")
        out = {"ray_translation": self.origins, "ray_direction": self.directions,
               "image_indices": self.image_indices}
        if self.rgb is not None:
            out["rgb"] = self.rgb
        if self.human_poses is not None:
            out["human_pose_table"] = self.human_poses
        return out


def _read_transforms(directory: str):
    with open(os.path.join(directory, "transforms.json")) as fh:
        return json.load(fh)


def _read_images(directory: str, names) -> np.ndarray:
    images = []
    for name in names:
        path = os.path.join(directory, name)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        images.append(png.read_png(path))
    return np.stack(images).astype(np.float32) / 255.0  # BGR in [0,1]


def load_dataset(directory: str, model_type: str) -> RayData:
    """Load one split directory for the given model_type."""
    if model_type not in LOADABLE_MODEL_TYPES:
        raise NotImplementedError(f"the dataset loader of model_type {model_type!r} is not "
                                  "ported yet to smpl_nerf_tpu_torch")
    transforms = _read_transforms(directory)
    tmap = transforms["image_transform_map"]
    names = sorted(tmap.keys())
    if len(glob.glob(os.path.join(directory, "*.png"))) != len(tmap):
        raise ValueError("number of images != number of transforms")
    images = _read_images(directory, names)
    n, h, w = images.shape[:3]
    focal = rays_mod.focal_from_fov(w, transforms["camera_angle_x"])
    cams = np.stack([np.array(tmap[name], np.float32) for name in names])
    origins, dirs = rays_mod.get_rays_batch_np(h, w, focal, cams)
    idx = np.repeat(np.arange(n, dtype=np.int32), h * w)
    data = RayData(origins.reshape(-1, 3), dirs.reshape(-1, 3), idx, h, w, focal, n, cams,
                   rgb=images.reshape(-1, 3))
    pmap = transforms.get("image_pose_map")
    if pmap is not None:
        data.human_poses = np.stack([np.array(pmap[name], np.float32) for name in names])
        data.betas = np.array(transforms.get("betas"), np.float32)
        data.expression = np.array(transforms.get("expression"), np.float32)
    return data


def rays_from_cameras(camera_transforms: np.ndarray, h: int, w: int,
                      camera_angle_x: float) -> RayData:
    """Rays from camera poses only (inference without ground truth)."""
    focal = rays_mod.focal_from_fov(w, camera_angle_x)
    cams = np.asarray(camera_transforms, np.float32)
    origins, dirs = rays_mod.get_rays_batch_np(h, w, focal, cams)
    n = cams.shape[0]
    idx = np.repeat(np.arange(n, dtype=np.int32), h * w)
    return RayData(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                   idx, h, w, focal, n, cams)


def write_dataset(directory: str, images_bgr: np.ndarray, camera_transforms: np.ndarray,
                  camera_angle_x: float, human_poses: Optional[np.ndarray] = None) -> None:
    """Write one split in the format `load_dataset` reads: img_XXX.png files
    (float images in [0,1], BGR, are rounded to 8 bits) and transforms.json."""
    os.makedirs(directory, exist_ok=True)
    transforms = {"camera_angle_x": float(camera_angle_x), "image_transform_map": {}}
    if human_poses is not None:
        transforms.update(image_pose_map={}, betas=[0.0] * 10, expression=[0.0] * 10)
    for i, image in enumerate(np.asarray(images_bgr)):
        name = f"img_{i:03d}.png"
        png.write_png(os.path.join(directory, name),
                      np.clip(np.rint(image * 255.0), 0, 255).astype(np.uint8))
        transforms["image_transform_map"][name] = np.asarray(camera_transforms[i]).tolist()
        if human_poses is not None:
            transforms["image_pose_map"][name] = np.asarray(human_poses[i]).reshape(-1).tolist()
    with open(os.path.join(directory, "transforms.json"), "w") as fh:
        json.dump(transforms, fh)
