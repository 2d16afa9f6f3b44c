"""Ray datasets (counterpart of smpl_nerf_tpu/data/datasets.py).

`RayData` is a bundle of dense numpy ray arrays for one split. A trainer or a
render moves the arrays of `batch_arrays` to the device once; a batch is an
index gather (`training.solver.gather_batch`).

`load_dataset` reads a split directory in the reference's file format:
`transforms.json` {camera_angle_x, image_transform_map[, image_pose_map,
betas, expression]} beside the PNGs it names. Images are read with
`data/png.py` in the reference's contract: float32 in [0, 1], **BGR** channel
order, alpha dropped (the reference trains in BGR and flips only for
display). Ported for nerf, smpl_nerf, append_to_nerf, append_smpl_params,
the SMPL-driven families (dummy_dynamic, image_wise_dynamic,
append_vertex_locations_to_nerf: the same image_pose_map + betas; their rays
stay stored contiguously per image, which --images_per_batch relies on) and
original_nerf, whose split directory follows the Blender NeRF schema instead
(`transforms.json` {camera_angle_x, frames: [{file_path, transform_matrix}]}).

The other families add their own arrays:
  * smpl / warp: the `depth_XXX.npy` / `warp_XXX.npy` companions the
    generator writes (data/generate.py) give one surface sample per ray (at
    --far where the ray misses), its ground-truth warp and its depth;
  * vertex_sphere: directions normalised in place, ONE coarse jitter for the
    whole split drawn from the global numpy generator (after the caller's
    `np.random.seed`; train is loaded before val), z values from that jitter,
    from a GMM prior over every body entry / exit point
    (--coarse_samples_from_prior) or around the first hit
    (--coarse_samples_from_intersect, and S == 1), then the per-sample
    ground-truth warps (`ops/vertex_sphere.py`), precomputed on `device`.
    Where those arrays (N_rays x S x 7 floats) would pass 2 GiB, or with
    --vertex_sphere_in_step=1, only the per-image goal meshes and the jitter
    are kept and the pipeline recomputes the warps per batch (the same gate
    as the JAX loader, so the same flags pick the same mode);
  * smpl_estimator: the images themselves, [N_img, h, w, 3].
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Optional

import numpy as np

import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.config import MODEL_TYPES
from smpl_nerf_tpu_torch.core import rays as rays_mod
from smpl_nerf_tpu_torch.core import sampling
from smpl_nerf_tpu_torch.data import png

# precomputed vertex_sphere arrays above this many bytes send a split to the in-step path
VERTEX_SPHERE_PRECOMPUTE_BYTES = 2 * 1024 ** 3


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
    # smpl / warp: one surface sample per ray
    surface_samples: Optional[np.ndarray] = None  # [N, 3]
    warp: Optional[np.ndarray] = None             # [N, 3]
    depth: Optional[np.ndarray] = None            # [N]
    # vertex_sphere, precomputed
    z_vals: Optional[np.ndarray] = None           # [N, S]
    ray_samples: Optional[np.ndarray] = None      # [N, S, 3]
    sample_warps: Optional[np.ndarray] = None     # [N, S, 3]
    # vertex_sphere, in-step: the warps are recomputed per batch
    vs_goal_verts: Optional[np.ndarray] = None    # [N_img, V, 3]
    vs_z: Optional[np.ndarray] = None             # [S] the split's shared coarse jitter
    # smpl_estimator
    images: Optional[np.ndarray] = None           # [N_img, h, w, 3], BGR in [0, 1]

    @property
    def num_rays(self) -> int:
        return self.origins.shape[0]

    def batch_arrays(self, model_type: str) -> dict:
        """The arrays a pipeline batch gathers from, keyed by batch-dict names.

        Keys ending in '_table' are PER-IMAGE arrays: a batch gather maps them
        through image_indices instead of the ray index. Poses are stored once
        per image, not once per ray. Keys ending in '_itable' are per-image
        tables the batch carries whole: in-step vertex_sphere's goal meshes,
        which the pipeline reads for the batch's images only.
        """
        out = {"ray_translation": self.origins, "ray_direction": self.directions,
               "image_indices": self.image_indices}
        if self.rgb is not None:
            out["rgb"] = self.rgb
        if self.human_poses is not None:
            out["human_pose_table"] = self.human_poses
        if model_type in ("smpl", "warp"):
            out.update(ray_samples=self.surface_samples, warp=self.warp,
                       z_vals=self.depth[:, None])
        if model_type == "vertex_sphere":
            if self.ray_samples is not None:
                out.update(ray_samples=self.ray_samples, warp=self.sample_warps,
                           z_vals=self.z_vals)
            else:
                out["goal_verts_itable"] = self.vs_goal_verts
                out["vs_z_table"] = np.tile(self.vs_z[None], (self.num_images, 1))
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


def load_dataset(directory: str, model_type: str, args=None,
                 device=DEFAULT_DEVICE) -> RayData:
    """Load one split directory for the given model_type. args: the training
    flags (--far for smpl / warp; vertex_sphere's sampling flags, and the SMPL
    model on `args._smpl_model`, else the procedural human); device: where
    vertex_sphere's LBS, intersections and warps run."""
    if model_type not in MODEL_TYPES:
        raise ValueError(f"unknown model_type {model_type!r}")
    if model_type == "original_nerf":
        return _load_original_nerf(directory)
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
    if model_type in ("smpl", "warp"):
        _attach_single_sample(data, directory, names, args)
    elif model_type == "vertex_sphere":
        _attach_vertex_sphere(data, args, device)
    elif model_type == "smpl_estimator":
        data.images = images
    return data


def _attach_single_sample(data: RayData, directory: str, names, args) -> None:
    """One surface sample per ray from the depth / warp companions; a ray
    whose depth is 0 (a miss) samples at --far."""
    far = float(args.far) if args is not None else 4.0
    depths, warps = [], []
    for name in names:
        stem = name.replace("img_", "").replace(".png", "")
        depths.append(np.load(os.path.join(directory, f"depth_{stem}.npy")))
        warps.append(np.load(os.path.join(directory, f"warp_{stem}.npy")))
    depth = np.stack(depths).reshape(-1).astype(np.float32)
    unit_dirs = data.directions / np.linalg.norm(data.directions, axis=-1, keepdims=True)
    eff_depth = np.where(depth == 0, far, depth)
    data.surface_samples = (data.origins + unit_dirs * eff_depth[:, None]).astype(np.float32)
    data.warp = np.stack(warps).reshape(-1, 3).astype(np.float32)
    data.depth = eff_depth.astype(np.float32)


def _prior_z(t_multi: np.ndarray, hit_multi: np.ndarray, z_simple: np.ndarray, S: int,
             std: float) -> np.ndarray:
    """[hw, S] z values of the GMM prior: per sample a uniformly drawn body
    entry / exit point plus gaussian noise (RandomState(0), drawn anew for
    every image); the shared jitter on rays that miss the body."""
    hw = t_multi.shape[0]
    rng = np.random.RandomState(0)
    n_hits = hit_multi.sum(-1)
    comp = rng.randint(0, np.maximum(n_hits, 1)[:, None], (hw, S))
    means = np.take_along_axis(np.where(hit_multi, t_multi, 0.0), comp, -1)
    z_prior = means + std * rng.randn(hw, S)
    return np.where((n_hits > 0)[:, None], z_prior, z_simple[None, :]).astype(np.float32)


def _attach_vertex_sphere(data: RayData, args, device) -> None:
    """vertex_sphere's z values and per-sample ground-truth warps (or, past the
    gate, the per-image goal meshes of the in-step path)."""
    from smpl_nerf_tpu_torch.models import smpl as smpl_mod
    from smpl_nerf_tpu_torch.ops import raymesh
    from smpl_nerf_tpu_torch.ops.vertex_sphere import sample_warps_by_vertex_sphere

    S = int(args.number_coarse_samples)
    near, far = float(args.near), float(args.far)
    std = float(args.std_dev_coarse_sample_prior)
    smpl_model = getattr(args, "_smpl_model", None) or smpl_mod.procedural_human()
    data.directions = data.directions / np.linalg.norm(data.directions, axis=-1, keepdims=True)

    # one shared jitter for the whole split, from the global numpy generator
    base = sampling.coarse_bins(near, far, S).numpy()
    mids = 0.5 * (base[1:] + base[:-1])
    upper = np.concatenate([mids, base[-1:]])
    lower = np.concatenate([base[:1], mids])
    z_simple = (lower + (upper - lower) * np.random.rand()).astype(np.float32)

    dev = resolve_device(device)
    betas = data.betas if data.betas is not None else np.zeros(10, np.float32)

    def goal(i):
        return smpl_mod.smpl_forward(smpl_model, betas, torch.as_tensor(
            np.asarray(data.human_poses[i], np.float32), device=dev))

    # the gate: only the shared-jitter z path runs in-step (the others store
    # real per-ray z values)
    mode = int(getattr(args, "vertex_sphere_in_step", -1))
    prior = int(getattr(args, "coarse_samples_from_prior", 0)) and S > 1
    intersect = int(getattr(args, "coarse_samples_from_intersect", 0)) or S == 1
    per_ray_z = bool(int(getattr(args, "coarse_samples_from_prior", 0)) or intersect)
    est_bytes = data.num_rays * S * 4 * 7
    if mode == 1 or (mode < 0 and not per_ray_z and est_bytes > VERTEX_SPHERE_PRECOMPUTE_BYTES):
        if per_ray_z:
            raise ValueError(
                "--vertex_sphere_in_step=1 supports only the shared-jitter z path; "
                "--coarse_samples_from_prior/intersect need the precomputed dataset "
                "(--vertex_sphere_in_step=0)")
        data.vs_goal_verts = np.stack([goal(i).cpu().numpy()
                                       for i in range(data.num_images)]).astype(np.float32)
        data.vs_z = z_simple
        return
    radius = float(args.vertex_sphere_radius)
    by_mean = bool(int(getattr(args, "warp_by_vertex_mean", 0)))
    canonical = smpl_mod.smpl_forward(smpl_model, betas, torch.zeros(69, device=dev))
    faces = torch.as_tensor(np.asarray(smpl_model.faces), dtype=torch.long, device=dev)
    hw = data.num_rays // data.num_images
    all_z, all_samples, all_warps = [], [], []
    for i in range(data.num_images):
        goal_verts = goal(i)
        o = data.origins[i * hw:(i + 1) * hw]
        d = data.directions[i * hw:(i + 1) * hw]
        o_t, d_t = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        if prior:
            t_multi, hit_multi = raymesh.intersect_rays_multi(o_t, d_t, goal_verts, faces)
            z = _prior_z(t_multi.cpu().numpy(), hit_multi.cpu().numpy(), z_simple, S, std)
        elif intersect:
            hits = raymesh.intersect_rays(o_t, d_t, goal_verts, faces)
            t_hit, hit = hits.t.cpu().numpy(), hits.hit.cpu().numpy()
            if S == 1:
                z = np.where(hit, t_hit, far).astype(np.float32)[:, None]
            else:
                rng = np.random.RandomState(0)
                z_int = np.sort(t_hit[:, None] + std * rng.randn(hw, S), -1)
                z = np.where(hit[:, None], z_int, z_simple[None, :]).astype(np.float32)
        else:
            z = np.broadcast_to(z_simple, (hw, S)).astype(np.float32)
        samples = (o[:, None, :] + d[:, None, :] * z[..., None]).astype(np.float32)
        warps = sample_warps_by_vertex_sphere(torch.as_tensor(samples, device=dev), goal_verts,
                                              canonical - goal_verts, radius, by_mean)
        all_z.append(z)
        all_samples.append(samples)
        all_warps.append(warps.cpu().numpy())
    data.z_vals = np.concatenate(all_z)
    data.ray_samples = np.concatenate(all_samples)
    data.sample_warps = np.concatenate(all_warps)


def _load_original_nerf(directory: str) -> RayData:
    """Blender NeRF schema: frames [{file_path, transform_matrix}], images
    `<basename of file_path>.png` in `directory`, in the order of `frames`."""
    transforms = _read_transforms(directory)
    frames = transforms["frames"]
    names = [os.path.basename(f["file_path"]) + ("" if f["file_path"].endswith(".png")
                                                 else ".png") for f in frames]
    images = _read_images(directory, names)
    n, h, w = images.shape[:3]
    focal = rays_mod.focal_from_fov(w, transforms["camera_angle_x"])
    cams = np.stack([np.array(f["transform_matrix"], np.float32) for f in frames])
    origins, dirs = rays_mod.get_rays_batch_np(h, w, focal, cams)
    idx = np.repeat(np.arange(n, dtype=np.int32), h * w)
    return RayData(origins.reshape(-1, 3), dirs.reshape(-1, 3), idx, h, w, focal, n, cams,
                   rgb=images.reshape(-1, 3))


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
