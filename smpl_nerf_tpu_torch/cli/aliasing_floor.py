"""A dataset's aliasing PSNR floor (counterpart of tools/aliasing_floor.py).

    python aliasing_floor_torch.py --dataset_dir data/walking_256/val [--frames 3] \
        [--supersample 2] [--device cuda]

Ground truth rendered at one ray per pixel has jagged silhouettes that a
smooth radiance field cannot reproduce, so the val PSNR a run can reach is
bounded by PSNR(ground truth, anti-aliased render of the same scene). For
`--frames` evenly spaced views of the split this ray traces the posed body
(`render/raytrace.render_scene`) at h*ss x w*ss, box-filters it to h x w and
prints that bound per view and its mean.

The body is the one the generator used: the SMPL pkl and PNG texture named
in the set's create_dataset_config.txt where those files exist
(`models/smpl.load_smpl_pkl`, `data/generate.load_texture`), else the
procedural human with its vertex colours. Runs on the card unless
`--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import png
from smpl_nerf_tpu_torch.data.generate import load_texture
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.render import raytrace


def generator_config(dataset_dir: str) -> dict:
    """key -> value of the create_dataset_config.txt beside the split, or {}."""
    path = os.path.join(os.path.dirname(dataset_dir.rstrip("/")), "create_dataset_config.txt")
    cfg = {}
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                if "=" in line:
                    k, _, v = line.partition("=")
                    cfg[k.strip()] = v.strip()
    return cfg


def body_and_colours(gen_cfg: dict):
    """(SMPL model, render_scene keyword arguments) of the generator's body."""
    model, render_kwargs = smpl_mod.procedural_human(), {}
    smpl_path = gen_cfg.get("smpl_model_path", "")
    if smpl_path and smpl_path != "None" and os.path.exists(smpl_path):
        model = smpl_mod.load_smpl_pkl(smpl_path)
        tex_path = gen_cfg.get("texture_path", "")
        if tex_path and tex_path != "None" and os.path.exists(tex_path):
            render_kwargs = dict(uv=model.uv, texture=load_texture(tex_path))
    if not render_kwargs:
        render_kwargs = dict(vertex_colors=model.vertex_colors)
    return model, render_kwargs


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """{'views': image names, 'psnr': each view's floor, 'mean': their mean}."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset_dir", required=True,
                   help="a split dir containing transforms.json")
    p.add_argument("--frames", type=int, default=3,
                   help="number of evenly spaced views to measure")
    p.add_argument("--supersample", type=int, default=2)
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="cuda (default) or cpu (the plain PyTorch versions)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    with open(os.path.join(args.dataset_dir, "transforms.json")) as fh:
        meta = json.load(fh)
    names = sorted(meta["image_transform_map"])
    names = [names[i] for i in np.linspace(0, len(names) - 1, args.frames).astype(int)]
    camera_angle_x = float(meta.get("camera_angle_x", np.pi / 3))
    model, render_kwargs = body_and_colours(generator_config(args.dataset_dir))

    betas = np.asarray(meta.get("betas", np.zeros(10)), np.float32)
    ss = int(args.supersample)
    psnrs = []
    for name in names:
        cam = np.asarray(meta["image_transform_map"][name], np.float32)
        pose = np.asarray(meta.get("image_pose_map", {}).get(name, np.zeros(69)), np.float32)
        verts = smpl_mod.smpl_forward(model, betas.reshape(-1),
                                      torch.as_tensor(pose, device=dev)).cpu().numpy()
        gt = png.read_png(os.path.join(args.dataset_dir, name))
        gt = gt[:, :, ::-1].astype(np.float32) / 255
        h, w = gt.shape[:2]
        hi = raytrace.render_scene(verts, model.faces, cam, h * ss, w * ss, camera_angle_x,
                                   device=dev, **render_kwargs)
        aa = hi.astype(np.float32).reshape(h, ss, w, ss, 3).mean((1, 3)) / 255
        mse = float(((aa - gt) ** 2).mean())
        psnrs.append(float(-10 * np.log10(mse)))
        print(f"{name}: aliasing-floor PSNR {psnrs[-1]:.2f}")
    mean = float(np.mean(psnrs))
    print(f"MEAN aliasing-floor PSNR over {len(names)} views: {mean:.2f}")
    return {"views": names, "psnr": psnrs, "mean": mean}


if __name__ == "__main__":
    main()
