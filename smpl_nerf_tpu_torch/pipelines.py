"""Rendering pipelines (counterpart of smpl_nerf_tpu/pipelines.py): nerf, smpl_nerf
and the two append families (append_to_nerf, append_smpl_params).

A pipeline is ``pipeline(batch, generator=None, train=False) -> outputs dict``
over nn.Modules that hold their own weights. Batch layout (tensors on one
device): ray_translation [R,3], ray_direction [R,3] (+ human_pose [R,69] for
the pose-conditioned families). The append families hand the (encoded) pose,
two joints or all 69, to both nets as a per-ray conditioning prefix.

The MLP runner owns the encoding step:
  * use_fused_mlp=0: PositionalEncoder + the RenderRayNet module,
  * use_fused_mlp=1: encode, then the fused v1 forward (ops/fused_mlp.py): the
    CUDA kernel on the card, its plain version on the CPU; takes any prefix,
  * use_fused_mlp=2: raw 24 B/sample rows to the fused v2 kernels
    (ops/fused_mlp_v2.py), forward and, under autograd, backward; prefix-free
    nets only on the card,
  * use_fused_mlp=-1 (auto): as JAX's auto picks on its accelerator, mode 2
    on CUDA for each net the v2 kernels take (prefix-free, bf16, W <= 256),
    else mode 0; always mode 0 on the CPU.
Every other model_type is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from smpl_nerf_tpu_torch.core.encoding import PositionalEncoder
from smpl_nerf_tpu_torch.core.integrate import raw2outputs
from smpl_nerf_tpu_torch.core.sampling import coarse_sampling, fine_sampling
from smpl_nerf_tpu_torch.ops import fused_mlp as fused_mod
from smpl_nerf_tpu_torch.ops import fused_mlp_v2 as fused_v2

PORTED_MODEL_TYPES = ("nerf", "original_nerf", "smpl_nerf", "append_to_nerf",
                      "append_smpl_params")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The rendering configuration the ported pipelines read."""
    model_type: str = "nerf"
    near: float = 1.0
    far: float = 4.0
    number_coarse_samples: int = 64
    number_fine_samples: int = 128
    run_fine: bool = True
    sigma_noise_std: float = 0.0
    white_background: bool = False
    human_pose_encoding: bool = False
    human_joints: tuple = (41, 38)
    use_pallas: bool = False
    use_fused_mlp: int = 0  # 0 off, 1 fused MLP, 2 fused MLP + in-kernel encoding

    @classmethod
    def from_args(cls, args) -> "RenderConfig":
        return cls(
            model_type=args.model_type,
            near=float(args.near), far=float(args.far),
            number_coarse_samples=int(args.number_coarse_samples),
            number_fine_samples=int(args.number_fine_samples),
            run_fine=bool(int(args.run_fine)),
            sigma_noise_std=float(args.sigma_noise_std),
            white_background=bool(int(args.white_background)),
            human_pose_encoding=bool(int(args.human_pose_encoding)),
            human_joints=tuple(int(j) for j in args.human_joints),
            use_pallas=bool(int(getattr(args, "use_pallas", 0))),
            use_fused_mlp=int(getattr(args, "use_fused_mlp", 0) or 0),
        )


def build_encoders(args) -> Dict[str, PositionalEncoder]:
    """The three positional encoders: position, direction, human_pose."""
    return {
        "position": PositionalEncoder(int(args.number_frequencies_postitional),
                                      bool(int(args.use_identity_positional))),
        "direction": PositionalEncoder(int(args.number_frequencies_directional),
                                       bool(int(args.use_identity_directional))),
        "human_pose": PositionalEncoder(int(args.number_frequencies_pose),
                                        bool(int(args.use_identity_pose))),
    }


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def two_joint_pose(cfg: RenderConfig, batch) -> torch.Tensor:
    """The configured joints of human_pose, stacked in ascending joint order
    (the reference hardcodes [38, 41] whatever --human_joints says)."""
    gp = batch["human_pose"]
    return torch.stack([gp[:, j] for j in sorted(cfg.human_joints)], -1)


def warp_field_inputs(cfg: RenderConfig, encoders, samples: torch.Tensor,
                      pose2: torch.Tensor, R: int, S: int) -> torch.Tensor:
    """[R*S, pos_feat+pose_feat] rows for the warp-field MLP."""
    pose_feat = encoders["human_pose"].encode(pose2) if cfg.human_pose_encoding else pose2
    pose_exp = pose_feat[:, None, :].expand(R, S, pose_feat.shape[-1])
    sample_feat = encoders["position"].encode(samples) if cfg.human_pose_encoding else samples
    return torch.cat([sample_feat.reshape(R * S, -1), pose_exp.reshape(R * S, -1)], -1)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet to smpl_nerf_tpu_torch")


def resolve_fused_mode_auto(spec, pos_enc, dir_enc, device: torch.device) -> int:
    """--use_fused_mlp=-1 (auto), as JAX's resolver picks on its accelerator:
    the fused v2 kernel for the prefix-free nets it takes, else the plain net.
    On the CPU always the plain net."""
    if (device.type == "cuda" and fused_v2.supports(spec, pos_enc, dir_enc)
            and not fused_v2.kernel_supports(spec)):
        return 2
    return 0


def _make_net_runner(cfg: RenderConfig, models, encoders) -> Callable:
    """run(key, samples [R,S,3], dirs_unit [R,S|1,3], prefix [R,P] | None) -> raw [R,S,4].

    Each net's mode is resolved and checked here, on the device its weights
    lie on, so a configuration the kernels cannot take fails when the
    pipeline is built rather than at the first batch."""
    pos_enc = encoders["position"]
    dir_enc = encoders["direction"]
    modes, specs = {}, {}
    for key in ("model_coarse", "model_fine"):
        if key not in models:
            continue
        spec = fused_mod.spec_from_model(models[key])
        device = next(models[key].parameters()).device
        mode = int(cfg.use_fused_mlp)
        if mode < 0:
            mode = resolve_fused_mode_auto(spec, pos_enc, dir_enc, device)
            if mode:
                print(f"use_fused_mlp=auto: fused v{mode} selected for {key} "
                      f"(W={spec.width})")
        if mode >= 2:
            if not fused_v2.supports(spec, pos_enc, dir_enc):
                raise ValueError("--use_fused_mlp=2 needs 3-coord sin/cos encoders without "
                                 "identity blocks (got identity or mismatched dims)")
            reason = fused_v2.kernel_supports(spec) if device.type == "cuda" else ""
            if reason:
                raise ValueError(f"--use_fused_mlp=2 on CUDA: {reason}")
        elif mode == 1:
            reason = fused_mod.kernel_supports(spec) if device.type == "cuda" else ""
            if reason:
                raise ValueError(f"--use_fused_mlp=1 on CUDA: {reason}")
        modes[key], specs[key] = mode, spec

    def _rows(parts, R, S):
        return torch.cat([p.expand(R, S, p.shape[-1]).reshape(R * S, -1) for p in parts], -1)

    def run(key, samples, dirs_unit, prefix=None):
        R, S = samples.shape[:2]
        net = models[key]
        mode = modes[key]
        lead = [] if prefix is None else [prefix[:, None, :]]
        if mode >= 2:
            rows = _rows(lead + [samples, dirs_unit], R, S).contiguous()
            raw = fused_v2.fused_apply_raw(specs[key], net, rows)
            return raw.reshape(R, S, raw.shape[-1])
        inputs = _rows(lead + [pos_enc.encode(samples), dir_enc.encode(dirs_unit)], R, S)
        if mode:
            raw = fused_mod.fused_apply(specs[key], net, inputs.contiguous())
        else:
            raw = net(inputs)
        return raw.reshape(R, S, raw.shape[-1])

    return run


class Pipeline:
    """A built pipeline: call as fn(batch, generator=None, train=False) -> outputs."""

    def __init__(self, fn: Callable, cfg: RenderConfig, models: Dict[str, torch.nn.Module],
                 encoders: Dict[str, PositionalEncoder]):
        self._fn = fn
        self.cfg = cfg
        self.models = models
        self.encoders = encoders

    def __call__(self, batch, generator: Optional[torch.Generator] = None,
                 train: bool = False):
        return self._fn(batch, generator if train else None, train)


def build_pipeline(cfg: RenderConfig, models: Dict[str, torch.nn.Module],
                   encoders: Dict[str, PositionalEncoder]) -> Pipeline:
    """The pipeline function for cfg.model_type (one of PORTED_MODEL_TYPES)."""
    if cfg.model_type not in PORTED_MODEL_TYPES:
        raise _not_ported(f"model_type {cfg.model_type!r}")
    _run = _make_net_runner(cfg, models, encoders)

    def nerf_fn(batch, gen, train):
        samples, z_vals = coarse_sampling(batch["ray_translation"], batch["ray_direction"],
                                          cfg.near, cfg.far, cfg.number_coarse_samples, gen)
        noise = cfg.sigma_noise_std if train else 0.0
        origins = batch["ray_translation"]
        dirs = batch["ray_direction"]
        dirs_exp = dirs[:, None, :].expand(samples.shape)
        # directions are constant per ray: the [R,1,3] unit dir is encoded once
        dirs_unit = _normalize(dirs)[:, None, :]
        raw = _run("model_coarse", samples, dirs_unit)
        out = raw2outputs(raw, z_vals, dirs_exp, noise, cfg.white_background, gen)
        result = {"rgb_coarse": out.rgb, "densities": out.density,
                  "ray_samples": samples, "depth": out.depth}
        if not cfg.run_fine:
            result["rgb_fine"] = out.rgb
            return result
        z_fine, samples_fine = fine_sampling(origins, dirs, z_vals, out.weights,
                                             cfg.number_fine_samples, cfg.use_pallas)
        Sf = samples_fine.shape[1]
        dirs_fine = dirs[:, None, :].expand(dirs.shape[0], Sf, 3)
        raw_f = _run("model_fine", samples_fine, dirs_unit)
        out_f = raw2outputs(raw_f, z_fine, dirs_fine, noise, cfg.white_background, gen)
        result.update(rgb_fine=out_f.rgb, densities=out_f.density,
                      ray_samples=samples_fine, depth=out_f.depth)
        return result

    def _warp(samples, pose2, R, S):
        rows = warp_field_inputs(cfg, encoders, samples, pose2, R, S)
        return models["model_warp_field"](rows).reshape(R, S, 3)

    def smpl_nerf_fn(batch, gen, train):
        samples, z_vals = coarse_sampling(batch["ray_translation"], batch["ray_direction"],
                                          cfg.near, cfg.far, cfg.number_coarse_samples, gen)
        noise = cfg.sigma_noise_std if train else 0.0
        origins = batch["ray_translation"]
        dirs = batch["ray_direction"]
        R, S = samples.shape[:2]
        pose2 = two_joint_pose(cfg, batch)

        warp = _warp(samples, pose2, R, S)
        warped = samples + warp
        samples_dirs = warped - origins[:, None, :]
        raw = _run("model_coarse", warped, _normalize(samples_dirs))
        out = raw2outputs(raw, z_vals, samples_dirs, noise, cfg.white_background, gen)
        result = {"rgb_coarse": out.rgb, "warp": warp, "ray_samples": samples,
                  "warped_samples": warped, "densities": out.density}
        if not cfg.run_fine:
            result["rgb_fine"] = out.rgb
            return result
        z_fine, samples_fine = fine_sampling(origins, dirs, z_vals, out.weights,
                                             cfg.number_fine_samples, cfg.use_pallas)
        Sf = samples_fine.shape[1]
        warp_f = _warp(samples_fine, pose2, R, Sf)
        warped_f = samples_fine + warp_f
        fine_dirs = warped_f - origins[:, None, :]
        # the fine net sees the per-sample unit directions of the WARPED samples
        raw_f = _run("model_fine", warped_f, _normalize(fine_dirs))
        # but the reference integrates the fine pass with the UNwarped per-ray
        # direction (smpl_nerf_pipeline.py:95-98)
        dirs_fine = dirs[:, None, :].expand(R, Sf, 3)
        out_f = raw2outputs(raw_f, z_fine, dirs_fine, noise, cfg.white_background, gen)
        result.update(rgb_fine=out_f.rgb, warp=warp_f, ray_samples=samples_fine,
                      warped_samples=warped_f, densities=out_f.density)
        return result

    def _append_fn(pose_of_batch: Callable):
        def fn(batch, gen, train):
            samples, z_vals = coarse_sampling(batch["ray_translation"], batch["ray_direction"],
                                              cfg.near, cfg.far, cfg.number_coarse_samples, gen)
            noise = cfg.sigma_noise_std if train else 0.0
            origins = batch["ray_translation"]
            dirs = batch["ray_direction"]
            R = samples.shape[0]
            pose = pose_of_batch(batch)
            pose_feat = (encoders["human_pose"].encode(pose) if cfg.human_pose_encoding
                         else pose)
            dirs_exp = dirs[:, None, :].expand(samples.shape)
            dirs_unit = _normalize(dirs)[:, None, :]
            raw = _run("model_coarse", samples, dirs_unit, prefix=pose_feat)
            out = raw2outputs(raw, z_vals, dirs_exp, noise, cfg.white_background, gen)
            result = {"rgb_coarse": out.rgb, "densities": out.density, "ray_samples": samples}
            if not cfg.run_fine:
                result["rgb_fine"] = out.rgb
                return result
            z_fine, samples_fine = fine_sampling(origins, dirs, z_vals, out.weights,
                                                 cfg.number_fine_samples, cfg.use_pallas)
            Sf = samples_fine.shape[1]
            dirs_fine = dirs[:, None, :].expand(R, Sf, 3)
            raw_f = _run("model_fine", samples_fine, dirs_unit, prefix=pose_feat)
            out_f = raw2outputs(raw_f, z_fine, dirs_fine, noise, cfg.white_background, gen)
            result.update(rgb_fine=out_f.rgb, densities=out_f.density,
                          ray_samples=samples_fine)
            return result
        return fn

    if cfg.model_type == "smpl_nerf":
        fn = smpl_nerf_fn
    elif cfg.model_type == "append_to_nerf":
        fn = _append_fn(lambda batch: two_joint_pose(cfg, batch))
    elif cfg.model_type == "append_smpl_params":
        fn = _append_fn(lambda batch: batch["human_pose"])
    else:
        fn = nerf_fn
    return Pipeline(fn, cfg, models, encoders)
