"""Image-wise dynamic training: pose optimisation through a NeRF (counterpart
of smpl_nerf_tpu/training/image_wise.py).

Two trainable arm angles of a `DummyImageWiseEstimator` are optimised by
gradient through LBS -> vertex-attention warp -> the coarse NeRF -> MSE
against each image. Per image, in a seeded order:
  1. z-vals for the image's rays: disparity-linear bins with one shared
     jitter (`_z_vals_simple`), or, with --coarse_samples_from_intersect (or
     one sample per ray), placed around each ray's hit on the mesh at the
     currently estimated pose (`ops/raymesh.intersect_rays`, no gradient),
  2. ray mini-batches: canonical and goal LBS give the per-vertex warp
     (differentiable in the pose), the normalised-ReLU vertex attention
     (`relu_attention_warp`, not the modified softmax) warps the samples,
     the coarse net renders them, and one Adam step follows.
Three optimiser groups, as the JAX trainer's: `pose` (the estimator, at
--lrate_pose, decayed by --lrate_pose_decay), `net` (the coarse net at
--lrate) and `frozen` (the coarse net, when --load_coarse_model loads a
trained one). The net runs as a plain module here, as the JAX trainer applies
it; on the card the attention's forward and backward take kernel H
(`ops/vertex_attention.relu_attention_cuda`).

Spans (`tracing`, off by default), with the names `Solver.train` gives its
own: `solver.epoch` around an epoch; `solver.step` around a step, holding
`solver.forward` (the pose loss: `pass.lbs` for the canonical and goal LBS
and the warps, `pass.warp` for the attention, `pass.net` for the encodings
and the net, `pass.integrate` for `raw2outputs` and the MSE),
`solver.backward` and `solver.optimizer`; then `solver.loss_read`, the
step's one host read of the loss.

Seams: `train_image_wise` builds its loss through the module global
`make_pose_loss`, which calls the module global `relu_attention_warp`, both
looked up by name at each call; `step_callback(step, loss, models)`, when
given, runs after each step's loss read (step counts from 1; `models` holds
the estimator, whose `.grad`s are the step's until the next step starts),
and a true return ends training there.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from smpl_nerf_tpu_torch import tracing
from smpl_nerf_tpu_torch.core.integrate import raw2outputs
from smpl_nerf_tpu_torch.core.sampling import coarse_bins
from smpl_nerf_tpu_torch.models import smpl as smpl_mod
from smpl_nerf_tpu_torch.models.dummy_estimators import LEFT_ARM_JOINT, RIGHT_ARM_JOINT
from smpl_nerf_tpu_torch.ops import raymesh
from smpl_nerf_tpu_torch.ops.vertex_attention import relu_attention_warp
from smpl_nerf_tpu_torch.pipelines import RenderConfig
from smpl_nerf_tpu_torch.training import checkpoints
from smpl_nerf_tpu_torch.training.factory import build_models_and_params


def _z_vals_simple(args) -> np.ndarray:
    """[S] disparity-linear bins with one jitter drawn from numpy's global RNG."""
    S = int(args.number_coarse_samples)
    base = coarse_bins(float(args.near), float(args.far), S).numpy()
    mids = 0.5 * (base[1:] + base[:-1])
    upper = np.concatenate([mids, base[-1:]])
    lower = np.concatenate([base[:1], mids])
    return (lower + (upper - lower) * np.random.rand()).astype(np.float32)


def make_pose_loss(smpl_model, betas, cfg: RenderConfig, model_coarse, pos_enc, dir_enc):
    """pose_loss(pose [69], origins, dirs, z_vals [R, S], rgb_truth) -> the
    photometric MSE through LBS -> vertex-attention warp -> the coarse net."""
    def pose_loss(pose, origins, dirs, z_vals, rgb_truth):
        device = origins.device
        with tracing.span("pass.lbs"):
            canonical = smpl_mod.smpl_forward(smpl_model, betas, torch.zeros(69, device=device))
            goal = smpl_mod.smpl_forward(smpl_model, betas, pose)
            warps = canonical - goal
        samples = origins[:, None, :] + dirs[:, None, :] * z_vals[..., None]
        with tracing.span("pass.warp"):
            warped = samples + relu_attention_warp(samples, goal, warps, cfg.warp_radius)
            sample_dirs = warped - origins[:, None, :]
        with tracing.span("pass.net"):
            dirs_norm = sample_dirs / torch.linalg.norm(sample_dirs, dim=-1, keepdim=True)
            R, S = samples.shape[:2]
            inputs = torch.cat([pos_enc.encode(warped).reshape(R * S, -1),
                                dir_enc.encode(dirs_norm).reshape(R * S, -1)], -1)
            raw = model_coarse(inputs).reshape(R, S, 4)
        with tracing.span("pass.integrate"):
            out = raw2outputs(raw, z_vals, sample_dirs, 0.0, cfg.white_background)
            return torch.mean((out.rgb - rgb_truth) ** 2)

    return pose_loss


def _load_coarse(path: str) -> dict:
    """model_coarse's state dict from a run directory or a .pt file."""
    if os.path.isdir(path):
        return checkpoints.load_run(path)["model_coarse"]
    return torch.load(path, map_location="cpu", weights_only=True)


def train_image_wise(args, parser, train_data, val_data, extras: dict,
                     log_dir: Optional[str] = None, device="cuda", writer=None,
                     step_callback: Optional[Callable[[int, float, dict], bool]] = None):
    """Returns ({model name: state dict}, per-epoch pose errors); saves the run
    (model_coarse.pt, model_fine.pt, model_smpl_estimator.pt, config.txt) and
    pose_errors.json under log_dir. Each epoch's loss and pose error also go
    to `writer`, when given, as loss/train and pose/error. `step_callback`:
    the module docstring's seam; an epoch it ends early reports the pose
    error of its steps so far."""
    device = torch.device(device)
    smpl_model = extras["smpl_model"]
    betas = torch.as_tensor(extras["betas"], dtype=torch.float32, device=device).reshape(-1)
    cfg = RenderConfig.from_args(args)
    seed = int(getattr(args, "seed", 0))

    # the pose error is reported against the first image's pose
    gt_pose = (train_data.human_poses[0] if train_data.human_poses is not None
               else np.zeros(69, np.float32))
    models, encoders = build_models_and_params(args, seed=seed, device=device, extras=extras)
    estimator, model_coarse = models["smpl_estimator"], models["model_coarse"]

    frozen = bool(args.load_coarse_model)
    if frozen:
        model_coarse.load_state_dict(_load_coarse(args.load_coarse_model))
        print("Loaded frozen coarse model from", args.load_coarse_model)
    # the reference freezes the net only when a trained one is loaded; else
    # it trains beside the pose
    model_coarse.requires_grad_(not frozen)
    estimator.requires_grad_(True)
    groups = [{"params": list(estimator.parameters()), "lr": float(args.lrate_pose)}]
    decays = [int(getattr(args, "lrate_pose_decay", 0) or 0)]
    if not frozen:
        groups.append({"params": list(model_coarse.parameters()), "lr": float(args.lrate)})
        decays.append(0)
    optimizer = torch.optim.Adam(groups)
    # lr * 0.1^(step / (k * 1000)) on the pose group, as solver.make_optimizer
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, [
        (lambda step, k=k: 0.1 ** (step / (k * 1000.0))) if k > 0 else (lambda step: 1.0)
        for k in decays])

    pose_loss = make_pose_loss(smpl_model, betas, cfg, model_coarse, encoders["position"],
                               encoders["direction"])
    faces = torch.as_tensor(smpl_model.faces, dtype=torch.long, device=device)
    S = int(args.number_coarse_samples)

    @torch.no_grad()
    def z_vals_for_image(origins, dirs, z_simple):
        """[hw, S] z-vals of one image's rays at the current pose estimate."""
        if S != 1 and not int(args.coarse_samples_from_intersect):
            return z_simple[None, :].expand(origins.shape[0], S)
        goal = smpl_mod.smpl_forward(smpl_model, betas, estimator()[0])
        dirs_unit = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        hits = raymesh.intersect_rays(origins, dirs_unit, goal, faces,
                                      chunk_size=min(1024, origins.shape[0]))
        if S == 1:
            return torch.where(hits.hit, hits.t, torch.full_like(hits.t, float(args.far)))[:, None]
        std = float(args.std_dev_coarse_sample_prior)
        offs = torch.linspace(-2.0 * std, 2.0 * std, S, device=device)
        return torch.where(hits.hit[:, None], hits.t[:, None] + offs[None, :],
                           z_simple[None, :])

    hw = train_data.h * train_data.w
    bs = min(int(args.batchsize), hw)
    np_rng = np.random.RandomState(seed)
    pose_errors = []
    step, stop = 0, False
    for epoch in range(int(args.num_epochs)):
        losses = []
        with tracing.span("solver.epoch", request=epoch):
            for i in np_rng.permutation(train_data.num_images):
                sl = slice(i * hw, (i + 1) * hw)
                origins = torch.as_tensor(train_data.origins[sl], device=device)
                dirs = torch.as_tensor(train_data.directions[sl], device=device)
                rgb = torch.as_tensor(train_data.rgb[sl], device=device)
                z_simple = torch.as_tensor(_z_vals_simple(args), device=device)
                z_vals = z_vals_for_image(origins, dirs, z_simple)
                perm = np_rng.permutation(hw)
                for lo in range(0, hw - bs + 1, bs):
                    idx = torch.as_tensor(perm[lo:lo + bs], device=device)
                    step += 1
                    with tracing.span("solver.step", request=step):
                        optimizer.zero_grad(set_to_none=True)
                        with tracing.span("solver.forward"):
                            loss = pose_loss(estimator()[0], origins[idx], dirs[idx],
                                             z_vals[idx], rgb[idx])
                        with tracing.span("solver.backward"):
                            loss.backward()
                        with tracing.span("solver.optimizer"):
                            optimizer.step()
                            scheduler.step()
                    with tracing.span("solver.loss_read", request=step):
                        losses.append(float(loss.detach()))      # synchronises the device
                    if step_callback is not None and step_callback(step, losses[-1], models):
                        stop = True
                        break
                if stop:
                    break
        arm_l, arm_r = float(estimator.arm_angle_l.detach()), float(estimator.arm_angle_r.detach())
        pose_err = (arm_l - gt_pose[LEFT_ARM_JOINT]) ** 2 + (arm_r - gt_pose[RIGHT_ARM_JOINT]) ** 2
        pose_errors.append(float(pose_err))
        print(f"[image_wise epoch {epoch}] loss {np.mean(losses):.6f} pose_err {pose_err:.6f} "
              f"(arm angles {arm_l:.5f}, {arm_r:.5f})")
        if writer is not None:
            writer.add_scalar("loss/train", float(np.mean(losses)), epoch)
            writer.add_scalar("pose/error", float(pose_err), epoch)
        if stop:
            break

    final = {name: models[name].state_dict()
             for name in ("model_coarse", "model_fine", "smpl_estimator")}
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        checkpoints.save_run(log_dir, final, args, parser, args.dataset_dir)
        with open(os.path.join(log_dir, "pose_errors.json"), "w") as fh:
            json.dump({"pose_errors": pose_errors,
                       "best": min(pose_errors) if pose_errors else None,
                       "final": pose_errors[-1] if pose_errors else None}, fh)
    return final, pose_errors
