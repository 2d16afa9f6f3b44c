"""The plain reference of the dummy_dynamic configuration (frozen yardstick).

The benchmark's own copy of dummy_dynamic_reference_torch.py, importing
nothing of the program: plain PyTorch with TF32 off, written from the
published DynamicPipeline (HannesStark/SMPL-NeRF models/dynamic_pipeline.py).
Per training step of a batch ('origins', 'directions', 'rgb', 'image'):

* SMPL LBS in float32 from the body's arrays (port_bench/body.py): shape
  blend shapes, the regressed rest joints, Rodrigues, the pose blend shapes on
  (R - I) of joints 1..23, the kinematic chain, skinning; of each pose of the
  pose table and of the zero pose (the canonical mesh);
* each ray's goal mesh and per-vertex warps canonical - goal;
* the vertex attention in float32: att = relu(warp_radius - |x - v|) * T, the
  modified softmax (exp(att - M) - exp(-M)) / sum_v exp(att - M) with M the
  GLOBAL max over the whole batch (where every exp underflows, the warp is 0,
  the limit of the published 0 / 0), the warp sum_v w * warp_v. The logits
  are kept whole ([R, S, V], 3.6 GB at the cell's shapes) and computed in
  blocks of rays, which only makes them fit;
* the warped samples, their directions from the origin, the encodings, the
  coarse RenderRayNet in the stated precision (reference.net_forward: flax's
  rounding points in bf16; the float8 control rounds each product's operands
  to e4m3), `raw2outputs` on the per-sample directions (reference.composite);
* the loss MSE(rgb_coarse) + MSE(rgb_fine), the fine rgb being the coarse one
  (the family has no fine pass); its gradient by autograd; Adam.
The jitter and the sigma noise come from a generator seeded as the program
seeds its own, drawn in its order (reference.coarse_z, reference.composite).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench import reference

RAY_BLOCK = 64


def lbs(body: Dict[str, torch.Tensor], betas: torch.Tensor, body_pose: torch.Tensor
        ) -> torch.Tensor:
    """SMPL vertices [P, V, 3] of body_pose [P, 69]; body: port_bench.body.arrays
    as float32 tensors on the device."""
    device = body_pose.device
    parents = body["parents"]
    P = body_pose.shape[0]
    shapedirs = body["shapedirs"]
    nb = min(betas.shape[0], shapedirs.shape[-1])
    v_shaped = body["v_template"] + torch.einsum("vcb,b->vc", shapedirs[..., :nb], betas[:nb])
    joints = body["J_regressor"] @ v_shaped
    aa = torch.cat([torch.zeros((P, 3), device=device), body_pose], -1).reshape(P, 24, 3)
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    x, y, z = (aa / angle).unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(P, 24, 3, 3)
    eye = torch.eye(3, device=device)
    rots = (eye + torch.sin(angle)[..., None] * K
            + (1.0 - torch.cos(angle))[..., None] * (K @ K))
    v_posed = v_shaped + torch.einsum("vcp,np->nvc", body["posedirs"],
                                      (rots[:, 1:] - eye).reshape(P, -1))
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[parents[1:]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(P, 24, 1, 4)
    local = torch.cat([torch.cat([rots, rel.expand(P, 24, 3)[..., None]], -1), bottom], -2)
    chain = [local[:, 0]]
    for j in range(1, 24):
        chain.append(chain[int(parents[j])] @ local[:, j])
    G = torch.stack(chain, 1)
    rest = torch.einsum("pjrc,jc->pjr", G[..., :3, :3], joints)
    G = torch.cat([G[..., :3, :3], (G[..., :3, 3] - rest)[..., None]], -1)
    T = torch.einsum("vj,pjrc->pvrc", body["weights"], G)
    return torch.einsum("pvrc,pvc->pvr", T[..., :3], v_posed) + T[..., 3]


@torch.no_grad()
def attention_warp(samples: torch.Tensor, goal: torch.Tensor, warps: torch.Tensor,
                   radius: float, temperature: float, block: int = RAY_BLOCK) -> torch.Tensor:
    """[R, S, 3] warps of samples [R, S, 3] by the attention over each ray's
    goal mesh goal [R, V, 3] with per-vertex warps [R, V, 3]."""
    R = samples.shape[0]
    blocks = [slice(lo, min(lo + block, R)) for lo in range(0, R, block)]
    att = torch.cat([torch.relu(radius - torch.sqrt(
        ((samples[b][:, :, None, :] - goal[b][:, None, :, :]) ** 2).sum(-1))) * temperature
        for b in blocks])                                                # [R, S, V]
    m = att.max()
    out = []
    for b in blocks:
        e = torch.exp(att[b] - m)
        w = (e - torch.exp(-m)) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
        out.append(torch.einsum("rsv,rvc->rsc", w, warps[b]))
    return torch.cat(out)


def body_tensors(arrays: dict, device) -> dict:
    """port_bench.body.arrays as float32 tensors on `device` (parents stays numpy)."""
    return {k: (v if k == "parents" else torch.as_tensor(np.asarray(v, np.float32),
                                                       device=device))
            for k, v in arrays.items()}


def train_steps(flags: dict, weights: Dict[str, Dict[str, torch.Tensor]], body: dict,
                pose_table: torch.Tensor, batches: List[dict], seed: int,
                precision: str) -> dict:
    """Steps of the training loop on `batches` from `weights` (the coarse
    net's leaves under 'model_coarse'): {'losses', 'grad1', 'params' (of
    model_coarse), 'warp' (the first step's [R, S, 3])}; pose_table [N, 69]."""
    f = flags
    near, far, nc = float(f["near"]), float(f["far"]), int(f["number_coarse_samples"])
    radius, temperature = float(f["warp_radius"]), float(f["warp_temperature"])
    lp, ld = int(f["number_frequencies_postitional"]), int(f["number_frequencies_directional"])
    depth, skips = int(f["netdepth"]), tuple(int(s) for s in f["skips"])
    white, noise = bool(f["white_background"]), float(f["sigma_noise_std"])
    with reference.full_float32():
        device = pose_table.device
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights["model_coarse"].items()}
        flat = list(params.values())
        opt = reference.Adam(flat, float(f["lrate"]))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        betas = torch.zeros(10, device=device)
        goal_table = lbs(body, betas, pose_table)
        canonical = lbs(body, betas, torch.zeros_like(pose_table[:1]))[0]
        losses, grad1, warp1 = [], None, None
        for b in batches:
            o, d = b["origins"], b["directions"]
            goal = goal_table[b["image"].long()]
            R = o.shape[0]
            z = reference.coarse_z(near, far, nc, R, gen, device)
            samples = o[:, None, :] + d[:, None, :] * z[..., None]
            warp = attention_warp(samples, goal, canonical[None] - goal, radius, temperature)
            del goal
            warped = samples + warp
            sample_dirs = warped - o[:, None, :]
            unit = sample_dirs / torch.linalg.norm(sample_dirs, dim=-1, keepdim=True)
            raw = reference.net_forward(params, depth, skips,
                                        reference.encode(warped, lp, False).reshape(R * nc, -1),
                                        reference.encode(unit, ld, False).reshape(R * nc, -1),
                                        precision)
            rgb, _ = reference.composite(raw.reshape(R, nc, 4), z, sample_dirs, noise, white, gen)
            mse = ((rgb - b["rgb"]) ** 2).mean()
            loss = mse + mse
            grads = torch.autograd.grad(loss, flat)
            if grad1 is None:
                grad1, warp1 = [g.detach().clone() for g in grads], warp
            opt.step(grads)
            losses.append(float(loss.detach()))
        return {"losses": losses, "grad1": {"model_coarse": dict(zip(params, grad1))},
                "params": {"model_coarse": {k: v.detach() for k, v in params.items()}},
                "warp": warp1}


def warp_gap(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """|warp - reference warp| over |reference warp| (norms over every sample)."""
    num = float(torch.linalg.norm(ours.float() - ref.float()))
    return num / max(float(torch.linalg.norm(ref.float())), 1e-30)
