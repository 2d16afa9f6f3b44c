"""A plain float32 reference of the image_wise_dynamic family's training step.

    from image_wise_reference_torch import Config, forward, train_steps
    out = forward(cfg, params, body, betas, angles, batch)
    out["loss"].backward()        # the arm angles' gradient by autograd
    run = train_steps(cfg, params, body, betas, angles, batches, lr)

Written from the published pose optimisation through a frozen NeRF
(HannesStark/SMPL-NeRF, solver/image_wise_solver.py `ImageWiseSolver`,
models/dummy_image_wise_estimator.py and train.py's image_wise_dynamic
branch, with smplx's LBS and the RenderRayNet of models/render_ray_net.py),
in plain PyTorch, importing nothing of the port, of JAX or of the JAX
package; the LBS, the encodings, the net and `raw2outputs` are those of
dummy_dynamic_reference_torch.py, the published pieces both families share.
TF32 is off; nothing is chunked, cached or batched. One step of a batch:

1. the body pose: the two trainable arm angles written into dims 38 and 41
   (the z-rotations of the collar joints 13 and 14) of a frozen 69-dim pose;
2. SMPL linear blend skinning of the zero pose (the canonical mesh) and of
   that pose (the goal mesh) from the pkl's arrays;
3. the per-vertex warps canonical - goal;
4. the normalised-ReLU vertex attention of every sample over all goal
   vertices: att = relu(warp_radius - |x - v|), w = att / (sum_v att + 1e-5),
   warp = sum_v w * warp_v;
5. the warped samples and their directions from the ray origin;
6. the positional and directional encodings;
7. the frozen coarse RenderRayNet forward;
8. `raw2outputs` on the per-sample directions, with no sigma noise;
9. the loss: MSE(rgb, target); its gradient in the two angles by autograd;
   Adam (betas 0.9 / 0.999, eps 1e-8) steps the angles, nothing else.

Departures from the published code:
* the depths of the coarse samples ([R, S]) are an input: the program draws
  one jitter an image from numpy's global generator, and a caller hands the
  same depths to both sides;
* Rodrigues at the zero rotation: smplx's form, angle = |aa + 1e-8|;
* no global orientation and no translation (the family passes neither);
* a constant learning rate (the recipe's: --lrate_pose_decay 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from dummy_dynamic_reference_torch import encode, lbs, raw2outputs, render_ray_net

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LEFT_ARM, RIGHT_ARM = 38, 41


@dataclasses.dataclass(frozen=True)
class Config:
    warp_radius: float = 0.15
    frequencies_positional: int = 10
    frequencies_directional: int = 4
    netdepth: int = 8
    skips: tuple = (4,)
    white_background: bool = True


def body_pose(angles: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """[69]: base with angles [2] (left, right) in dims 38 and 41."""
    return torch.cat([base[:LEFT_ARM], angles[:1], base[LEFT_ARM + 1:RIGHT_ARM], angles[1:],
                      base[RIGHT_ARM + 1:]])


def relu_attention_warp(samples: torch.Tensor, goal: torch.Tensor, warps: torch.Tensor,
                        radius: float) -> torch.Tensor:
    """[R, S, 3] warp of samples [R, S, 3] by attention over goal [V, 3]."""
    att = torch.relu(radius - torch.linalg.norm(samples[:, :, None, :] - goal, dim=-1))
    w = att / (att.sum(-1, keepdim=True) + 1e-5)                         # [R, S, V]
    return torch.einsum("rsv,vc->rsc", w, warps)


def forward(cfg: Config, params: Dict[str, torch.Tensor], body: Dict[str, np.ndarray],
            betas: torch.Tensor, angles: torch.Tensor, batch: Dict[str, torch.Tensor],
            base_pose: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """{'warp' [R, S, 3], 'rgb' [R, 3], 'loss'} of one batch ('origins',
    'directions' [R, 3], 'z_vals' [R, S], 'rgb' [R, 3]) at the arm angles
    [2]; params: the coarse RenderRayNet's leaves by their state-dict names;
    base_pose [69] defaults to the zero pose."""
    o, d, z = batch["origins"], batch["directions"], batch["z_vals"]
    base = torch.zeros(69, device=o.device) if base_pose is None else base_pose
    canonical = lbs(body, betas, torch.zeros((1, 69), device=o.device))[0]
    goal = lbs(body, betas, body_pose(angles, base)[None])[0]
    samples = o[:, None, :] + d[:, None, :] * z[..., None]
    warp = relu_attention_warp(samples, goal, canonical - goal, cfg.warp_radius)
    warped = samples + warp
    sample_dirs = warped - o[:, None, :]
    unit = sample_dirs / torch.linalg.norm(sample_dirs, dim=-1, keepdim=True)
    R, S = z.shape
    raw = render_ray_net(params, cfg.netdepth, cfg.skips,
                         encode(warped, cfg.frequencies_positional).reshape(R * S, -1),
                         encode(unit, cfg.frequencies_directional).reshape(R * S, -1))
    rgb = raw2outputs(raw.reshape(R, S, 4), z, sample_dirs, torch.zeros_like(z),
                      cfg.white_background)
    return {"warp": warp, "rgb": rgb, "loss": ((rgb - batch["rgb"]) ** 2).mean()}


def train_steps(cfg: Config, params: Dict[str, torch.Tensor], body: Dict[str, np.ndarray],
                betas: torch.Tensor, angles: torch.Tensor, batches: List[dict], lr: float,
                base_pose: torch.Tensor = None) -> dict:
    """One Adam step on the angles per batch, from angles [2]: {'losses',
    'grads' [n, 2], 'angles' [n, 2] (after each step), 'warps' (each step's)}."""
    a = angles.detach().clone()
    m, v = torch.zeros_like(a), torch.zeros_like(a)
    out = {"losses": [], "grads": [], "angles": [], "warps": []}
    for t, batch in enumerate(batches, 1):
        leaf = a.clone().requires_grad_(True)
        step = forward(cfg, params, body, betas, leaf, batch, base_pose)
        g, = torch.autograd.grad(step["loss"], leaf)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        denom = (v.sqrt() / (1.0 - 0.999 ** t) ** 0.5) + 1e-8
        a = a - (lr / (1.0 - 0.9 ** t)) * m / denom
        out["losses"].append(float(step["loss"].detach()))
        out["grads"].append(g.detach())
        out["angles"].append(a.clone())
        out["warps"].append(step["warp"].detach())
    return {k: (torch.stack(x) if k in ("grads", "angles") else x) for k, x in out.items()}
