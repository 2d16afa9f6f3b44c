"""A plain float32 reference of the dummy_dynamic family's training step.

    from dummy_dynamic_reference_torch import Config, forward
    out = forward(cfg, params, body, betas, pose_table, batch, jitter, noise)
    out["loss"].backward()        # gradients by autograd

Written from the published pipeline (HannesStark/SMPL-NeRF,
models/dynamic_pipeline.py `DynamicPipeline`, with smplx's LBS and the
RenderRayNet of models/render_ray_net.py), in plain PyTorch, importing
nothing of the port, of JAX or of the JAX package. TF32 is off; nothing is
chunked, cached or batched. The forward pass of one batch:

1. each ray's goal pose from the per-image pose table (`pose_table[image]`);
2. SMPL linear blend skinning from the pkl's arrays (`v_template`,
   `shapedirs`, `posedirs`, `J_regressor`, `weights`, `kintree_table`): shape
   blend shapes, the rest joints, Rodrigues, the pose blend shapes on
   (R - I) of joints 1..23, the kinematic chain, skinning;
3. per-vertex warps canonical - goal (the canonical mesh is the zero pose);
4. the vertex attention: att = relu(warp_radius - |x - v|) * temperature,
   the modified softmax (exp(att - M) - exp(-M)) / sum_v exp(att - M) with M
   the GLOBAL max of att over the whole batch, and the warp sum_v w * warp_v;
5. the warped samples and their directions from the ray origin (per sample);
6. the positional and directional encodings ([sin(2^k x), cos(2^k x)] over
   all dims, frequency by frequency);
7. the RenderRayNet forward (a skip concatenation of the encoded positions,
   the sigma head on the additional layer, the directional branch);
8. `raw2outputs` with the injected sigma noise, on the per-sample directions;
9. the loss: MSE(rgb_coarse) + MSE(rgb_fine), the fine rgb being the coarse
   one (the family has no fine pass).

Departures from the published code:
* the jitter of the coarse samples ([R, 1], one per ray) and the sigma noise
  ([R, S]) are inputs, so that a caller can hand the same draws to both sides;
* where every exp(att - M) of a sample underflows, the published
  (0 - 0) / 0 is NaN; here the warp is 0, its limit (the denominator is
  floored at 1e-30);
* Rodrigues at the zero rotation: smplx's form, angle = |aa + 1e-8|;
* no global orientation and no translation (the family passes neither).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Config:
    near: float = 1.0
    far: float = 4.0
    number_coarse_samples: int = 64
    warp_radius: float = 0.01
    warp_temperature: float = 10000.0
    frequencies_positional: int = 10
    frequencies_directional: int = 4
    netdepth: int = 8
    skips: tuple = (4,)
    sigma_noise_std: float = 1.0
    white_background: bool = False


def _f32(x, device) -> torch.Tensor:
    x = x.toarray() if hasattr(x, "toarray") else x
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] (smplx's batch_rodrigues)."""
    angle = torch.linalg.norm(aa + 1e-8, dim=-1, keepdim=True)
    axis = aa / angle
    cos, sin = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1).reshape(aa.shape + (3,))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sin * K + (1.0 - cos) * (K @ K)


def lbs(body: Dict[str, np.ndarray], betas: torch.Tensor, body_pose: torch.Tensor
        ) -> torch.Tensor:
    """SMPL vertices [P, V, 3] of body_pose [P, 69] (joints 1..23), betas [B]."""
    device = body_pose.device
    v_template = _f32(body["v_template"], device)
    shapedirs = _f32(body["shapedirs"], device)
    posedirs = _f32(body["posedirs"], device)
    regressor = _f32(body["J_regressor"], device)
    weights = _f32(body["weights"], device)
    parents = np.asarray(body["kintree_table"], np.int64)[0]
    P = body_pose.shape[0]
    nb = min(betas.shape[0], shapedirs.shape[-1])
    v_shaped = v_template + torch.einsum("vcb,b->vc", shapedirs[..., :nb], betas[:nb])
    joints = regressor @ v_shaped                                        # [24, 3]
    full = torch.cat([torch.zeros((P, 3), device=device), body_pose], -1).reshape(P, 24, 3)
    rots = rodrigues(full)                                               # [P, 24, 3, 3]
    eye = torch.eye(3, device=device)
    pose_feature = (rots[:, 1:] - eye).reshape(P, -1)                   # [P, 207]
    v_posed = v_shaped + torch.einsum("vcp,np->nvc", posedirs, pose_feature)
    rel = joints.clone()
    rel[1:] = joints[1:] - joints[parents[1:]]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(P, 24, 1, 4)
    local = torch.cat([torch.cat([rots, rel.expand(P, 24, 3)[..., None]], -1), bottom], -2)
    chain = [local[:, 0]]
    for j in range(1, 24):
        chain.append(chain[int(parents[j])] @ local[:, j])
    G = torch.stack(chain, 1)                                            # [P, 24, 4, 4]
    rest = torch.einsum("pjrc,jc->pjr", G[..., :3, :3], joints)
    G = torch.cat([G[..., :3, :3], (G[..., :3, 3] - rest)[..., None]], -1)   # [P, 24, 3, 4]
    T = torch.einsum("vj,pjrc->pvrc", weights, G)
    return torch.einsum("pvrc,pvc->pvr", T[..., :3], v_posed) + T[..., 3]


def attention_warp(samples: torch.Tensor, goal: torch.Tensor, warps: torch.Tensor,
                   radius: float, temperature: float) -> torch.Tensor:
    """[R, S, 3] warp of samples [R, S, 3] by attention over goal [R, V, 3]."""
    dist = torch.linalg.norm(samples[:, :, None, :] - goal[:, None, :, :], dim=-1)
    att = torch.relu(radius - dist) * temperature                        # [R, S, V]
    m = att.max()
    e = torch.exp(att - m)
    w = (e - torch.exp(-m)) / torch.clamp(e.sum(-1, keepdim=True), min=1e-30)
    return torch.einsum("rsv,rvc->rsc", w, warps)


def encode(x: torch.Tensor, frequencies: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(frequencies, dtype=torch.float32, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]
    return torch.stack([torch.sin(scaled), torch.cos(scaled)], -2).reshape(*x.shape[:-1], -1)


def render_ray_net(p: Dict[str, torch.Tensor], depth: int, skips, pos: torch.Tensor,
                   dirs: torch.Tensor) -> torch.Tensor:
    """raw [N, 4] (rgb, sigma) of encoded positions [N, P] and directions [N, D]."""
    def lin(name, x):
        return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]

    h = torch.relu(lin("positions_pose_input", pos))
    for i in range(depth - 1):
        if i in skips:
            h = torch.cat([h, pos], -1)
        h = torch.relu(lin(f"positional_net.{i}", h))
    h = lin("additional_linear_layer", h)
    sigma = lin("sigma_out_layer", h)
    h = torch.relu(lin("directional_net.0", lin("directional_input", torch.cat([h, dirs], -1))))
    return torch.cat([lin("rgb_out_layer", h), sigma], -1)


def raw2outputs(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor, noise: torch.Tensor,
                white: bool) -> torch.Tensor:
    """rgb [R, 3] of raw [R, S, 4] at depths z [R, S]; dirs [R, S, 3]."""
    rgb = torch.sigmoid(raw[..., :3])
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    dists = dists * torch.linalg.norm(dirs, dim=-1)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3] + noise) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     (1.0 - alpha + 1e-10)[:, :-1]], -1), -1)
    weights = alpha * trans
    out = (weights[..., None] * rgb).sum(-2)
    return out + (1.0 - weights.sum(-1))[:, None] if white else out


def coarse_z(cfg: Config, jitter: torch.Tensor) -> torch.Tensor:
    """[R, S] disparity-linear depths, one jitter [R, 1] per ray."""
    t = torch.linspace(0.0, 1.0, cfg.number_coarse_samples, device=jitter.device)
    z = 1.0 / (1.0 / cfg.near * (1.0 - t) + 1.0 / cfg.far * t)
    mids = 0.5 * (z[1:] + z[:-1])
    upper, lower = torch.cat([mids, z[-1:]]), torch.cat([z[:1], mids])
    return lower + (upper - lower) * jitter


def forward(cfg: Config, params: Dict[str, torch.Tensor], body: Dict[str, np.ndarray],
            betas: torch.Tensor, pose_table: torch.Tensor, batch: Dict[str, torch.Tensor],
            jitter: torch.Tensor, noise: torch.Tensor) -> Dict[str, torch.Tensor]:
    """{'warp' [R, S, 3], 'rgb' [R, 3], 'loss'} of one batch ('origins',
    'directions', 'image' [R], 'rgb'); params: the coarse RenderRayNet's
    leaves by their state-dict names."""
    o, d = batch["origins"], batch["directions"]
    goal_table = lbs(body, betas, pose_table)                            # [N_img, V, 3]
    canonical = lbs(body, betas, torch.zeros_like(pose_table[:1]))[0]
    image = batch["image"].long()
    goal = goal_table[image]
    warps = canonical[None] - goal
    z = coarse_z(cfg, jitter)
    samples = o[:, None, :] + d[:, None, :] * z[..., None]
    warp = attention_warp(samples, goal, warps, cfg.warp_radius, cfg.warp_temperature)
    warped = samples + warp
    sample_dirs = warped - o[:, None, :]
    unit = sample_dirs / torch.linalg.norm(sample_dirs, dim=-1, keepdim=True)
    R, S = z.shape
    raw = render_ray_net(params, cfg.netdepth, cfg.skips,
                         encode(warped, cfg.frequencies_positional).reshape(R * S, -1),
                         encode(unit, cfg.frequencies_directional).reshape(R * S, -1))
    rgb = raw2outputs(raw.reshape(R, S, 4), z, sample_dirs, cfg.sigma_noise_std * noise,
                      cfg.white_background)
    mse = ((rgb - batch["rgb"]) ** 2).mean()
    return {"warp": warp, "rgb": rgb, "loss": mse + mse}
