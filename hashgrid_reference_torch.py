"""A plain float32 reference of a smpl_nerf training step on Instant-NGP's
hash-grid field.

    from hashgrid_reference_torch import Config, field, train_steps
    raw = field(params["model_fine"], positions, unit_dirs, cfg)
    run = train_steps(cfg, params, batches, torch.Generator().manual_seed(seed))

Written from the published equations, in plain PyTorch, importing nothing of
the port, of JAX or of the JAX package; TF32 is off and nothing is chunked,
cached or batched. The field is that of Mueller, Evans, Schied and Keller,
"Instant Neural Graphics Primitives with a Multiresolution Hash Encoding"
(SIGGRAPH 2022, arXiv:2201.05989: section 3, Table 1, section 5.4); the rest is
SMPL-NeRF's smpl_nerf pipeline (HannesStark/SMPL-NeRF, configs/arm_angles.txt).
One step of a batch of rays:

1. the pose of two joints, each frequency-encoded, and every coarse sample's
   encoded position feed the warp field Linear -> ReLU -> Linear(3), whose
   offset moves the sample;
2. coarse depths: disparity-linear bins with one uniform jitter a ray;
3. the hash-grid field on the warped samples, mapped from [-bound, bound]^3 to
   [0, 1]^3 as p (0.5 / bound) + 0.5: L levels of resolution N_l = floor(N_min
   b^l), b = exp((ln N_max - ln N_min) / (L - 1)); a point's 8 cell corners
   floor(x N_l) + {0, 1}^3 index a dense level 1:1 (c0 + c1 (N_l + 1) + c2
   (N_l + 1)^2) where (N_l + 1)^3 <= T, else the spatial hash (c0 pi0 xor c1 pi1 xor c2 pi2) mod T; the F features of
   each corner blended by trilinear weights; the L levels concatenated;
4. the density MLP (L F -> width, ReLU, -> 16): sigma = exp(h_0); the colour
   MLP on [SH_4(direction), h] (32 -> width, ReLU, -> width, ReLU, -> 3), the
   direction being the unit vector from the ray origin to the warped sample;
5. alpha compositing with sigma noise, then inverse-CDF fine depths from the
   coarse weights, and the fine pass through a second field of its own;
6. the loss: MSE(coarse) + MSE(fine); gradients by autograd; Adam (betas 0.9 /
   0.999, eps 1e-8).

The jitter and the sigma noise come from the generator handed in, in the
order and shapes the port draws them: a uniform [R, 1], then normal [R, S] for
each pass.

Departures from the paper (as the port makes them, models/grid_nerf.py):
* two fields, coarse and fine, where NGP marches one through an occupancy grid;
* samples outside the box are clamped to its border, and a cell's lower corner
  is capped at N_l - 1 so that the far face blends onto its own vertices;
* no offset of half a cell (tiny-cuda-nn adds one to every level);
* raw2outputs' ReLU and sigma noise act on sigma = exp(h_0), where NGP takes a
  truncated exp and no noise;
* the MLPs have no biases, as tiny-cuda-nn's fully fused MLPs, and compute in
  float32 here (the benchmark's copy, port_bench/reference_hashgrid.py, also
  in bf16 with flax's rounding);
* Adam's beta2 and eps are SMPL-NeRF's solver's, not NGP's 0.99 and 1e-15, and
  the learning rate is constant.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRIMES = (1, 2654435761, 805459861)

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Config:
    near: float = 1.0
    far: float = 4.0
    coarse_samples: int = 64
    fine_samples: int = 128
    frequencies_positional: int = 10
    frequencies_pose: int = 10
    joints: tuple = (41, 38)
    sigma_noise_std: float = 1.0
    white_background: bool = False
    n_levels: int = 16
    features: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048
    bound: float = 1.6
    lr: float = 1e-2


def resolutions(cfg: Config) -> List[int]:
    """N_l of every level, computed in float64."""
    if cfg.n_levels == 1:
        return [cfg.base_resolution]
    b = math.exp((math.log(cfg.max_resolution) - math.log(cfg.base_resolution))
                 / (cfg.n_levels - 1))
    return [int(math.floor(cfg.base_resolution * b ** level)) for level in range(cfg.n_levels)]


def table_entries(cfg: Config) -> int:
    T = 2 ** cfg.log2_hashmap_size
    return sum(min((n + 1) ** 3, T) for n in resolutions(cfg))


def hash_encode(x01: torch.Tensor, table: torch.Tensor, cfg: Config) -> torch.Tensor:
    """[N, 3] points in [0, 1]^3 -> [N, L F]: level by level and corner by corner."""
    T = 2 ** cfg.log2_hashmap_size
    x = x01.clamp(0.0, 1.0)
    levels, offset = [], 0
    for n in resolutions(cfg):
        p = x * n
        lower = torch.minimum(torch.floor(p), torch.tensor(float(n - 1)))
        f = p - lower
        c = lower.long()
        dense = (n + 1) ** 3 <= T
        feat = torch.zeros((x.shape[0], table.shape[1]), dtype=torch.float32, device=x.device)
        for corner in range(8):
            bits = ((corner >> 2) & 1, (corner >> 1) & 1, corner & 1)
            cx, cy, cz = (c[:, d] + bits[d] for d in range(3))
            w = torch.ones_like(f[:, 0])
            for d in range(3):
                w = w * (f[:, d] if bits[d] else 1.0 - f[:, d])
            if dense:
                index = cx + cy * (n + 1) + cz * (n + 1) ** 2
            else:
                index = torch.bitwise_xor(torch.bitwise_xor(cx * PRIMES[0], cy * PRIMES[1]),
                                          cz * PRIMES[2]) % T
            feat = feat + w[:, None] * table[offset + index]
        levels.append(feat)
        offset += min((n + 1) ** 3, T)
    return torch.cat(levels, -1)


def spherical_harmonics(d: torch.Tensor) -> torch.Tensor:
    """[N, 3] unit vectors -> [N, 16] real spherical harmonics of bands 0-3."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * z * z - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * x * x - 0.54627421529603959 * y * y,
        0.59004358992664352 * y * (-3.0 * x * x + y * y),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z * z),
        0.3731763325901154 * z * (5.0 * z * z - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z * z),
        1.4453057213202769 * z * (x * x - y * y),
        0.59004358992664352 * x * (-x * x + 3.0 * y * y)], -1)


def field(net: Dict[str, torch.Tensor], positions: torch.Tensor, unit_dirs: torch.Tensor,
          cfg: Config) -> torch.Tensor:
    """raw [N, 4] (rgb logits, sigma) of one hash-grid field at world positions [N, 3]."""
    feats = hash_encode(positions * (0.5 / cfg.bound) + 0.5, net["hash_table"], cfg)
    h = torch.relu(feats @ net["density_0.weight"].t())
    h = h @ net["density_out.weight"].t()
    sigma = torch.exp(h[:, :1])
    c = torch.cat([spherical_harmonics(unit_dirs), h], -1)
    c = torch.relu(c @ net["color_0.weight"].t())
    c = torch.relu(c @ net["color_1.weight"].t())
    return torch.cat([c @ net["color_out.weight"].t(), sigma], -1)


def encode(x: torch.Tensor, frequencies: int) -> torch.Tensor:
    """[sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], each block over all of x's dims."""
    parts = []
    for k in range(frequencies):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def warp(net: Dict[str, torch.Tensor], samples: torch.Tensor, pose2: torch.Tensor,
         cfg: Config) -> torch.Tensor:
    """The warp field's offsets [R, S, 3] of samples [R, S, 3] under two joints' pose [R, 2]."""
    R, S, _ = samples.shape
    pose = encode(pose2, cfg.frequencies_pose)[:, None, :].expand(R, S, -1)
    rows = torch.cat([encode(samples, cfg.frequencies_positional), pose], -1)
    h = torch.relu(rows @ net["linear1.weight"].t() + net["linear1.bias"])
    return h @ net["linear2.weight"].t() + net["linear2.bias"]


def coarse_depths(cfg: Config, rays: int, generator, device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, cfg.coarse_samples, device=device)
    z = 1.0 / (1.0 / cfg.near * (1.0 - t) + 1.0 / cfg.far * t)
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    jitter = torch.rand((rays, 1), generator=generator, dtype=torch.float32, device=device)
    return lower + (upper - lower) * jitter


def fine_depths(bins: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse-CDF depths [R, n] of bins [R, K] under weights [R, K - 1], at
    u = f * float32(1 / (n - 1))."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, -1)], -1)
    step = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(max(n - 1, 1)),
                                                                 dtype=torch.float32)
    u = (torch.arange(n, dtype=torch.float32, device=bins.device) * step.to(bins.device))
    u = u.expand(cdf.shape[0], n).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    b0 = torch.gather(bins, -1, below.clamp(max=bins.shape[-1] - 1))
    b1 = torch.gather(bins, -1, above.clamp(max=bins.shape[-1] - 1))
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


def composite(raw: torch.Tensor, z: torch.Tensor, dirs: torch.Tensor, cfg: Config, generator):
    """(rgb [R, 3], weights [R, S]); dirs per ray [R, 3] or per sample [R, S, 3]."""
    rgb = torch.sigmoid(raw[..., :3])
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    norm = torch.linalg.norm(dirs, dim=-1)
    dists = dists * (norm[:, None] if dirs.dim() == 2 else norm)
    sigma = raw[..., 3]
    if cfg.sigma_noise_std > 0.0:
        sigma = sigma + cfg.sigma_noise_std * torch.randn(
            sigma.shape, generator=generator, dtype=sigma.dtype, device=sigma.device)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     (1.0 - alpha + 1e-10)[:, :-1]], -1), -1)
    weights = alpha * trans
    out = (weights[..., None] * rgb).sum(-2)
    if cfg.white_background:
        out = out + (1.0 - weights.sum(-1))[:, None]
    return out, weights


def render(params: Params, origins: torch.Tensor, dirs: torch.Tensor, poses: torch.Tensor,
           cfg: Config, generator) -> dict:
    """{'rgb_coarse', 'rgb_fine' [R, 3], 'raw_coarse', 'raw_fine' [R, S, 4]} of a
    training pass over rays [R, 3] at poses [R, 69]."""
    pose2 = torch.stack([poses[:, j] for j in sorted(cfg.joints)], -1)
    out = {}

    def one(name, z, fine):
        R, S = z.shape
        samples = origins[:, None, :] + dirs[:, None, :] * z[..., None]
        warped = samples + warp(params["model_warp_field"], samples, pose2, cfg)
        sdirs = warped - origins[:, None, :]
        unit = sdirs / torch.linalg.norm(sdirs, dim=-1, keepdim=True)
        raw = field(params[name], warped.reshape(-1, 3), unit.reshape(-1, 3), cfg)
        out[name.replace("model", "raw")] = raw.reshape(R, S, 4)
        return composite(raw.reshape(R, S, 4), z, dirs if fine else sdirs, cfg, generator)

    z = coarse_depths(cfg, origins.shape[0], generator, origins.device)
    out["rgb_coarse"], weights = one("model_coarse", z, False)
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    z_f = fine_depths(mids.detach(), weights[:, 1:-1].detach(), cfg.fine_samples).detach()
    z_all, _ = torch.sort(torch.cat([z, z_f], -1), -1)
    out["rgb_fine"], _ = one("model_fine", z_all, True)
    return out


def train_steps(cfg: Config, params: Params, batches: list, generator) -> dict:
    """Steps on `batches` (each {'origins', 'directions', 'poses', 'rgb'}) from
    `params`: {'losses', 'grads' (the first step's, as params), 'params' (after
    the last step), 'raws' (the first step's raw outputs)}."""
    leaves = {m: {k: v.detach().clone().requires_grad_(True) for k, v in net.items()}
              for m, net in params.items()}
    flat = [p for net in leaves.values() for p in net.values()]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in flat]
    losses, grads1, raws = [], None, None
    for t, b in enumerate(batches, start=1):
        out = render(leaves, b["origins"], b["directions"], b["poses"], cfg, generator)
        loss = (((out["rgb_coarse"] - b["rgb"]) ** 2).mean()
                + ((out["rgb_fine"] - b["rgb"]) ** 2).mean())
        grads = torch.autograd.grad(loss, flat)
        if grads1 is None:
            grads1 = [g.detach().clone() for g in grads]
            raws = {k: out[k].detach() for k in ("raw_coarse", "raw_fine")}
        with torch.no_grad():
            c1, c2 = 1.0 - 0.9 ** t, (1.0 - 0.999 ** t) ** 0.5
            for p, g, (m, v) in zip(flat, grads, moments):
                m.mul_(0.9).add_(g, alpha=0.1)
                v.mul_(0.999).addcmul_(g, g, value=0.001)
                p.addcdiv_(m, v.sqrt().div_(c2).add_(1e-8), value=-cfg.lr / c1)
        losses.append(float(loss.detach()))
    it = iter(grads1)
    return {"losses": losses,
            "grads": {m: {k: next(it) for k in net} for m, net in leaves.items()},
            "params": {m: {k: v.detach() for k, v in net.items()} for m, net in leaves.items()},
            "raws": raws}
