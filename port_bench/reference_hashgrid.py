"""The plain reference of the smpl_nerf_hashgrid_ngp configuration (frozen
yardstick): smpl_nerf's pipeline with Instant-NGP's hash-grid field as its
coarse and fine nets.

Plain PyTorch, float32 with TF32 off, importing nothing of the program; the
benchmark's copy of hashgrid_reference_torch.py at the root of the
repository (which the tests hold it to). Everything but the field is
reference.py's, by import: the warp field's rows and its two layers, the
disparity-linear coarse depths with one jitter a ray, `sample_pdf`,
`composite` with the sigma noise, Adam, the draws from a device generator in
the program's order, and the precisions: the MLPs and the warp field in the
configuration's compute dtype with flax's rounding points, or the float8
control. The field (Mueller et al., "Instant Neural Graphics Primitives with a
Multiresolution Hash Encoding", 2022, sections 3 and 5.4):

* the warped sample mapped from [-grid_bound, grid_bound]^3 to [0, 1]^3 as
  p (0.5 / grid_bound) + 0.5 and clamped there; L levels of N_l = floor(N_min b^l), b = exp((ln N_max - ln
  N_min) / (L - 1)); at each level the cell's lower corner floor(x N_l), capped
  at N_l - 1, and its 8 corners, each indexing a dense level 1:1 where
  (N_l + 1)^3 <= T, else (c0 pi0 xor c1 pi1 xor c2 pi2) mod T; the F features of
  a corner weighted by its trilinear weight, added corner by corner in
  float32 (an explicit loop over levels and corners);
* the density MLP (L F -> width, ReLU, -> 16), sigma = exp(h_0) in float32;
  the colour MLP on [SH_4(unit direction), h] (32 -> width, ReLU, -> width,
  ReLU, -> 3); bias-free layers through reference.dense with a zero bias, so
  that their products round where the program's do.

The encoding's sizes are the configuration's `hash_grid` group (L
`n_levels`, T = 2^`log2_hashmap_size`, N_min `base_resolution`, N_max
`max_resolution`), which the traffic hands over as `flags["hash_grid"]`; F
and the width are the flags `grid_features` and `grid_width`.

`encode_gap` holds what the program's encoding returned for step 1's coarse
rows against this encoding of this reference's own points of those rows
(`train_steps`' `points1`: its warp of its own samples), from the same table,
in blocks of rows only so that it fits. The coarse rows, as their depths come
from the same draws on both sides; a fine row's depth follows the coarse
net's bf16 rounding into the inverse CDF and moves by up to ~1e-4, a tenth of
a cell at N = 2048. Its control (`control_encoding`) is the encoding one
precision below the stated float32: points and table rounded to bfloat16.
`table_grad_gap` holds step 1's gradient into each level of one table, as the
norm of the difference over the reference's norm.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from port_bench import reference, scene
from port_bench.reference import compute_type, dense, encode, full_float32

PRIMES = (1, 2654435761, 805459861)
GEOMETRY = 16
TABLE_STREAM = 13


def resolutions(flags: dict) -> List[int]:
    sizes = flags["hash_grid"]
    L = int(sizes["n_levels"])
    lo, hi = int(sizes["base_resolution"]), int(sizes["max_resolution"])
    b = math.exp((math.log(hi) - math.log(lo)) / (L - 1)) if L > 1 else 1.0
    return [int(math.floor(lo * b ** level)) for level in range(L)]


def level_sizes(flags: dict) -> List[int]:
    T = 2 ** int(flags["hash_grid"]["log2_hashmap_size"])
    return [min((n + 1) ** 3, T) for n in resolutions(flags)]


def shapes(flags: dict) -> Dict[str, Dict[str, tuple]]:
    """{model: {leaf: shape}} of the layers (the tables are apart: `make_weights`)."""
    W = int(flags["grid_width"])
    enc = int(flags["hash_grid"]["n_levels"]) * int(flags["grid_features"])
    net = {"density_0.weight": (W, enc), "density_out.weight": (GEOMETRY, W),
           "color_0.weight": (W, 16 + GEOMETRY), "color_1.weight": (W, W),
           "color_out.weight": (3, W)}
    warp = reference.Widths(flags).shapes()["model_warp_field"]
    return {"model_coarse": dict(net), "model_fine": dict(net), "model_warp_field": warp}


def make_weights(flags: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights both sides start from: the layers as scene.lecun_weights
    draws them, and each net's table [entries, F] uniform in +-1e-4 from a
    stream of its own."""
    weights = scene.lecun_weights(shapes(flags), seed, device)
    g = torch.Generator(device=device).manual_seed(scene.stream_seed(seed, TABLE_STREAM))
    for name in ("model_coarse", "model_fine"):
        table = torch.empty((sum(level_sizes(flags)), int(flags["grid_features"])),
                            dtype=torch.float32, device=device)
        weights[name] = {"hash_table": table.uniform_(-1e-4, 1e-4, generator=g),
                         **weights[name]}
    return weights


def hash_encode(x01: torch.Tensor, table: torch.Tensor, flags: dict) -> torch.Tensor:
    """[N, 3] points in [0, 1]^3 (clamped) -> [N, L F] float32, level by level
    and corner by corner."""
    T = 2 ** int(flags["hash_grid"]["log2_hashmap_size"])
    x = x01.float().clamp(0.0, 1.0)
    levels, offset = [], 0
    for n, size in zip(resolutions(flags), level_sizes(flags)):
        p = x * n
        lower = torch.minimum(torch.floor(p), torch.tensor(float(n - 1), device=x.device))
        f = p - lower
        c = lower.long()
        feat = torch.zeros((x.shape[0], table.shape[1]), dtype=torch.float32, device=x.device)
        for corner in range(8):
            bits = ((corner >> 2) & 1, (corner >> 1) & 1, corner & 1)
            cx, cy, cz = (c[:, d] + bits[d] for d in range(3))
            w = torch.ones_like(f[:, 0])
            for d in range(3):
                w = w * (f[:, d] if bits[d] else 1.0 - f[:, d])
            if (n + 1) ** 3 <= size:
                index = cx + cy * (n + 1) + cz * (n + 1) ** 2
            else:
                index = torch.bitwise_xor(torch.bitwise_xor(cx * PRIMES[0], cy * PRIMES[1]),
                                          cz * PRIMES[2]) % T
            feat = feat + w[:, None] * table[offset + index]
        levels.append(feat)
        offset += size
    return torch.cat(levels, -1)


def spherical_harmonics(d: torch.Tensor) -> torch.Tensor:
    """[N, 3] unit vectors -> [N, 16]: real spherical harmonics of bands 0-3."""
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


def field_forward(w: Dict[str, torch.Tensor], flags: dict, positions: torch.Tensor,
                  unit_dirs: torch.Tensor, precision: str) -> torch.Tensor:
    """raw [N, 4] (rgb logits, sigma), float32, of one field at world positions [N, 3]."""
    cdt = compute_type(precision)
    bound = float(flags["grid_bound"])
    feats = hash_encode(positions * (0.5 / bound) + 0.5, w["hash_table"], flags)

    def lin(name, x):
        weight = w[f"{name}.weight"]
        return dense(x, weight, torch.zeros_like(weight[:, 0]), precision)

    h = torch.relu(lin("density_0", feats.to(cdt)))
    h = lin("density_out", h)
    sigma = torch.exp(h[:, :1].float())
    c = torch.cat([spherical_harmonics(unit_dirs.float()).to(cdt), h], -1)
    c = torch.relu(lin("color_0", c))
    c = torch.relu(lin("color_1", c))
    return torch.cat([lin("color_out", c).float(), sigma], -1)


class HashField(reference.Field):
    """reference.Field's two-pass render with the hash-grid fields; keeps the
    points in [0, 1]^3 (before the clamp) of its first coarse pass."""
    points1 = None

    def _raw(self, name, origins, dirs, pose, z, fine):
        wd, f = self.wd, self.flags
        R, S = z.shape
        samples = origins[:, None, :] + dirs[:, None, :] * z[..., None]
        pose2 = torch.stack([pose[:, j] for j in wd.joints], -1)
        pose_feat = encode(pose2, wd.lpose, wd.id_pose) if wd.pose_encoding else pose2
        sample_feat = encode(samples, wd.lp, wd.id_pos) if wd.pose_encoding else samples
        rows = torch.cat([sample_feat.reshape(R * S, -1),
                          pose_feat[:, None, :].expand(R, S, -1).reshape(R * S, -1)], -1)
        w = self.params["model_warp_field"]
        rows = rows.to(compute_type(self.precision))
        h = torch.relu(dense(rows, w["linear1.weight"], w["linear1.bias"], self.precision))
        warp = dense(h, w["linear2.weight"], w["linear2.bias"], self.precision).float()
        warped = samples + warp.reshape(R, S, 3)
        sdirs = warped - origins[:, None, :]
        unit = sdirs / torch.linalg.norm(sdirs, dim=-1, keepdim=True)
        positions = warped.reshape(R * S, 3)
        if name == "model_coarse" and self.points1 is None:
            self.points1 = (positions * (0.5 / float(f["grid_bound"])) + 0.5).detach().clone()
        raw = field_forward(self.params[name], f, positions, unit.reshape(R * S, 3),
                            self.precision)
        return raw.reshape(R, S, 4), dirs if fine else sdirs


def train_steps(flags: dict, weights: Dict[str, Dict[str, torch.Tensor]], batches: list,
                seed: int, precision: str) -> dict:
    """reference.train_steps with the hash-grid fields: {'losses', 'grad1',
    'params'} of the steps on `batches` from `weights`, and 'points1', the
    points of step 1's coarse pass in [0, 1]^3."""
    with full_float32():
        params = {m: {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
                  for m, leaves in weights.items()}
        flat = [p for leaves in params.values() for p in leaves.values()]
        opt = reference.Adam(flat, float(flags["lrate"]))
        field = HashField(flags, params, precision)
        gen = torch.Generator(device=flat[0].device).manual_seed(int(seed))
        losses, grad1 = [], None
        for b in batches:
            rgb_c, rgb_f = field.render(b["origins"], b["directions"], b["poses"], gen)
            loss = ((rgb_c - b["rgb"]) ** 2).mean() + ((rgb_f - b["rgb"]) ** 2).mean()
            grads = torch.autograd.grad(loss, flat)
            if grad1 is None:
                grad1 = [g.detach().clone() for g in grads]
            opt.step(grads)
            losses.append(float(loss.detach()))
        it = iter(grad1)
        return {"losses": losses, "points1": field.points1,
                "grad1": {m: {k: next(it) for k in leaves} for m, leaves in params.items()},
                "params": {m: {k: v.detach() for k, v in leaves.items()}
                           for m, leaves in params.items()}}


@torch.no_grad()
def encode_gap(x: torch.Tensor, ours: torch.Tensor, table: torch.Tensor, flags: dict,
               block: int = 65536) -> float:
    """|ours - ref| / |ref| (norms over every row and feature) of the program's
    encoding `ours` [N, L F] against `hash_encode` of the points x [N, 3] from
    the same table."""
    if x.shape[0] != ours.shape[0]:
        raise ValueError(f"{ours.shape[0]} encoded rows against {x.shape[0]} points")
    num = den = 0.0
    for lo in range(0, x.shape[0], block):
        want = hash_encode(x[lo:lo + block], table, flags)
        num += float(((ours[lo:lo + block].float() - want) ** 2).sum())
        den += float((want ** 2).sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


@torch.no_grad()
def control_encoding(x: torch.Tensor, table: torch.Tensor, flags: dict,
                     block: int = 65536) -> torch.Tensor:
    """`hash_encode` of the points and the table rounded to bfloat16."""
    t = table.to(torch.bfloat16).float()
    return torch.cat([hash_encode(x[lo:lo + block].to(torch.bfloat16).float(), t, flags)
                      for lo in range(0, x.shape[0], block)])


@torch.no_grad()
def table_grad_gap(ours: dict, ref: dict, flags: dict, name: str) -> float:
    """The largest, over the levels of `name`'s table, of |g_ours - g_ref| /
    |g_ref| of the first gradients ({model: {leaf: tensor}}) into its entries."""
    a, b = ours[name]["hash_table"].float(), ref[name]["hash_table"].float()
    worst, lo = 0.0, 0
    for size in level_sizes(flags):
        num = float(torch.linalg.norm(a[lo:lo + size] - b[lo:lo + size]))
        worst = max(worst, num / max(float(torch.linalg.norm(b[lo:lo + size])), 1e-30))
        lo += size
    return worst
