"""Inputs of a run, made from its seed on the run's device (frozen yardstick).

Nothing here imports the port. A later change to the program cannot move
these inputs: cameras, rays, the analytic scene the targets are ray-traced
from, the arm angles, and the weights both sides start from.

* Cameras lie on the xz-circle of radius `radius` around the y axis and look
  at the origin (the convention of the reference's `camera.py`: position
  (r sin t, 0, r cos t), rotation Ry(t)); pixels are pinhole rays in 'xy'
  indexing, looking down -z, with the focal of a `fov_deg` field of view.
* The scene is a body-like union of ellipsoids (torso, head, legs, and two
  arms that swing out from the shoulders by the view's arm angle), shaded by
  a headlight, on the configuration's background colour (black, or white
  with --white_background 1). Part colours come from the seed.
* The pose of a view is the 69-vector with the arm angle, in radians, in
  each of the configuration's `human_joints`.
* Weights: flax's Dense init (lecun-normal kernels truncated at 2 std, zero
  biases), drawn on the device by one generator in one call for all leaves,
  as the program's own init draws them. Where a cell asks for it
  (`centre_density` in its file), each net's sigma-head bias is then set so
  that the median density over a probe of the first view's coarse samples is
  0 (`make_weights`): without it the append family's constant pose prefix
  leaves random nets empty or solid on every ray of a view, and a render
  would check nothing. Training cells start from the init as it is drawn.

Every seed gives the same sizes: the seed moves the colours, the camera
azimuths and the arm angles, never how much work there is.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

MASK64 = (1 << 63) - 1


def stream_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for sub-stream `stream` of a run seed."""
    return (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + 1) & MASK64


def program_seed(seed: int) -> int:
    """The --seed handed to the program (its numpy streams take 32 bits)."""
    return int(seed) % (2 ** 31)


def circle_cameras(azimuths_deg: torch.Tensor, radius: float) -> torch.Tensor:
    """[N, 4, 4] camera-to-world poses on the circle, facing the origin."""
    t = torch.deg2rad(azimuths_deg.double())
    c, s = torch.cos(t), torch.sin(t)
    cams = torch.zeros((t.shape[0], 4, 4), dtype=torch.float64, device=t.device)
    cams[:, 0, 0], cams[:, 0, 2] = c, s
    cams[:, 1, 1] = 1.0
    cams[:, 2, 0], cams[:, 2, 2] = -s, c
    cams[:, 0, 3], cams[:, 2, 3] = radius * s, radius * c
    cams[:, 3, 3] = 1.0
    return cams.float()


def focal(w: int, fov_deg: float) -> float:
    return 0.5 * w / math.tan(0.5 * math.radians(fov_deg))


def camera_rays(cams: torch.Tensor, h: int, w: int, fov_deg: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins, directions) [N, h*w, 3] of the pinhole cameras (directions
    not normalised: their z component in the camera frame is -1)."""
    f = focal(w, fov_deg)
    i, j = torch.meshgrid(torch.arange(w, dtype=torch.float32, device=cams.device),
                          torch.arange(h, dtype=torch.float32, device=cams.device),
                          indexing="xy")
    d = torch.stack([(i - w * 0.5) / f, -(j - h * 0.5) / f, -torch.ones_like(i)], -1)
    dirs = torch.einsum("hwc,nrc->nhwr", d, cams[:, :3, :3]).reshape(cams.shape[0], -1, 3)
    origins = cams[:, None, :3, 3].expand(dirs.shape).contiguous()
    return origins, dirs.contiguous()


# (centre, radii) of the fixed parts; the arms are placed per view
_PARTS = (((0.0, 0.10, 0.0), (0.22, 0.38, 0.13)),     # torso
          ((0.0, 0.68, 0.0), (0.13, 0.15, 0.13)),     # head
          ((0.10, -0.65, 0.0), (0.08, 0.40, 0.08)),   # legs
          ((-0.10, -0.65, 0.0), (0.08, 0.40, 0.08)))
_SHOULDER = (0.24, 0.42, 0.0)
_ARM_RADII = (0.06, 0.30, 0.06)
_ARM_REST_DEG = 10.0


def _hit_ellipsoid(o, d, centre, radii, psi):
    """Nearest positive hit t [M] (inf where missed) and the world normal at it
    of rays o, d [M, 3] with the ellipsoid of `radii` turned by psi [M] about z."""
    c, s = torch.cos(psi), torch.sin(psi)

    def to_local(v):
        return torch.stack([c * v[:, 0] + s * v[:, 1], -s * v[:, 0] + c * v[:, 1], v[:, 2]], -1)

    lo = to_local(o - centre) / radii
    ld = to_local(d) / radii
    a = (ld * ld).sum(-1)
    b = 2.0 * (lo * ld).sum(-1)
    cc = (lo * lo).sum(-1) - 1.0
    disc = b * b - 4.0 * a * cc
    root = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - root) / (2.0 * a)
    t1 = (-b + root) / (2.0 * a)
    t = torch.where(t0 > 1e-4, t0, t1)
    t = torch.where((disc > 0) & (t > 1e-4), t, torch.full_like(t, float("inf")))
    p = lo + t.clamp(max=1e6)[:, None] * ld
    n_local = p / radii
    n = torch.stack([c * n_local[:, 0] - s * n_local[:, 1],
                     s * n_local[:, 0] + c * n_local[:, 1], n_local[:, 2]], -1)
    return t, n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp(min=1e-12)


def trace_body(origins: torch.Tensor, dirs: torch.Tensor, arm_deg: torch.Tensor,
               colours: torch.Tensor, white_background: bool) -> torch.Tensor:
    """rgb [N, M, 3] of rays [N, M, 3] of views whose arm angles are arm_deg [N]."""
    n_views, m = origins.shape[:2]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    dn = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    phi = torch.deg2rad(arm_deg + _ARM_REST_DEG).repeat_interleave(m)
    dev = o.device
    best = torch.full((o.shape[0],), float("inf"), device=dev)
    rgb = torch.full((o.shape[0], 3), 1.0 if white_background else 0.0, device=dev)
    zero = torch.zeros_like(phi)
    parts = []
    for centre, radii in _PARTS:
        parts.append((torch.tensor(centre, device=dev), torch.tensor(radii, device=dev), zero))
    for side in (1.0, -1.0):
        u = torch.stack([side * torch.sin(phi), -torch.cos(phi), zero], -1)
        centre = torch.tensor(_SHOULDER, device=dev) * torch.tensor([side, 1.0, 1.0],
                                                                     device=dev)
        parts.append((centre + _ARM_RADII[1] * u, torch.tensor(_ARM_RADII, device=dev),
                      side * phi))
    for k, (centre, radii, psi) in enumerate(parts):
        t, n = _hit_ellipsoid(o, d, centre, radii, psi)
        shade = 0.25 + 0.75 * (n * dn).sum(-1).abs()
        closer = t < best
        best = torch.where(closer, t, best)
        rgb = torch.where(closer[:, None], colours[k] * shade[:, None], rgb)
    return rgb.reshape(n_views, m, 3)


def arm_poses(arm_deg: torch.Tensor, joints: Iterable[int]) -> torch.Tensor:
    """[N, 69] poses with each view's arm angle (radians) in `joints`."""
    pose = torch.zeros((arm_deg.shape[0], 69), dtype=torch.float32, device=arm_deg.device)
    for j in joints:
        pose[:, int(j)] = torch.deg2rad(arm_deg.float())
    return pose


def draw_views(seed: int, stream: int, n: int, step_deg: float, arm_range,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(azimuths_deg [n], arm_deg [n]) of n views that follow each other by
    step_deg along the circle from a seeded start, arm angles uniform in
    arm_range."""
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, stream))
    start = torch.rand((1,), generator=g, device=device) * 360.0
    azimuths = start + step_deg * torch.arange(n, device=device, dtype=torch.float32)
    lo, hi = arm_range
    arms = lo + (hi - lo) * torch.rand((n,), generator=g, device=device)
    return azimuths, arms


def part_colours(seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 7))
    return 0.2 + 0.75 * torch.rand((len(_PARTS) + 2, 3), generator=g, device=device)


def make_views(seed: int, stream: int, n: int, step_deg: float, params: dict, joints,
               white_background: bool, device, with_rgb: bool) -> dict:
    """n views of params['resolution']^2 rays: 'origins', 'directions'
    [n, hw, 3], 'poses' [n, 69], 'arm_deg', 'cams', and with_rgb the targets
    'rgb' [n, hw, 3]."""
    res = int(params["resolution"])
    azimuths, arms = draw_views(seed, stream, n, step_deg, params["arm_deg"], device)
    cams = circle_cameras(azimuths, float(params["radius"]))
    origins, dirs = camera_rays(cams, res, res, float(params["fov_deg"]))
    out = {"origins": origins, "directions": dirs, "poses": arm_poses(arms, joints),
           "arm_deg": arms, "cams": cams}
    if with_rgb:
        out["rgb"] = trace_body(origins, dirs, arms, part_colours(seed, device),
                                white_background)
    return out


def lecun_weights(shapes: Dict[str, Dict[str, tuple]], seed: int, device
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{model: {leaf: tensor}} for the leaves' shapes: 2-D leaves
    lecun-normal truncated to 2 std (std sqrt(1/fan_in)), 1-D leaves zero.
    One uniform draw covers every kernel; erfinv maps it to the normal."""
    kernels = [(m, k, s) for m, leaves in shapes.items() for k, s in leaves.items()
               if len(s) == 2]
    total = sum(s[0] * s[1] for _, _, s in kernels)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, 3))
    lo = math.erf(-2.0 / math.sqrt(2.0))
    flat = torch.empty(total, dtype=torch.float32, device=device).uniform_(lo, -lo, generator=g)
    flat.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    out: Dict[str, Dict[str, torch.Tensor]] = {m: {} for m in shapes}
    at = 0
    for m, k, s in kernels:
        n = s[0] * s[1]
        std = (1.0 / s[1]) ** 0.5 / 0.87962566103423978
        out[m][k] = flat[at:at + n].view(s) * std
        at += n
    for m, leaves in shapes.items():
        for k, s in leaves.items():
            if len(s) != 2:
                out[m][k] = torch.zeros(s, dtype=torch.float32, device=device)
    return {m: {k: out[m][k] for k in shapes[m]} for m in shapes}


def make_weights(flags: dict, seed: int, views: dict, device, centre: bool
                 ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The weights both sides start from: `lecun_weights`, and with `centre`
    each net's density centred on a probe of every 16th ray of the first view."""
    from port_bench import reference

    weights = lecun_weights(reference.Widths(flags).shapes(), seed, device)
    if centre:
        reference.centre_density(flags, weights, views["origins"][0][::16],
                                 views["directions"][0][::16], views["poses"][0])
    return weights
