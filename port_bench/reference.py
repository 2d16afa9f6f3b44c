"""The plain reference of both configurations (frozen yardstick).

Plain PyTorch, float32 with TF32 off, written from the published
SMPL-NeRF pipeline and imported from nothing of the program: positional
encoding, the RenderRayNet MLP (skip concatenation, sigma head, directional
branch), the smpl_nerf warp field, disparity-linear coarse sampling with one
jitter per ray, inverse-CDF fine sampling (`sample_pdf`), alpha compositing
(`raw2outputs`), the two-pass MSE loss and Adam. It reads the configuration's
flags and the weights the harness made, never the program's state.

Precision: the reference computes the MLPs in the precision the
configuration states (`compute_dtype`), with the rounding points of flax's
`nn.Dense(dtype=...)` that the program documents: in bfloat16 the inputs and
weights are rounded to bf16, the product (float32 accumulation) is rounded
to bf16 and the bf16 bias is added in bf16; the activations stay bf16 up to
each net's float32 output, and autograd's backward runs in the same types.
`precision="fp8"` is the control, the step below bf16: each product's
operands are first rounded to float8 e4m3 (one scale per tensor, as an fp8
GEMM takes them), the rounding passed straight through by the gradient.
Sampling, compositing, the loss and Adam are float32 throughout.
Random draws (the jitter and the sigma noise of a training step) come from a
generator seeded as the program seeds its own, drawn in the program's order
and shapes, so both sides see the same numbers.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

F8_MAX = 448.0


@contextlib.contextmanager
def full_float32():
    """Float32 products in full precision inside the block (TF32 off)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def stated_precision(flags: dict) -> str:
    """The MLPs' precision the configuration states: 'bfloat16' or 'float32'."""
    return "bfloat16" if flags["compute_dtype"] == "bfloat16" else "float32"


def compute_type(precision: str) -> torch.dtype:
    return torch.float32 if precision == "float32" else torch.bfloat16


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, in x's type."""
    scale = x.detach().float().abs().amax().clamp(min=1e-30) / F8_MAX
    q = ((x.detach().float() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale)
    return x + (q.to(x.dtype) - x.detach())


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          precision: str) -> torch.Tensor:
    """x @ weight.T + bias in `precision` (x already in its compute type)."""
    cdt = compute_type(precision)
    w = weight.to(cdt)
    if precision == "fp8":
        x, w = _fp8(x), _fp8(w)
    return torch.matmul(x, w.t()) + bias.to(cdt)


def encode(x: torch.Tensor, frequencies: int, identity: bool) -> torch.Tensor:
    """[identity?, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...], each block over all dims."""
    parts = [x] if identity else []
    if frequencies > 0:
        freqs = 2.0 ** torch.arange(frequencies, dtype=torch.float32, device=x.device)
        scaled = x[..., None, :] * freqs[:, None]
        parts.append(torch.stack([torch.sin(scaled), torch.cos(scaled)], -2)
                     .reshape(*x.shape[:-1], -1))
    return torch.cat(parts, -1)


class Widths:
    """The sizes the flags give: encodings, the prefix, each net's leaves."""

    def __init__(self, flags: dict):
        f = flags
        self.model_type = f["model_type"]
        self.lp, self.ld = int(f["number_frequencies_postitional"]), int(
            f["number_frequencies_directional"])
        self.lpose = int(f["number_frequencies_pose"])
        self.id_pos, self.id_dir = bool(f["use_identity_positional"]), bool(
            f["use_identity_directional"])
        self.id_pose = bool(f["use_identity_pose"])
        self.pose_encoding = bool(f["human_pose_encoding"])
        self.joints = sorted(int(j) for j in f["human_joints"])
        self.pos_dim = 3 * (2 * self.lp + self.id_pos)
        self.dir_dim = 3 * (2 * self.ld + self.id_dir)
        per_joint = (2 * self.lpose + self.id_pose) if self.pose_encoding else 1
        self.prefix_dim = {"append_smpl_params": 69 * per_joint,
                           "append_to_nerf": 2 * per_joint}.get(self.model_type, 0)
        self.warp_in = ((self.pos_dim if self.pose_encoding else 3) + 2 * per_joint
                        if self.model_type == "smpl_nerf" else 0)
        self.nets = {"model_coarse": (int(f["netdepth"]), int(f["netwidth"]),
                                      tuple(int(s) for s in f["skips"])),
                     "model_fine": (int(f["netdepth_fine"]), int(f["netwidth_fine"]),
                                    tuple(int(s) for s in f["skips_fine"]))}
        self.warp_width = int(f["netwidth_warp"])

    def net_shapes(self, depth: int, width: int, skips) -> Dict[str, tuple]:
        p = self.pos_dim + self.prefix_dim
        s = {"positions_pose_input": (width, p)}
        for i in range(depth - 1):
            s[f"positional_net.{i}"] = (width, width + (p if i in skips else 0))
        s["additional_linear_layer"] = (width, width)
        s["sigma_out_layer"] = (1, width)
        s["directional_input"] = (width // 2, width + self.dir_dim)
        s["directional_net.0"] = (width // 2, width // 2)
        s["rgb_out_layer"] = (3, width // 2)
        return s

    def shapes(self) -> Dict[str, Dict[str, tuple]]:
        """{model: {leaf: shape}} in the modules' parameter order."""
        out = {}
        for name, (depth, width, skips) in self.nets.items():
            leaves = {}
            for layer, (o, i) in self.net_shapes(depth, width, skips).items():
                leaves[f"{layer}.weight"], leaves[f"{layer}.bias"] = (o, i), (o,)
            out[name] = leaves
        if self.model_type == "smpl_nerf":
            out["model_warp_field"] = {
                "linear1.weight": (self.warp_width, self.warp_in),
                "linear1.bias": (self.warp_width,),
                "linear2.weight": (3, self.warp_width), "linear2.bias": (3,)}
        return out


def net_forward(w: Dict[str, torch.Tensor], depth: int, skips, pos: torch.Tensor,
                dirs: torch.Tensor, precision: str) -> torch.Tensor:
    """raw [N, 4] (rgb, sigma), float32, of the RenderRayNet on rows pos [N, P],
    dirs [N, D]."""
    cdt = compute_type(precision)
    pos, dirs = pos.to(cdt), dirs.to(cdt)

    def lin(name, x):
        return dense(x, w[f"{name}.weight"], w[f"{name}.bias"], precision)

    h = torch.relu(lin("positions_pose_input", pos))
    for i in range(depth - 1):
        if i in skips:
            h = torch.cat([h, pos], -1)
        h = torch.relu(lin(f"positional_net.{i}", h))
    h = lin("additional_linear_layer", h)
    sigma = lin("sigma_out_layer", h)
    h = lin("directional_input", torch.cat([h, dirs], -1))
    h = torch.relu(lin("directional_net.0", h))
    return torch.cat([lin("rgb_out_layer", h), sigma], -1).float()


def coarse_z(near: float, far: float, n: int, rays: int, generator, device) -> torch.Tensor:
    t = torch.linspace(0.0, 1.0, n, device=device)
    z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    mids = 0.5 * (z[1:] + z[:-1])
    upper = torch.cat([mids, z[-1:]])
    lower = torch.cat([z[:1], mids])
    if generator is None:
        jitter = torch.full((rays, 1), 0.5, device=device)
    else:
        jitter = torch.rand((rays, 1), generator=generator, dtype=torch.float32, device=device)
    return lower + (upper - lower) * jitter


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse-CDF samples [R, n] of bins [R, K] under weights [R, K-1], at
    u = f * float32(1/(n-1)), f = 0..n-1."""
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


def composite(raw, z, dirs, noise_std: float, white: bool, generator):
    """(rgb [R, 3], weights [R, S]); dirs per ray [R, 3] or per sample [R, S, 3]."""
    rgb = torch.sigmoid(raw[..., :3])
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], -1)
    norm = torch.linalg.norm(dirs, dim=-1)
    dists = dists * (norm[:, None] if dirs.dim() == 2 else norm)
    sigma = raw[..., 3]
    if generator is not None and noise_std > 0.0:
        sigma = sigma + noise_std * torch.randn(sigma.shape, generator=generator,
                                                dtype=sigma.dtype, device=sigma.device)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     (1.0 - alpha + 1e-10)[:, :-1]], -1), -1)
    weights = alpha * trans
    out = (weights[..., None] * rgb).sum(-2)
    if white:
        out = out + (1.0 - weights.sum(-1))[:, None]
    return out, weights


class Field:
    """The two-pass render of a configuration on plain tensors."""

    def __init__(self, flags: dict, params: Dict[str, Dict[str, torch.Tensor]],
                 precision: str):
        self.flags = flags
        self.wd = Widths(flags)
        self.params = params
        self.precision = precision
        self.near, self.far = float(flags["near"]), float(flags["far"])
        self.nc, self.nf = int(flags["number_coarse_samples"]), int(flags["number_fine_samples"])
        self.noise = float(flags["sigma_noise_std"])
        self.white = bool(flags["white_background"])

    def _net(self, name, pos, dirs):
        depth, _, skips = self.wd.nets[name]
        return net_forward(self.params[name], depth, skips, pos, dirs, self.precision)

    def _raw(self, name, origins, dirs, pose, z, fine):
        """(raw [R, S, 4], the directions to composite with) of one pass."""
        wd = self.wd
        R, S = z.shape
        samples = origins[:, None, :] + dirs[:, None, :] * z[..., None]
        if wd.model_type == "smpl_nerf":
            pose2 = torch.stack([pose[:, j] for j in wd.joints], -1)
            pose_feat = (encode(pose2, wd.lpose, wd.id_pose) if wd.pose_encoding else pose2)
            sample_feat = (encode(samples, wd.lp, wd.id_pos) if wd.pose_encoding else samples)
            rows = torch.cat([sample_feat.reshape(R * S, -1),
                              pose_feat[:, None, :].expand(R, S, -1).reshape(R * S, -1)], -1)
            w = self.params["model_warp_field"]
            rows = rows.to(compute_type(self.precision))
            h = torch.relu(dense(rows, w["linear1.weight"], w["linear1.bias"], self.precision))
            warp = dense(h, w["linear2.weight"], w["linear2.bias"], self.precision).float()
            warped = samples + warp.reshape(R, S, 3)
            sdirs = warped - origins[:, None, :]
            unit = sdirs / torch.linalg.norm(sdirs, dim=-1, keepdim=True)
            raw = self._net(name, encode(warped, wd.lp, wd.id_pos).reshape(R * S, -1),
                            encode(unit, wd.ld, wd.id_dir).reshape(R * S, -1))
            comp_dirs = dirs if fine else sdirs
        else:
            unit = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
            pos = encode(samples, wd.lp, wd.id_pos)
            if wd.prefix_dim:
                prefix = encode(pose, wd.lpose, wd.id_pose) if wd.pose_encoding else pose
                pos = torch.cat([prefix[:, None, :].expand(R, S, -1), pos], -1)
            raw = self._net(name, pos.reshape(R * S, -1),
                            encode(unit, wd.ld, wd.id_dir)[:, None, :].expand(R, S, -1)
                            .reshape(R * S, -1))
            comp_dirs = dirs
        return raw.reshape(R, S, 4), comp_dirs

    def _pass(self, name, origins, dirs, pose, z, fine, generator):
        raw, comp_dirs = self._raw(name, origins, dirs, pose, z, fine)
        return composite(raw, z, comp_dirs, self.noise if generator is not None else 0.0,
                         self.white, generator)

    def render(self, origins, dirs, pose, generator: Optional[torch.Generator] = None):
        """(rgb_coarse, rgb_fine) [R, 3]; a generator means a training pass
        (jitter and sigma noise), none the evaluation pass."""
        z = coarse_z(self.near, self.far, self.nc, origins.shape[0], generator, origins.device)
        rgb_c, weights = self._pass("model_coarse", origins, dirs, pose, z, False, generator)
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        z_f = sample_pdf(mids.detach(), weights[:, 1:-1].detach(), self.nf).detach()
        z_all, _ = torch.sort(torch.cat([z, z_f], -1), -1)
        rgb_f, _ = self._pass("model_fine", origins, dirs, pose, z_all, True, generator)
        return rgb_c, rgb_f


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) over a list of float32 leaves."""

    def __init__(self, params: List[torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1.0 - b1 ** self.t, (1.0 - b2 ** self.t) ** 0.5
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, v.sqrt().div_(c2).add_(1e-8), value=-self.lr / c1)


def train_steps(flags: dict, weights: Dict[str, Dict[str, torch.Tensor]], batches: list,
                seed: int, precision: str) -> dict:
    """Steps of the training loop on `batches` (each {'origins', 'directions',
    'poses', 'rgb'}) from `weights`: {'losses': [...], 'grad1': {model: {leaf:
    first gradient}}, 'params': {model: {leaf: after the last step}}}. The
    jitter and noise come from a device generator seeded with `seed`."""
    with full_float32():
        params = {m: {k: v.detach().clone().requires_grad_(True) for k, v in leaves.items()}
                  for m, leaves in weights.items()}
        flat = [p for leaves in params.values() for p in leaves.values()]
        opt = Adam(flat, float(flags["lrate"]))
        field = Field(flags, params, precision)
        device = flat[0].device
        gen = torch.Generator(device=device).manual_seed(int(seed))
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
        return {"losses": losses,
                "grad1": {m: {k: next(it) for k in leaves} for m, leaves in params.items()},
                "params": {m: {k: v.detach() for k, v in leaves.items()}
                           for m, leaves in params.items()}}


@torch.no_grad()
def render_view(flags: dict, weights, origins, dirs, pose69, precision: str,
                block: int = 4096) -> torch.Tensor:
    """rgb_fine [M, 3] of one view's rays [M, 3] at pose69 [69], in blocks of rays."""
    with full_float32():
        field = Field(flags, weights, precision)
        out = []
        for lo in range(0, origins.shape[0], block):
            o, d = origins[lo:lo + block], dirs[lo:lo + block]
            _, rgb_f = field.render(o, d, pose69[None].expand(o.shape[0], 69))
            out.append(rgb_f)
        return torch.cat(out)


@torch.no_grad()
def centre_density(flags: dict, weights, origins, dirs, pose69) -> None:
    """Set each net's sigma_out_layer bias (in place) so that the median sigma
    over the coarse samples of the probe rays (origins, dirs [M, 3] at
    pose69 [69]) is 0: random weights then give views with partly opaque
    rays, not a field that is empty or solid everywhere."""
    with full_float32():
        field = Field(flags, weights, "float32")
        pose = pose69[None].expand(origins.shape[0], 69)
        z = coarse_z(field.near, field.far, field.nc, origins.shape[0], None, origins.device)
        for name in ("model_coarse", "model_fine"):
            raw, _ = field._raw(name, origins, dirs, pose, z, False)
            weights[name]["sigma_out_layer.bias"] -= raw[..., 3].median()
