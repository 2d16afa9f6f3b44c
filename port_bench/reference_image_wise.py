"""The plain reference of the image_wise_dynamic configuration (frozen yardstick).

The benchmark's own copy of image_wise_reference_torch.py, importing nothing
of the program: plain PyTorch with TF32 off, written from the published pose
optimisation through a frozen NeRF (HannesStark/SMPL-NeRF
solver/image_wise_solver.py). Per training step of a batch ('origins',
'directions', 'z_vals', 'rgb'):

* the body pose: the two arm angles in dims 38 and 41 of the zero pose;
* SMPL LBS in float32 from the body's arrays (reference_dummy_dynamic.lbs)
  of the zero pose (the canonical mesh) and of that pose (the goal mesh); the
  per-vertex warps canonical - goal;
* the normalised-ReLU attention in float32 of every sample over all goal
  vertices, att = relu(warp_radius - |x - v|), w = att / (sum_v att + 1e-5),
  the warp sum_v w * warp_v. It is computed in blocks of rays, each block's
  [rays, S, V] logits whole, and the gradient in the goal vertices summed
  over the blocks before it goes back through LBS: that only makes it fit;
* the warped samples, their directions from the origin, the encodings, the
  frozen coarse RenderRayNet in the stated precision (reference.net_forward:
  flax's rounding points in bf16; the float8 control rounds each product's
  operands to e4m3), `raw2outputs` on the per-sample directions with no
  sigma noise (reference.composite);
* the loss MSE(rgb); its gradient in the two angles by autograd; Adam on the
  angles at lrate_pose (decayed by 0.1^(step / (lrate_pose_decay * 1000))
  where the flag is set: PoseAdam).
The depths of the samples are the program's own (one jitter an image, drawn
by the program from numpy's global generator), recorded at the seam.

`attention_vjp` holds the attention's backward into its goal vertices at a
posed step (canonical != goal, where that term is not 0): given the
attention's inputs that the program recorded at its seam and a cotangent
(`cotangent`), the gradient into the goal vertices by autograd in float64, in
blocks of rays summed.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from port_bench import reference
from port_bench.reference_dummy_dynamic import lbs

RAY_BLOCK = 64
VJP_BLOCK = 16
# The cotangent holds only the samples whose gradient float32 can settle.
# Near a sum of 0, w = att / (sum + 1e-5) turns float32's rounding of att
# (~1e-8 at a sphere's edge) into gradients far from the exact ones; and a
# vertex within float32's rounding of a sphere's edge is inside on one side
# and outside on the other, where relu's derivative jumps. So the samples with
# an attention sum under SUM_FLOOR, or with a vertex whose distance lies
# within EDGE of the radius, take a cotangent of 0 (PERF.md section 2).
SUM_FLOOR = 1e-2
EDGE = 1e-6
LEFT_ARM, RIGHT_ARM = 38, 41


def relu_attention_warp(samples: torch.Tensor, goal: torch.Tensor, warps: torch.Tensor,
                        radius: float, fp8: bool = False) -> torch.Tensor:
    """[R, S, 3] warps of samples [R, S, 3] by the attention over goal [V, 3];
    `fp8`: its one product as the float8 control takes a product
    (reference.dense), the rest in the inputs' type."""
    att = torch.relu(radius - torch.sqrt(((samples[:, :, None, :] - goal) ** 2).sum(-1)))
    w = att / (att.sum(-1, keepdim=True) + 1e-5)
    if fp8:
        bias = torch.zeros(3, dtype=torch.bfloat16, device=w.device)
        return reference.dense(w.to(torch.bfloat16), warps.t(), bias, "fp8").to(samples.dtype)
    return torch.einsum("rsv,vc->rsc", w, warps)


def pose_of(angles: torch.Tensor) -> torch.Tensor:
    """[1, 69]: the zero pose with angles [2] (left, right) in dims 38 and 41."""
    zero = torch.zeros(69, device=angles.device)
    return torch.cat([zero[:LEFT_ARM], angles[:1], zero[LEFT_ARM + 1:RIGHT_ARM], angles[1:],
                      zero[RIGHT_ARM + 1:]])[None]


def _step(flags: dict, net: Dict[str, torch.Tensor], body: dict, angles: torch.Tensor,
          batch: dict, precision: str, block: int):
    """(loss, gradient [2] in the angles, warp [R, S, 3]) of one batch."""
    f = flags
    lp, ld = int(f["number_frequencies_postitional"]), int(f["number_frequencies_directional"])
    depth, skips = int(f["netdepth"]), tuple(int(s) for s in f["skips"])
    radius, white = float(f["warp_radius"]), bool(f["white_background"])
    betas = torch.zeros(10, device=angles.device)
    leaf = angles.detach().clone().requires_grad_(True)
    with torch.no_grad():
        canonical = lbs(body, betas, torch.zeros((1, 69), device=angles.device))[0]
    goal = lbs(body, betas, pose_of(leaf))[0]
    o, d, z, rgb = batch["origins"], batch["directions"], batch["z_vals"], batch["rgb"]
    R, S = z.shape
    g_goal = torch.zeros_like(goal)
    loss, warps = 0.0, []
    for lo in range(0, R, block):
        b = slice(lo, min(lo + block, R))
        goal_b = goal.detach().requires_grad_(True)
        samples = o[b, None, :] + d[b, None, :] * z[b, :, None]
        warp = relu_attention_warp(samples, goal_b, canonical - goal_b, radius)
        warped = samples + warp
        sample_dirs = warped - o[b, None, :]
        unit = sample_dirs / torch.linalg.norm(sample_dirs, dim=-1, keepdim=True)
        n = warped.shape[0] * S
        raw = reference.net_forward(net, depth, skips,
                                    reference.encode(warped, lp, False).reshape(n, -1),
                                    reference.encode(unit, ld, False).reshape(n, -1), precision)
        out, _ = reference.composite(raw.reshape(-1, S, 4), z[b], sample_dirs, 0.0, white, None)
        part = ((out - rgb[b]) ** 2).sum() / (R * 3)
        g_goal += torch.autograd.grad(part, goal_b)[0]
        loss += float(part.detach())
        warps.append(warp.detach())
    grad, = torch.autograd.grad(goal, leaf, grad_outputs=g_goal)
    return loss, grad, torch.cat(warps)


class PoseAdam:
    """Adam on the two arm angles from 0 at lrate_pose, decayed by
    0.1^(step / (lrate_pose_decay * 1000)) where the flag is set."""

    def __init__(self, flags: dict, device):
        self.angles = torch.zeros(2, device=device)
        self.lr, self.decay = float(flags["lrate_pose"]), int(flags.get("lrate_pose_decay", 0) or 0)
        self.opt, self.t = reference.Adam([self.angles], self.lr), 0

    def step(self, grad: torch.Tensor) -> torch.Tensor:
        """The angles after one step on `grad` [2]."""
        self.opt.lr = self.lr * (0.1 ** (self.t / (self.decay * 1000.0)) if self.decay > 0 else 1.0)
        self.opt.step([grad])
        self.t += 1
        return self.angles.detach().clone()


def replay_adam(flags: dict, grads) -> torch.Tensor:
    """[n, 2]: PoseAdam's angles after each of the n gradients `grads` ([2] each)."""
    with reference.full_float32():
        adam = PoseAdam(flags, grads[0].device)
        return torch.stack([adam.step(g.float()) for g in grads])


def train_steps(flags: dict, net: Dict[str, torch.Tensor], body: dict, batches: List[dict],
                precision: str, block: int = RAY_BLOCK) -> dict:
    """One PoseAdam step on the two arm angles per batch, the coarse net `net`
    frozen: {'losses', 'grads' [n, 2], 'angles' [n, 2] after each step,
    'warps' (each step's [R, S, 3])}; body: reference_dummy_dynamic.body_tensors."""
    with reference.full_float32():
        adam = PoseAdam(flags, batches[0]["origins"].device)
        out = {"losses": [], "grads": [], "angles": [], "warps": []}
        for batch in batches:
            loss, grad, warp = _step(flags, net, body, adam.angles, batch, precision, block)
            out["losses"].append(loss)
            out["grads"].append(grad.detach())
            out["angles"].append(adam.step(grad))
            out["warps"].append(warp)
        return {k: (torch.stack(v) if k in ("grads", "angles") else v) for k, v in out.items()}


def _blocks(n: int, block: int):
    return [slice(lo, lo + block) for lo in range(0, n, block)]


def cotangent(seam: dict, radius: float, seed: int) -> torch.Tensor:
    """[R, S, 3] float32: normal draws from `seed` (a CPU generator), 0 on
    the samples whose attention sum over the goal vertices, in float64, is
    under SUM_FLOOR or that have a vertex within EDGE of the radius."""
    samples, goal = seam["samples"].double(), seam["goal"].double()
    g = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    draws = torch.randn(tuple(samples.shape), generator=g).to(samples.device)
    keep = []
    for b in _blocks(samples.shape[0], VJP_BLOCK):
        d = torch.sqrt(((samples[b, :, None, :] - goal) ** 2).sum(-1))
        keep.append((torch.relu(radius - d).sum(-1) >= SUM_FLOOR)
                    & ~((d - radius).abs() < EDGE).any(-1))
    return (draws * torch.cat(keep)[..., None]).float()


def attention_vjp(seam: dict, cot: torch.Tensor, radius: float, precision: str = "float64",
                  block: int = VJP_BLOCK) -> torch.Tensor:
    """[V, 3] float64: the gradient into the goal vertices of the attention
    at the inputs recorded at the program's seam ('samples' [R, S, 3], 'goal'
    [V, 3], 'warps' [V, 3]) under the cotangent `cot` [R, S, 3], the warps
    held as the separate input they are there. In float64, or, as the float8
    control ('fp8'), in float32 with the product in float8."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    samples, cot = seam["samples"].to(dtype), cot.to(dtype)
    goal = seam["goal"].to(dtype, copy=True).requires_grad_(True)
    warps = seam["warps"].to(dtype)
    with reference.full_float32():
        for b in _blocks(samples.shape[0], block):
            out = relu_attention_warp(samples[b], goal, warps, radius, fp8=precision == "fp8")
            (out * cot[b]).sum().backward()
    return goal.grad.to(torch.float64)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.norm(a - b)) / max(float(torch.linalg.norm(b)), 1e-30)


def readings(ours: dict, ref: dict, replayed: torch.Tensor) -> Dict[str, float]:
    """The cell's numbers, ours in train_steps' form and each side's
    'goal_vjp' (attention_vjp's form): loss1_gap (|loss - reference| /
    reference of step 1), pose_grad_gap (|g - g_ref| / |g_ref| of step 1's
    two-angle gradient), warp_gap (|warp - reference| / |reference| of step
    2's warps: step 1's are all 0, the estimator starting at the zero pose,
    where goal = canonical), angles_gap (|angles - replayed| / |replayed|
    after the last step, `replayed` being replay_adam on ours' own gradients:
    the optimizer's step, apart from the gradients, which from step 2 on a
    float32 rounding of one goal vertex moves by up to 6e-2) and goal_vjp_gap
    (|g - g_ref| / |g_ref| of the attention's gradient into the goal vertices
    at the posed step, where both sides hold one: a cell that limits it reads
    its absence as a failure)."""
    out = {"loss1_gap": abs(ours["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0]),
           "pose_grad_gap": _rel(ours["grads"][0], ref["grads"][0]),
           "warp_gap": _rel(ours["warps"][1], ref["warps"][1]),
           "angles_gap": _rel(ours["angles"][-1], replayed[-1])}
    if "goal_vjp" in ours and "goal_vjp" in ref:
        out["goal_vjp_gap"] = _rel(ours["goal_vjp"], ref["goal_vjp"])
    return out


def details(ours: dict, ref: dict) -> dict:
    """The look behind `readings`: each step's gradient and angles gap, and
    both sides' gradients."""
    return {"grad_gaps": [_rel(a, b) for a, b in zip(ours["grads"], ref["grads"])],
            "angles_gaps": [_rel(a, b) for a, b in zip(ours["angles"], ref["angles"])],
            "grads": [g.tolist() for g in ours["grads"]],
            "reference_grads": [g.tolist() for g in ref["grads"]]}
