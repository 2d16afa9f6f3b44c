"""Depth -> RGB U-Net baseline, the stand-in for Table 1's Pix2Pix row
(counterpart of tools/pix2pix_baseline.py).

    python pix2pix_baseline_torch.py --dataset_dir D [--epochs 60] [--batch 8] \
        [--fg_weight 15] [--lrate 2e-4] [--seed 0] [--out DIR] [--device cuda]

Trains a compact U-Net (four stride-2 4x4 convolutions with leaky ReLU 0.2, a
stride-2 bottleneck with ReLU, four stride-2 4x4 transposed convolutions with
ReLU, each followed by the encoder's skip, a last transposed convolution and a
3x3 convolution into a sigmoid; bf16 products with flax's Dense-style
rounding) on the [rgb | depth] PNG pairs of `create_dataset_torch.py
--dataset_type=pix2pix` (read through data/png.py, not cv2), with Adam and an
L1 loss whose foreground pixels (any channel below 0.98) weigh 1 + fg_weight.
Then it renders the val split, prints MSE / PSNR / SSIM (rLPIPS from 32 px,
LPIPS with the local weights) and, with --out, writes img_XXX.png (RGB, as
the JAX tool writes them) and scores.json there. Runs on the card unless
--device cpu.

flax's ConvTranspose applies its kernel unflipped (`transpose_kernel=False`):
a correlation over the input dilated by the stride, padded (2, 2) for SAME at
kernel 4 and stride 2. torch's `conv_transpose2d` at padding 1 is that
correlation with the kernel flipped in both spatial axes, so
`state_dict_from_jax` flips those kernels and lays them out [in, out, kh,
kw]. flax's SAME padding of a stride-2 4x4 convolution pads (1, 1) at an even
size, which is torch's padding=1; five halvings need sides that are multiples
of 32, which the U-Net checks.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.data import png
from smpl_nerf_tpu_torch.models.render_ray_net import init_linear_

DOWN = 4                         # stride-2 convolutions on each side of the bottleneck
MULTIPLE = 2 ** (DOWN + 1)       # image sides must be multiples of this


def load_pairs(directory: str) -> Tuple[np.ndarray, np.ndarray]:
    """[N, h, w, 3] RGB in [0, 1] and [N, h, w, 1] depth in [0, 1] from the
    [rgb | depth] PNGs of a directory, in file-name order."""
    paths = sorted(glob.glob(os.path.join(directory, "*.png")))
    if not paths:
        raise FileNotFoundError(f"no PNGs in {directory}")
    rgbs, depths = [], []
    for p in paths:
        img = png.read_png(p)[..., ::-1].astype(np.float32) / 255.0
        w = img.shape[1] // 2
        rgbs.append(img[:, :w])
        depths.append(img[:, w:, :1])
    return np.stack(rgbs), np.stack(depths)


class UNet(nn.Module):
    """Input [N, h, w, 1] depth, output [N, h, w, 3] RGB in (0, 1) (NHWC, as
    the JAX module); layer names are the flax module's."""

    def __init__(self, base: int = 32, compute_dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        c = base
        self.compute_dtype = compute_dtype
        enc = (c, 2 * c, 4 * c, 8 * c)
        cin = in_channels
        for i, ch in enumerate(enc):
            setattr(self, f"down{i}", nn.Conv2d(cin, ch, 4, stride=2, padding=1))
            cin = ch
        self.bottleneck = nn.Conv2d(cin, 8 * c, 4, stride=2, padding=1)
        cin = 8 * c
        for i, (ch, skip) in enumerate(zip((8 * c, 4 * c, 2 * c, c), reversed(enc))):
            setattr(self, f"up{i}", nn.ConvTranspose2d(cin, ch, 4, stride=2, padding=1))
            cin = ch + skip
        self.up_last = nn.ConvTranspose2d(cin, c, 4, stride=2, padding=1)
        self.rgb = nn.Conv2d(c, 3, 3, padding=1)
        # flax's lecun-normal kernels, fan-in kh * kw * in ([out, in, kh, kw]
        # for a Conv2d, [in, out, kh, kw] for a ConvTranspose2d), zero biases
        for layer in self.modules():
            if isinstance(layer, nn.Conv2d):
                init_linear_(layer, generator, layer.weight[0].numel())
            elif isinstance(layer, nn.ConvTranspose2d):
                init_linear_(layer, generator, layer.weight.shape[0] * layer.weight[0, 0].numel())

    def _layer(self, layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """The layer at compute_dtype, rounded as flax rounds: inputs and
        kernel in that type, the product rounded to it, then its bias added."""
        cdt = self.compute_dtype
        conv = F.conv_transpose2d if isinstance(layer, nn.ConvTranspose2d) else F.conv2d
        y = conv(h.to(cdt), layer.weight.to(cdt), None, layer.stride, layer.padding)
        return y + layer.bias.to(cdt)[:, None, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h_in, w_in = x.shape[1:3]
        if h_in % MULTIPLE or w_in % MULTIPLE:
            raise ValueError(f"the U-Net takes sides that are multiples of {MULTIPLE}, "
                             f"got {h_in}x{w_in}")
        h = x.permute(0, 3, 1, 2)
        enc = []
        for i in range(DOWN):
            h = F.leaky_relu(self._layer(getattr(self, f"down{i}"), h), 0.2)
            enc.append(h)
        h = torch.relu(self._layer(self.bottleneck, h))
        for i, skip in enumerate(reversed(enc)):
            h = torch.relu(self._layer(getattr(self, f"up{i}"), h))
            h = torch.cat([h, skip], 1)
        h = torch.relu(self._layer(self.up_last, h))
        h = self._layer(self.rgb, h)
        return torch.sigmoid(h.float()).permute(0, 2, 3, 1)


def state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax UNet params ({"params": {layer: {"kernel", "bias"}}}) -> UNet
    state_dict: a Conv kernel [kh, kw, in, out] becomes [out, in, kh, kw]; a
    ConvTranspose kernel (layers up*) becomes [in, out, kh, kw], flipped in
    both spatial axes."""
    sd = {}
    for name, leaves in params.get("params", params).items():
        k = np.asarray(leaves["kernel"], np.float32)
        if name.startswith("up"):
            k = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            k = k.transpose(3, 2, 0, 1)
        sd[f"{name}.weight"] = torch.tensor(np.ascontiguousarray(k))
        sd[f"{name}.bias"] = torch.tensor(np.asarray(leaves["bias"], np.float32))
    return sd


def weighted_l1(pred: torch.Tensor, target: torch.Tensor, fg_weight: float) -> torch.Tensor:
    """L1 with foreground pixels (any channel below 0.98) weighted 1 + fg_weight:
    plain L1 on a mostly white scene collapses to the all-white output."""
    err = torch.abs(pred - target)
    fg = (target.min(-1, keepdim=True).values < 0.98).float()
    w = 1.0 + fg_weight * fg
    return (err * w).sum() / (w.sum() * 3.0)


def predict(model: UNet, depth: torch.Tensor, batch: int = 8) -> np.ndarray:
    with torch.no_grad():
        return np.concatenate([model(depth[i:i + batch]).cpu().numpy()
                               for i in range(0, len(depth), batch)])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """{"renders": [N, h, w, 3] RGB, "scores", "losses": per-epoch mean L1,
    "epoch_seconds"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fg_weight", type=float, default=15.0)
    ap.add_argument("--lrate", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rgb_tr, dep_tr = load_pairs(os.path.join(args.dataset_dir, "train"))
    rgb_va, dep_va = load_pairs(os.path.join(args.dataset_dir, "val"))
    print(f"train {rgb_tr.shape} val {rgb_va.shape}")
    model = UNet(generator=torch.Generator().manual_seed(args.seed)).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lrate, eps=1e-8)
    dep_tr_d = torch.as_tensor(dep_tr, device=dev)
    rgb_tr_d = torch.as_tensor(rgb_tr, device=dev)

    n = len(rgb_tr)
    steps = max(1, n // args.batch)
    rng = np.random.RandomState(args.seed)
    losses, epoch_seconds = [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        perm = rng.permutation(n)
        step_losses = []
        for s in range(steps):
            idx = perm[s * args.batch:(s + 1) * args.batch]
            if len(idx) < args.batch:
                idx = np.concatenate([idx, perm[:args.batch - len(idx)]])
            idx_d = torch.as_tensor(idx, device=dev)
            optimizer.zero_grad()
            loss = weighted_l1(model(dep_tr_d[idx_d]), rgb_tr_d[idx_d], args.fg_weight)
            loss.backward()
            optimizer.step()
            step_losses.append(loss.detach())      # no host sync inside the epoch
        losses.append(float(torch.stack(step_losses).mean()))
        epoch_seconds.append(time.perf_counter() - t0)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            print(f"[epoch {epoch}] L1 {losses[-1]:.5f} ({epoch_seconds[-1]:.1f}s)")

    from smpl_nerf_tpu_torch.evaluation.scores import print_scores

    renders = predict(model, torch.as_tensor(dep_va, device=dev))
    scores = print_scores(renders, rgb_va, device=dev)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        for i, img in enumerate(renders):
            rgb8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            png.write_png(os.path.join(args.out, f"img_{i:03d}.png"),
                          np.ascontiguousarray(rgb8[..., ::-1]))
        with open(os.path.join(args.out, "scores.json"), "w") as fh:
            json.dump(scores, fh, indent=1)
        print("pix2pix-standin renders + scores ->", args.out)
    return {"renders": renders, "scores": scores, "losses": losses,
            "epoch_seconds": epoch_seconds}


if __name__ == "__main__":
    main()
