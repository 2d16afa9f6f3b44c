#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (smpl_nerf_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin) and
the repository checkout around this file. Without a card, or outside the
checkout, it exits non-zero before printing any result. Phases, each
unguarded, so that any failure exits non-zero:

  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every kernel from smpl_nerf_tpu_torch/csrc/ (one nvcc per source,
     all started together) and print the build seconds and ptxas usage;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with CUDA-event times (median of 20) of both and the
     least time the card could take for the same work: A (sample_pdf), B
     (fused v2 forward), D (fused v1 forward, the configs/config.txt net with
     its 621-wide pose prefix) and C (fused v2 backward, seeded cotangent);
  4. the smpl_nerf render: `cli/render_path` on a 2-view 128x128 circle of a
     full-width configs/arm_angles.txt run (seeded weights, --use_fused_mlp=2,
     --use_pallas=1, 2048-ray batches), with the kernels' launch counts set to
     0 just before and read just after; then the same views through the plain
     path (--use_fused_mlp=0 --use_pallas=0), the pixel difference between
     the two, and ms per view of both; one kernel-path render under
     torch.profiler gives the device time by kernel and the device's busy share;
  5. the append render: the same through a full-width configs/config.txt
     (append_smpl_params) run with --run_fine=1 --use_fused_mlp=1
     --use_pallas=1, which goes through A and D;
  6. training: a seeded arm_angles.txt teacher renders 8 train and 2 val views
     at 64x64 (one arm angle per view), written as transforms.json + PNGs;
     `cli.train.train` then runs 2 epochs of 8 steps (batch 2048, 64+128
     samples, 8x256 nets, bf16) from one seed through the kernel path
     (--use_fused_mlp=2 --use_pallas=1: A, B forward, C backward) and through
     the plain path (0, 0); launch counts, finite and falling losses, the two
     paths' losses per step, the saved run rendered through `render_path`,
     ms per step of both paths in turns, and one profiled step;
  7. one JSON line of per-kernel results;
  8. last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Tolerances, each with its reason:
  * sample_pdf (kernel A): the kernel's warp-shuffle cumsum adds in another
    order than torch.cumsum, so where u meets a cdf entry to float precision
    the sample lands one bin over. Every sample must lie within one bin width
    (the widest bin of its input) and at most 0.5% may differ by more than 1e-4.
  * fused forwards (kernels B and D): both sides round the same values to
    bf16 at the same places and accumulate in float32, but in another order,
    which can flip one bf16 rounding (2^-8 relative) that carries through
    later layers: max |err| <= 2e-2 * max |plain| and mean |err| <= 2e-3 *
    mean |plain|.
  * fused v2 backward (kernel C): the same roundings, and besides a ReLU
    mask flips where the two forwards put an activation on either side of
    0, which moves one row's dX by a whole term: dX max |err| <= 0.25 * max
    |plain| and mean |err| <= 5e-3 * mean |plain|. Every dW and db is a sum
    over all rows, where such flips average out: ||kernel - plain|| <= 3e-2 *
    ||plain||. The kernel adds dW with float32 atomics in an order that
    changes from run to run (~1e-6 relative), far inside that bound.
  * kernel path vs plain path renders: the plain path rounds like flax's
    bf16 Dense (product and bias rounded to bf16), the kernel like the TPU
    kernel (float32 bias, bf16 after each activation), and the fine samples
    can flip a bin: max pixel difference <= 0.1, mean <= 1e-2.
  * kernel path vs plain path training losses: the same two roundings, in
    the forward and in the gradients, from the same weights, batches and
    jitter: each of the first 8 steps' losses within 10 % of the other path's.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ARM_ANGLES = os.path.join(REPO, "configs", "arm_angles.txt")
APPEND_CONFIG = os.path.join(REPO, "configs", "config.txt")
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

PDF_R, PDF_K, PDF_F = 2048, 63, 128          # one 2048-ray batch, 64 coarse -> 63 mids
MLP_ROWS = 2048 * 64                          # one coarse batch of rows
VIEWS, RES, BATCH, POSE_ANGLE = 2, 128, 2048, 20.0
MLP_ERR_MAX, MLP_ERR_MEAN = 2e-2, 2e-3
PDF_OFF_SHARE = 5e-3
PIXEL_MAX, PIXEL_MEAN = 0.1, 1e-2
BWD_DX_MAX, BWD_DX_MEAN, BWD_DW_REL = 0.25, 5e-3, 3e-2
TRAIN_VIEWS, VAL_VIEWS, TRAIN_RES = 8, 2, 64
EPOCHS, STEPS_PER_EPOCH = 2, 8
LOSS_REL, LOSS_STEPS = 0.10, 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of fn, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def mlp_macs(spec) -> int:
    """Multiply-adds per sample of a RenderRayNet (every layer, both heads)."""
    W, P, D, add = spec.width, spec.positions_dim, spec.directions_dim, spec.additional_input_dim
    macs = (P + add) * W
    macs += sum((W + (P + add if i in spec.skips else 0)) * W for i in range(spec.n_layers - 1))
    macs += W * W + W                                            # additional layer, sigma head
    macs += (W + (D if spec.use_directional_input else 0)) * (W // 2)
    macs += (W // 2) * (W // 2) + (W // 2) * 3                   # directional_net_0, rgb head
    return macs


def phase_card() -> str:
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {line}")
    return line


def phase_build() -> None:
    from smpl_nerf_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def phase_sample_pdf(device) -> dict:
    from smpl_nerf_tpu_torch.core import sampling
    from smpl_nerf_tpu_torch.ops import sample_pdf_cuda

    g = torch.Generator(device=device).manual_seed(0)
    bins = torch.sort(1.0 + 3.0 * torch.rand(PDF_R, PDF_K, generator=g, device=device), -1)[0]
    weights = torch.rand(PDF_R, PDF_K - 1, generator=g, device=device)
    weights = torch.where(torch.rand(weights.shape, generator=g, device=device) < 0.3,
                          torch.zeros_like(weights), weights)     # empty space
    got = sample_pdf_cuda.sample_pdf_cuda(bins, weights, PDF_F)
    want = sampling.sample_pdf(bins, weights, PDF_F)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err = float(err.max())
    off_share = float((err > 1e-4).float().mean())
    widest = float((bins[:, 1:] - bins[:, :-1]).max())
    print(f"kernel A sample_pdf R={PDF_R} K={PDF_K} F={PDF_F}: max|err|={max_err:.3e} "
          f"(bound: widest bin {widest:.3e}), share off by >1e-4: {off_share:.3e} "
          f"(bound {PDF_OFF_SHARE})")
    check(bool(torch.isfinite(got).all()), "sample_pdf kernel gave non-finite samples")
    check(max_err <= widest and off_share <= PDF_OFF_SHARE,
          "sample_pdf kernel disagrees with its plain version")
    ms = time_ms(lambda: sample_pdf_cuda.sample_pdf_cuda(bins, weights, PDF_F))
    plain_ms = time_ms(lambda: sampling.sample_pdf(bins, weights, PDF_F))
    bytes_moved = 4 * PDF_R * (PDF_K + (PDF_K - 1) + PDF_F)
    bound_ms = 1e3 * bytes_moved / PEAK_BYTES_PER_S
    print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bytes_moved} B at {PEAK_BYTES_PER_S:.3g} B/s)")
    return {"name": "sample_pdf", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/sample_pdf.cu",
            "replaces": "smpl_nerf_tpu/ops/sample_pdf_pallas.py:83",
            "max_abs_err": max_err, "off_share": off_share, "parity_ok": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


def full_width_net(device, seed: int, additional_input_dim: int = 0):
    """The 8x256 RenderRayNet of both configs (skip 4, L=10/4, bf16) with seeded
    weights and small seeded biases, so that a misplaced bias shows."""
    from smpl_nerf_tpu_torch.models import RenderRayNet

    gen = torch.Generator().manual_seed(seed)
    net = RenderRayNet(n_layers=8, width=256, positions_dim=60, directions_dim=24,
                       additional_input_dim=additional_input_dim, skips=(4,),
                       compute_dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for layer in net.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.bias.copy_(0.05 * torch.randn(layer.bias.shape, generator=gen))
    return net.to(device).requires_grad_(False)


def raw_rows(device, seed: int) -> torch.Tensor:
    """[MLP_ROWS, 6] raw rows: xyz in the scene's box, unit directions."""
    g = torch.Generator(device=device).manual_seed(seed)
    xyz = 3.0 * torch.rand(MLP_ROWS, 3, generator=g, device=device) - 1.5
    dirs = torch.randn(MLP_ROWS, 3, generator=g, device=device)
    return torch.cat([xyz, dirs / dirs.norm(dim=-1, keepdim=True)], -1).contiguous()


def forward_parity(name: str, got, want) -> tuple:
    """Print and check a fused forward against its plain version (B's bounds)."""
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    scale_max, scale_mean = float(want.abs().max()), float(want.abs().mean())
    print(f"  max|err|={max_err:.3e} (rel {max_err / scale_max:.3e}, bound {MLP_ERR_MAX}), "
          f"mean|err|={mean_err:.3e} (rel {mean_err / scale_mean:.3e}, bound {MLP_ERR_MEAN})")
    check(bool(torch.isfinite(got).all()), f"{name} kernel gave non-finite outputs")
    check(max_err <= MLP_ERR_MAX * scale_max and mean_err <= MLP_ERR_MEAN * scale_mean,
          f"{name} kernel disagrees with its plain version")
    return max_err, max_err / scale_max


def phase_fused_mlp(device) -> dict:
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    net = full_width_net(device, seed=1)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    x = raw_rows(device, seed=2)
    with torch.no_grad():
        got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
        want = fused_mlp_v2.reference_forward_raw(spec, flat, x)
    torch.cuda.synchronize()
    print(f"kernel B fused_mlp_v2_fwd N={MLP_ROWS} W={spec.width} layers={spec.n_layers} "
          f"skips={spec.skips} bf16:")
    max_err, rel_err = forward_parity("fused v2", got, want)
    with torch.no_grad():
        ms = time_ms(lambda: fused_mlp_v2.fused_forward_cuda(spec, net, x))
        plain_ms = time_ms(lambda: fused_mlp_v2.reference_forward_raw(spec, flat, x))
    flops = 2 * mlp_macs(spec) * MLP_ROWS
    bytes_moved = MLP_ROWS * (6 + 4) * 4 + sum(p.numel() for p in flat) * 2
    bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_BYTES_PER_S)
    print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({flops:.4g} FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s bf16; {mlp_macs(spec)} MAC/sample)")
    return {"name": "fused_mlp_v2_fwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_v2_fwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp_v2.py:128",
            "max_abs_err": max_err, "rel_err": rel_err, "parity_ok": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def phase_fused_mlp_v1(device) -> dict:
    """Kernel D on pre-encoded rows of the configs/config.txt net: 621-wide
    pose prefix (69 joints x (1 + 2*4)), 60 position and 24 direction columns."""
    from smpl_nerf_tpu_torch.ops import fused_mlp

    net = full_width_net(device, seed=3, additional_input_dim=621)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    g = torch.Generator(device=device).manual_seed(4)
    # encoded columns lie in [-1, 1]; the identity part of the pose prefix too
    x = 2.0 * torch.rand(MLP_ROWS, spec.in_dim, generator=g, device=device) - 1.0
    with torch.no_grad():
        got = fused_mlp.fused_forward_cuda(spec, net, x)
        want = fused_mlp.reference_forward(spec, flat, x)
    torch.cuda.synchronize()
    print(f"kernel D fused_mlp_fwd N={MLP_ROWS} in_dim={spec.in_dim} "
          f"(prefix {spec.additional_input_dim}) W={spec.width} layers={spec.n_layers} "
          f"skips={spec.skips} bf16, {fused_mlp.shared_bytes(spec)} B shared memory per block:")
    max_err, rel_err = forward_parity("fused v1", got, want)
    with torch.no_grad():
        ms = time_ms(lambda: fused_mlp.fused_forward_cuda(spec, net, x))
        plain_ms = time_ms(lambda: fused_mlp.reference_forward(spec, flat, x))
    flops = 2 * mlp_macs(spec) * MLP_ROWS
    bytes_moved = MLP_ROWS * (spec.in_dim + 4) * 4 + sum(p.numel() for p in flat) * 2
    ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * bytes_moved / PEAK_BYTES_PER_S
    print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound by operations "
          f"{ops_ms:.5f} ms ({flops:.4g} FLOP; {mlp_macs(spec)} MAC/sample), by bytes "
          f"{bytes_ms:.5f} ms ({bytes_moved} B; {(spec.in_dim + 4) * 4} B/sample)")
    return {"name": "fused_mlp_fwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_fwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp.py:139",
            "max_abs_err": max_err, "rel_err": rel_err, "parity_ok": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}


def phase_fused_bwd(device) -> dict:
    """Kernel C against autograd through the plain forward, seeded cotangent."""
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    net = full_width_net(device, seed=5)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    x = raw_rows(device, seed=6)
    gen = torch.Generator(device=device).manual_seed(7)
    # the cotangent of a mean loss over the rows
    g = torch.randn(MLP_ROWS, 4, generator=gen, device=device) / MLP_ROWS
    dflat, dx = fused_mlp_v2.fused_backward_cuda(spec, net, x, g)
    want_flat, want_dx = fused_mlp_v2.reference_backward_raw(spec, flat, x, g)
    torch.cuda.synchronize()
    err = (dx - want_dx).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    scale_max, scale_mean = float(want_dx.abs().max()), float(want_dx.abs().mean())
    rels = [float((a - b).norm() / b.norm()) for a, b in zip(dflat, want_flat)]
    print(f"kernel C fused_mlp_v2_bwd N={MLP_ROWS} W={spec.width} layers={spec.n_layers} bf16: "
          f"dX max|err|={max_err:.3e} (rel {max_err / scale_max:.3e}, bound {BWD_DX_MAX}), "
          f"mean|err|={mean_err:.3e} (rel {mean_err / scale_mean:.3e}, bound {BWD_DX_MEAN}); "
          f"dW/db worst ||err||/||plain||={max(rels):.3e} over {len(rels)} tensors "
          f"(bound {BWD_DW_REL})")
    check(all(bool(torch.isfinite(t).all()) for t in (dx, *dflat)),
          "fused v2 backward kernel gave non-finite gradients")
    check(max_err <= BWD_DX_MAX * scale_max and mean_err <= BWD_DX_MEAN * scale_mean
          and max(rels) <= BWD_DW_REL, "fused v2 backward kernel disagrees with its plain version")
    ms = time_ms(lambda: fused_mlp_v2.fused_backward_cuda(spec, net, x, g))
    plain_ms = time_ms(lambda: fused_mlp_v2.reference_backward_raw(spec, flat, x, g), reps=5)
    n_params = sum(p.numel() for p in flat)
    flops = 3 * 2 * mlp_macs(spec) * MLP_ROWS          # recompute, dH chain, dW
    bytes_moved = MLP_ROWS * (6 + 4 + 6) * 4 + n_params * (2 + 4)
    bound_ms = 1e3 * max(flops / PEAK_BF16_FLOPS, bytes_moved / PEAK_BYTES_PER_S)
    print(f"  time: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({flops:.4g} FLOP at {PEAK_BF16_FLOPS:.3g} FLOP/s bf16)")
    return {"name": "fused_mlp_v2_bwd", "route": "cuda",
            "source": "smpl_nerf_tpu_torch/csrc/fused_mlp_v2_bwd.cu",
            "replaces": "smpl_nerf_tpu/ops/fused_mlp_v2.py:157",
            "max_abs_err": max_err, "rel_err": max_err / scale_max,
            "dw_rel_err": max(rels), "parity_ok": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def launch_counts() -> dict:
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda

    return {"sample_pdf": sample_pdf_cuda.launches, "fused_mlp_v2_fwd": fused_mlp_v2.launches,
            "fused_mlp_fwd": fused_mlp.launches, "fused_mlp_v2_bwd": fused_mlp_v2.launches_bwd}


def zero_launch_counts() -> None:
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, sample_pdf_cuda

    sample_pdf_cuda.launches = fused_mlp_v2.launches = 0
    fused_mlp.launches = fused_mlp_v2.launches_bwd = 0


def write_runs(tmp: str, config_file: str, tag: str, kernel_flags: tuple, extra=()) -> tuple:
    """Two run dirs with the same seeded full-width weights: the kernel path
    (--use_fused_mlp, --use_pallas = kernel_flags) and the plain path (0, 0)."""
    from smpl_nerf_tpu_torch import config
    from smpl_nerf_tpu_torch.training import checkpoints, factory

    parser = config.config_parser()
    runs = []
    for name, (fused, pallas) in ((f"{tag}_kernel_run", kernel_flags), (f"{tag}_plain_run", (0, 0))):
        args = parser.parse_args([f"--config={config_file}", f"--use_fused_mlp={fused}",
                                  f"--use_pallas={pallas}", f"--batchsize_val={BATCH}", *extra])
        models, _ = factory.build_models_and_params(args, seed=0, device="cpu")
        run_dir = os.path.join(tmp, name)
        checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()},
                             args, parser)
        runs.append(run_dir)
    return tuple(runs)


def render(run_dir: str, out: str, views: int = VIEWS, res: int = RES):
    from smpl_nerf_tpu_torch.cli import render_path

    t0 = time.perf_counter()
    got = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                            "--number_steps", str(views), "--resolution", str(res),
                            "--human_pose_angle", str(POSE_ANGLE), "--out", out,
                            "--batch_size", str(BATCH), "--device", DEVICE])
    return got, time.perf_counter() - t0


def phase_render(tmp: str, what: str, config_file: str, kernel_flags: tuple, extra: tuple,
                 expected: dict) -> tuple:
    """Render VIEWS views through the kernel path (launch counts set to 0 just
    before, read just after, held against `expected` per batch) and through
    the plain path; compare pixels; time both in turns."""
    kernel_run, plain_run = write_runs(tmp, config_file, what, kernel_flags, extra)
    out = os.path.join(tmp, "views.npy")
    n_batches = -(-VIEWS * RES * RES // BATCH)

    zero_launch_counts()
    kernel_views, first_s = render(kernel_run, out)
    counts = launch_counts()
    print(f"{what}: render_path {VIEWS}x{RES}x{RES} {os.path.basename(config_file)} full width, "
          f"kernel path, {n_batches} batches of {BATCH} rays: launches {counts} in "
          f"{first_s:.2f} s (first call, weight pack included)")
    check(kernel_views.shape == (VIEWS, RES, RES, 3), f"bad render shape {kernel_views.shape}")
    check(bool(np.isfinite(kernel_views).all()), f"non-finite kernel render ({what})")
    for name, per_batch in expected.items():
        check(counts[name] == per_batch * n_batches,
              f"{what}: {name} launched {counts[name]} times, expected {per_batch * n_batches}")

    plain_views, _ = render(plain_run, out)                 # warm-up of the plain path
    check(bool(np.isfinite(plain_views).all()), f"non-finite plain render ({what})")
    diff = abs(kernel_views - plain_views)
    print(f"{what}: kernel path vs plain path pixels: max|diff|={diff.max():.4e} "
          f"(bound {PIXEL_MAX}), mean|diff|={diff.mean():.4e} (bound {PIXEL_MEAN})")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          f"{what}: kernel path and plain path renders disagree")

    seconds = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, sec = render(plain_run if path == "plain" else kernel_run, out)
        seconds[path].append(sec)
    per_view = {k: 1e3 * statistics.mean(v) / VIEWS for k, v in seconds.items()}
    print(f"{what}: ms per {RES}x{RES} view through render_path (host clock, "
          f"plain/kernel/kernel/plain): kernel path {per_view['kernel']:.1f}, "
          f"plain path {per_view['plain']:.1f}")
    return counts, kernel_run


KERNEL_SYMBOLS = (("sample_pdf", "sample_pdf_kernel"),
                  ("fused_mlp_v2_fwd", "fused_mlp_v2_fwd_kernel"),
                  ("fused_mlp_fwd", "fused_mlp_fwd_kernel"),
                  ("fused_mlp_v2_bwd", "fused_mlp_v2_bwd_kernel"))


def profiled(what: str, fn) -> dict:
    """Run fn under torch.profiler: device time by kernel name (top 10), the
    device's busy share of fn's host-clock time, and the device ms per launch
    of each port kernel that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    print(f"profile: {what}, {1e3 * wall_s:.1f} ms host clock, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / 1e4 / wall_s:.1f} %)")
    for key, count, us in rows[:10]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    device_ms = {}
    for name, symbol in KERNEL_SYMBOLS:
        hits = [(c, us) for key, c, us in rows if symbol in key]
        if hits:
            device_ms[name] = sum(us for _, us in hits) / 1e3 / sum(c for c, _ in hits)
    print(f"profile: device ms per launch {device_ms}")
    return device_ms


def make_dataset(tmp: str, teacher_run: str) -> str:
    """Render TRAIN_VIEWS + VAL_VIEWS views of the teacher on a circle, one arm
    angle per view, and write them as a dataset directory (train/ and val/)."""
    from smpl_nerf_tpu_torch.cli import render_path
    from smpl_nerf_tpu_torch.data import datasets
    from smpl_nerf_tpu_torch.render import batched
    from smpl_nerf_tpu_torch.training import checkpoints

    args = checkpoints.load_config(teacher_run)
    n = TRAIN_VIEWS + VAL_VIEWS
    data = render_path.camera_path_data("circle", n, 2.4, -90, 90, TRAIN_RES,
                                        args.human_joints, 0.0)
    angles = np.deg2rad(np.linspace(0.0, 45.0, n, dtype=np.float32))
    for j in args.human_joints:
        data.human_poses[:, int(j)] = angles
    images = batched.render_dataset(args, teacher_run, data, batch_size=BATCH, device=DEVICE)
    check(bool(np.isfinite(images).all()), "non-finite teacher render")
    dataset_dir = os.path.join(tmp, "dataset")
    val = np.arange(n) % (n // VAL_VIEWS) == 1            # spread over the circle
    for split, sel in (("train", ~val), ("val", val)):
        datasets.write_dataset(os.path.join(dataset_dir, split), images[sel],
                               data.camera_transforms[sel], np.pi / 3, data.human_poses[sel])
    print(f"training: dataset of {int((~val).sum())} train and {int(val.sum())} val views "
          f"{TRAIN_RES}x{TRAIN_RES} rendered by the port (pixel mean {images.mean():.4f}, "
          f"std {images.std():.4f})")
    return dataset_dir


def train_run(tmp: str, dataset_dir: str, name: str, fused: int, pallas: int):
    from smpl_nerf_tpu_torch.cli import train as train_cli

    log_dir = os.path.join(tmp, name)
    solver = train_cli.train(
        [f"--config={ARM_ANGLES}", f"--dataset_dir={dataset_dir}", "--sigma_noise_std=0",
         f"--num_epochs={EPOCHS}", f"--steps_per_epoch={STEPS_PER_EPOCH}",
         f"--batchsize_val={BATCH}", "--seed=1", f"--use_fused_mlp={fused}",
         f"--use_pallas={pallas}"], log_dir=log_dir, device=DEVICE)
    return solver, log_dir


def phase_training(tmp: str, teacher_run: str) -> tuple:
    from smpl_nerf_tpu_torch.data import datasets

    dataset_dir = make_dataset(tmp, teacher_run)
    steps = EPOCHS * STEPS_PER_EPOCH
    val_batches = EPOCHS * -(-VAL_VIEWS * TRAIN_RES * TRAIN_RES // BATCH)

    zero_launch_counts()
    solver, kernel_dir = train_run(tmp, dataset_dir, "train_kernel", 2, 1)
    counts = launch_counts()
    kernel_loss = solver.history["step_loss"]
    print(f"training: cli.train arm_angles.txt full width, kernel path, {steps} steps of "
          f"{BATCH} rays + {val_batches} validation batches: launches {counts}")
    # per step 1 x A, 2 x B, 2 x C (coarse and fine net); per validation batch 1 x A, 2 x B
    expected = {"sample_pdf": steps + val_batches, "fused_mlp_v2_fwd": 2 * (steps + val_batches),
                "fused_mlp_v2_bwd": 2 * steps, "fused_mlp_fwd": 0}
    for name, want in expected.items():
        check(counts[name] == want, f"training: {name} launched {counts[name]} times, "
                                    f"expected {want}")
    plain_solver, _ = train_run(tmp, dataset_dir, "train_plain", 0, 0)
    plain_loss = plain_solver.history["step_loss"]
    print("training: loss per step, kernel path: " + " ".join(f"{v:.5f}" for v in kernel_loss))
    print("training: loss per step, plain path:  " + " ".join(f"{v:.5f}" for v in plain_loss))
    for what, losses, sol in (("kernel", kernel_loss, solver), ("plain", plain_loss, plain_solver)):
        check(len(losses) == steps and bool(np.isfinite(losses).all())
              and bool(np.isfinite(sol.history["val_loss"]).all()),
              f"training: non-finite loss on the {what} path")
        check(np.mean(losses[-4:]) < losses[0],
              f"training: the {what} path's loss did not fall ({losses[0]} -> {losses[-4:]})")
    rel = max(abs(k - q) / q for k, q in zip(kernel_loss[:LOSS_STEPS], plain_loss[:LOSS_STEPS]))
    print(f"training: kernel vs plain loss over the first {LOSS_STEPS} steps: "
          f"max relative difference {rel:.3e} (bound {LOSS_REL})")
    check(rel <= LOSS_REL, "training: kernel path and plain path losses disagree")

    for required in ("config.txt", "model_coarse.pt", "model_fine.pt", "model_warp_field.pt",
                     "val_curve.json", "train_state.pt", os.path.join("best", "model_coarse.pt")):
        check(os.path.exists(os.path.join(kernel_dir, required)),
              f"training: the run dir lacks {required}")
    view, _ = render(kernel_dir, os.path.join(tmp, "trained.npy"), views=1, res=TRAIN_RES)
    check(view.shape == (1, TRAIN_RES, TRAIN_RES, 3) and bool(np.isfinite(view).all()),
          "training: the saved run does not render")

    ms = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        sol, _ = train_run(tmp, dataset_dir, f"train_{path}_timed",
                           *((2, 1) if path == "kernel" else (0, 0)))
        ms[path].append(1e3 * statistics.median(sol.step_seconds[1:]))
    print(f"training: ms per step of {BATCH} rays (host clock, synchronised, median without "
          f"the first step; plain/kernel/kernel/plain): kernel path "
          f"{statistics.mean(ms['kernel']):.1f}, plain path {statistics.mean(ms['plain']):.1f}")

    # one step of the kernel path under the profiler
    data = datasets.load_dataset(os.path.join(dataset_dir, "train"), "smpl_nerf")
    arrays = solver.device_arrays(data, "smpl_nerf")
    batch = solver.gather(arrays, np.arange(BATCH))
    solver.train_step(batch, solver.generator)
    device_ms = profiled("one kernel-path training step",
                         lambda: solver.train_step(batch, solver.generator))
    return counts, device_ms


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on the card only")
    if not os.path.isdir(os.path.join(REPO, "smpl_nerf_tpu_torch")):
        fail(f"no smpl_nerf_tpu_torch package beside {__file__}: run it from the checkout")
    sys.path.insert(0, REPO)
    from smpl_nerf_tpu_torch._platform import resolve_device

    device = resolve_device("cuda")
    card = phase_card()
    phase_build()
    kernels = [phase_sample_pdf(device), phase_fused_mlp(device), phase_fused_mlp_v1(device),
               phase_fused_bwd(device)]
    paths, device_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        paths["smpl_nerf_render"], kernel_run = phase_render(
            tmp, "smpl_nerf", ARM_ANGLES, (2, 1), (),
            {"sample_pdf": 1, "fused_mlp_v2_fwd": 2, "fused_mlp_fwd": 0, "fused_mlp_v2_bwd": 0})
        out = os.path.join(tmp, "views.npy")
        device_ms["smpl_nerf_render"] = profiled(
            f"kernel-path smpl_nerf render of {VIEWS} views", lambda: render(kernel_run, out))
        paths["append_render"], append_run = phase_render(
            tmp, "append_smpl_params", APPEND_CONFIG, (1, 1), ("--run_fine=1",),
            {"sample_pdf": 1, "fused_mlp_fwd": 2, "fused_mlp_v2_fwd": 0, "fused_mlp_v2_bwd": 0})
        device_ms["append_render"] = profiled(
            f"kernel-path append_smpl_params render of {VIEWS} views",
            lambda: render(append_run, out))
        paths["train"], device_ms["train"] = phase_training(tmp, kernel_run)
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']} was launched on no main path")
        k["device_ms_by_path"] = {path: ms[k["name"]] for path, ms in device_ms.items()
                                  if k["name"] in ms}
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
