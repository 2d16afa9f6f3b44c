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
     least time the card could take for the same work;
  4. the slice: `cli/render_path` on a 2-view 128x128 circle of a full-width
     configs/arm_angles.txt smpl_nerf run (seeded weights, --use_fused_mlp=2,
     --use_pallas=1, 2048-ray batches), with the kernels' launch counts set to
     0 just before and read just after; then the same views through the plain
     path (--use_fused_mlp=0 --use_pallas=0), the pixel difference between
     the two, and ms per view of both; one kernel-path render under
     torch.profiler gives the device time by kernel and the device's busy share;
  5. one JSON line of per-kernel results;
  6. last line: {"ok": true, "device": {"platform": "gpu", ...}}.

Tolerances, each with its reason:
  * sample_pdf (kernel A): the kernel's warp-shuffle cumsum adds in another
    order than torch.cumsum, so where u meets a cdf entry to float precision
    the sample lands one bin over. Every sample must lie within one bin width
    (the widest bin of its input) and at most 0.5% may differ by more than 1e-4.
  * fused v2 forward (kernel B): both sides round the same values to bf16 at
    the same places and accumulate in float32, but in another order, which can
    flip one bf16 rounding (2^-8 relative) that carries through later layers:
    max |err| <= 2e-2 * max |plain| and mean |err| <= 2e-3 * mean |plain|.
  * kernel path vs plain path renders: the plain path rounds like flax's
    bf16 Dense (product and bias rounded to bf16), the kernel like the TPU
    kernel (float32 bias, bf16 after each activation), and the fine samples
    can flip a bin: max pixel difference <= 0.1, mean <= 1e-2.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ARM_ANGLES = os.path.join(REPO, "configs", "arm_angles.txt")

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

PDF_R, PDF_K, PDF_F = 2048, 63, 128          # one 2048-ray batch, 64 coarse -> 63 mids
MLP_ROWS = 2048 * 64                          # one coarse batch of rows
VIEWS, RES, BATCH, POSE_ANGLE = 2, 128, 2048, 20.0
MLP_ERR_MAX, MLP_ERR_MEAN = 2e-2, 2e-3
PDF_OFF_SHARE = 5e-3
PIXEL_MAX, PIXEL_MEAN = 0.1, 1e-2


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


def full_width_net(device, seed: int):
    """The arm_angles.txt RenderRayNet (8x256, skip 4, L=10/4, bf16) with seeded
    weights and small seeded biases, so that a misplaced bias shows."""
    from smpl_nerf_tpu_torch.models import RenderRayNet

    gen = torch.Generator().manual_seed(seed)
    net = RenderRayNet(n_layers=8, width=256, positions_dim=60, directions_dim=24,
                       skips=(4,), compute_dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        for layer in net.modules():
            if isinstance(layer, torch.nn.Linear):
                layer.bias.copy_(0.05 * torch.randn(layer.bias.shape, generator=gen))
    return net.to(device).requires_grad_(False)


def phase_fused_mlp(device) -> dict:
    from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2

    net = full_width_net(device, seed=1)
    spec = fused_mlp.spec_from_model(net)
    flat = fused_mlp.flatten_params(spec, net)
    g = torch.Generator(device=device).manual_seed(2)
    xyz = 3.0 * torch.rand(MLP_ROWS, 3, generator=g, device=device) - 1.5
    dirs = torch.randn(MLP_ROWS, 3, generator=g, device=device)
    x = torch.cat([xyz, dirs / dirs.norm(dim=-1, keepdim=True)], -1).contiguous()
    with torch.no_grad():
        got = fused_mlp_v2.fused_forward_cuda(spec, net, x)
        want = fused_mlp_v2.reference_forward_raw(spec, flat, x)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    scale_max, scale_mean = float(want.abs().max()), float(want.abs().mean())
    print(f"kernel B fused_mlp_v2_fwd N={MLP_ROWS} W={spec.width} layers={spec.n_layers} "
          f"skips={spec.skips} bf16: max|err|={max_err:.3e} (rel {max_err / scale_max:.3e}, "
          f"bound {MLP_ERR_MAX}), mean|err|={mean_err:.3e} (rel {mean_err / scale_mean:.3e}, "
          f"bound {MLP_ERR_MEAN})")
    check(bool(torch.isfinite(got).all()), "fused v2 kernel gave non-finite outputs")
    check(max_err <= MLP_ERR_MAX * scale_max and mean_err <= MLP_ERR_MEAN * scale_mean,
          "fused v2 kernel disagrees with its plain version")
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
            "max_abs_err": max_err, "rel_err": max_err / scale_max, "parity_ok": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "operations",
            "library_ms": None}


def write_runs(tmp: str) -> tuple:
    """Two run dirs with the same seeded full-width weights: the kernel path
    (--use_fused_mlp=2 --use_pallas=1) and the plain path (0, 0)."""
    from smpl_nerf_tpu_torch import config
    from smpl_nerf_tpu_torch.training import checkpoints, factory

    parser = config.config_parser()
    runs = []
    for name, fused, pallas in (("kernel_run", 2, 1), ("plain_run", 0, 0)):
        args = parser.parse_args([f"--config={ARM_ANGLES}", f"--use_fused_mlp={fused}",
                                  f"--use_pallas={pallas}", f"--batchsize_val={BATCH}"])
        models, _ = factory.build_models_and_params(args, seed=0, device="cpu")
        run_dir = os.path.join(tmp, name)
        checkpoints.save_run(run_dir, {k: m.state_dict() for k, m in models.items()},
                             args, parser)
        runs.append(run_dir)
    return tuple(runs)


def render(run_dir: str, out: str):
    from smpl_nerf_tpu_torch.cli import render_path

    t0 = time.perf_counter()
    views = render_path.main(["--run_dir", run_dir, "--camera_path", "circle",
                              "--number_steps", str(VIEWS), "--resolution", str(RES),
                              "--human_pose_angle", str(POSE_ANGLE), "--out", out,
                              "--batch_size", str(BATCH), "--device", "cuda"])
    return views, time.perf_counter() - t0


def phase_slice(tmp: str) -> dict:
    from smpl_nerf_tpu_torch.ops import fused_mlp_v2, sample_pdf_cuda

    kernel_run, plain_run = write_runs(tmp)
    out = os.path.join(tmp, "views.npy")
    n_batches = -(-VIEWS * RES * RES // BATCH)

    sample_pdf_cuda.launches = 0
    fused_mlp_v2.launches = 0
    kernel_views, first_s = render(kernel_run, out)
    counts = {"sample_pdf": sample_pdf_cuda.launches,
              "fused_mlp_v2_fwd": fused_mlp_v2.launches}
    print(f"slice: render_path {VIEWS}x{RES}x{RES} arm_angles.txt full width, kernel path, "
          f"{n_batches} batches of {BATCH} rays: launches {counts} in {first_s:.2f} s "
          "(first call, weight pack included)")
    check(kernel_views.shape == (VIEWS, RES, RES, 3), f"bad render shape {kernel_views.shape}")
    check(bool(torch.isfinite(torch.from_numpy(kernel_views)).all()), "non-finite kernel render")
    check(counts["sample_pdf"] == n_batches,
          f"sample_pdf launched {counts['sample_pdf']} times, expected {n_batches}")
    check(counts["fused_mlp_v2_fwd"] == 2 * n_batches,
          f"fused v2 launched {counts['fused_mlp_v2_fwd']} times, expected {2 * n_batches}")

    plain_views, _ = render(plain_run, out)                 # warm-up of the plain path
    check(bool(torch.isfinite(torch.from_numpy(plain_views)).all()), "non-finite plain render")
    diff = abs(kernel_views - plain_views)
    print(f"slice: kernel path vs plain path pixels: max|diff|={diff.max():.4e} "
          f"(bound {PIXEL_MAX}), mean|diff|={diff.mean():.4e} (bound {PIXEL_MEAN})")
    check(float(diff.max()) <= PIXEL_MAX and float(diff.mean()) <= PIXEL_MEAN,
          "kernel path and plain path renders disagree")

    seconds = {"plain": [], "kernel": []}
    for path in ("plain", "kernel", "kernel", "plain"):
        _, s = render(plain_run if path == "plain" else kernel_run, out)
        seconds[path].append(s)
    per_view = {k: 1e3 * statistics.mean(v) / VIEWS for k, v in seconds.items()}
    print(f"slice: ms per {RES}x{RES} view through render_path (host clock, "
          f"plain/kernel/kernel/plain): kernel path {per_view['kernel']:.1f}, "
          f"plain path {per_view['plain']:.1f}")
    return counts, profile_render(kernel_run, out)


def profile_render(run_dir: str, out: str) -> dict:
    """One kernel-path render under torch.profiler: device time by kernel name
    (top 10), the device's busy share of the host-clock render, and the device
    ms per launch of each port kernel (None where the profiler saw no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = render(run_dir, out)
    # device-side events only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    print(f"profile: kernel-path render of {VIEWS} views, {1e3 * wall_s:.1f} ms host clock, "
          f"device busy {busy_us / 1e3:.1f} ms ({busy_us / 1e4 / wall_s:.1f} %)")
    for key, count, us in rows[:10]:
        print(f"  {us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    device_ms = {}
    for name, symbol in (("sample_pdf", "sample_pdf_kernel"),
                         ("fused_mlp_v2_fwd", "fused_mlp_v2_fwd_kernel")):
        hits = [(c, us) for key, c, us in rows if symbol in key]
        device_ms[name] = (sum(us for _, us in hits) / 1e3 / sum(c for c, _ in hits)
                           if hits else None)
    print(f"profile: device ms per launch {device_ms}")
    return device_ms


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
    kernels = [phase_sample_pdf(device), phase_fused_mlp(device)]
    with tempfile.TemporaryDirectory() as tmp:
        counts, device_ms = phase_slice(tmp)
    for k in kernels:
        k["launches"] = counts[k["name"]]
        k["device_ms_in_render"] = device_ms[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
