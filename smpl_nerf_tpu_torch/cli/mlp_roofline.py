"""MLP roofline microbenchmark (counterpart of scripts/mlp_roofline.py).

    python mlp_roofline_torch.py [--part chain|fusedmlp|all] [--rows 131072]
                                 [--reps 20] [--depth 8] [--device cuda]

Part `chain`: the bare `depth` x W relu-matmul chain on `rows` rows in bf16,
W in {256, 512, 1024}: the library (`torch.relu(x @ w)` per layer) against a
chain of launches of the hand-written kernel ops/relu_matmul.py, which are
also compared value by value.

Part `fusedmlp`: the real RenderRayNet (8 layers, skip 4, 60 + 24 encoded
inputs, bf16) forward and forward+backward at W in {256, 1024}: the plain
module against fused v1 (ops/fused_mlp.py) and fused v2
(ops/fused_mlp_v2.py, in-kernel encoding; its backward is a kernel too). A
width the fused kernels refuse is reported as refused with their reason, and
the run goes on to the next: a stated limit, not a fallback.

On the card a time is the median over `--reps` of CUDA-event times around one
call, after a warm-up and a synchronise; records carry it as `ms` with the
card's name and power limit. With `--device cpu` (the tests) every wrapper
runs its plain version and records carry a host-clock `host_ms` instead,
which says nothing about the card. One JSON line per measurement goes to
stdout, a table to stderr.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from smpl_nerf_tpu_torch._platform import DEFAULT_DEVICE, resolve_device
from smpl_nerf_tpu_torch.models import RenderRayNet
from smpl_nerf_tpu_torch.ops import fused_mlp, fused_mlp_v2, relu_matmul

CHAIN_WIDTHS = (256, 512, 1024)
FUSED_WIDTHS = (256, 1024)


def _stderr(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line(device: torch.device) -> Optional[str]:
    """'name, power limit' of the card as nvidia-smi reports it; None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn: Callable, reps: int, device: torch.device, warmup: int = 2) -> float:
    """Median time of one call of fn in ms: CUDA events on the card, the host
    clock on the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _emit(records: List[dict], record: dict, device: torch.device, card: Optional[str]) -> None:
    record = {**record, "device": device.type, "card": card}
    records.append(record)
    print(json.dumps(record), flush=True)


def _time_key(device: torch.device) -> str:
    return "ms" if device.type == "cuda" else "host_ms"


# ---------------------------------------------------------------- part chain

def bench_chain(widths: Sequence[int], n_rows: int, depth: int, reps: int,
                device: torch.device, card: Optional[str]) -> List[dict]:
    records: List[dict] = []
    key = _time_key(device)
    for W in widths:
        gen = torch.Generator().manual_seed(0)
        ws = [(0.05 * torch.randn((W, W), generator=gen)).to(torch.bfloat16).to(device)
              for _ in range(depth)]
        x = torch.randn((n_rows, W), generator=gen).to(torch.bfloat16).to(device)
        flops = 2 * n_rows * W * W * depth

        def library_chain(h=x):
            for w in ws:
                h = torch.relu(h @ w)
            return h

        def kernel_chain(h=x):
            for w in ws:
                h = relu_matmul.relu_matmul(h, w)
            return h

        with torch.no_grad():
            out = kernel_chain().float()
            diff = float((out - library_chain().float()).abs().max())
            # a chain that died to zeros agrees trivially; the largest output
            # is the scale a difference is read against
            out_mean, out_max = float(out.abs().mean()), float(out.abs().max())
            for name, fn in (("library", library_chain), ("kernel", kernel_chain)):
                ms = median_ms(fn, reps, device)
                tfs = flops / (ms * 1e-3) / 1e12
                _stderr(f"chain W={W:4d} {name:8s}: {ms:8.3f} ms  {tfs:7.1f} TFLOP/s "
                        f"(max |kernel - library| {diff:.3e})")
                _emit(records, {"bench": "chain", "impl": name, "width": W, "rows": n_rows,
                                "depth": depth, key: ms, "tflops_per_sec": tfs,
                                "max_abs_diff_kernel_library": diff,
                                "mean_abs_output": out_mean, "max_abs_output": out_max},
                      device, card)
    return records


# -------------------------------------------------------------- part fusedmlp

def _fused_flops_fwd(spec: fused_mlp.MlpSpec, n_rows: int) -> int:
    W, pos_in = spec.width, spec.pos_block
    dims = [(pos_in, W)] + [(W + (pos_in if i in spec.skips else 0), W)
                            for i in range(spec.n_layers - 1)]
    dims += [(W, W), (W, 1), (W + spec.directions_dim, W // 2), (W // 2, W // 2), (W // 2, 3)]
    return 2 * n_rows * sum(a * b for a, b in dims)


def bench_fused_mlp(widths: Sequence[int], n_rows: int, reps: int, device: torch.device,
                    card: Optional[str]) -> List[dict]:
    records: List[dict] = []
    key = _time_key(device)
    for W in widths:
        gen = torch.Generator().manual_seed(0)
        net = RenderRayNet(width=W, compute_dtype=torch.bfloat16, generator=gen).to(device)
        spec = fused_mlp.spec_from_model(net)
        x_enc = torch.randn((n_rows, spec.in_dim), generator=gen).to(device)
        x_raw = torch.randn((n_rows, fused_mlp_v2.raw_in_dim(spec)), generator=gen).to(device)
        flops_fwd = _fused_flops_fwd(spec, n_rows)
        on_card = device.type == "cuda"
        impls = {
            "plain": (lambda x: net(x), x_enc, ""),
            "fused_v1": (lambda x: fused_mlp.fused_apply(spec, net, x), x_enc,
                         fused_mlp.kernel_supports(spec) if on_card else ""),
            "fused_v2": (lambda x: fused_mlp_v2.fused_apply_raw(spec, net, x), x_raw,
                         fused_mlp_v2.kernel_supports(spec) if on_card else ""),
        }
        for name, (apply_fn, x, refused) in impls.items():
            if refused:
                _stderr(f"fusedmlp W={W:4d} {name:8s}: refused: {refused}")
                _emit(records, {"bench": "fusedmlp", "impl": name, "width": W, "rows": n_rows,
                                "refused": refused}, device, card)
                continue

            def fwd(f=apply_fn, x=x):
                with torch.no_grad():
                    return f(x)

            def fwdbwd(f=apply_fn, x=x):
                net.zero_grad(set_to_none=True)
                f(x).sum().backward()

            t_f = median_ms(fwd, reps, device)
            t_fb = median_ms(fwdbwd, reps, device)
            net.zero_grad(set_to_none=True)
            _stderr(f"fusedmlp W={W:4d} {name:8s}: fwd {t_f:8.3f} ms "
                    f"({flops_fwd / t_f / 1e9:6.1f} TFLOP/s)   fwd+bwd {t_fb:8.3f} ms "
                    f"({3 * flops_fwd / t_fb / 1e9:6.1f} TFLOP/s)")
            _emit(records, {"bench": "fusedmlp", "impl": name, "width": W, "rows": n_rows,
                            f"fwd_{key}": t_f, f"fwdbwd_{key}": t_fb,
                            "fwd_tflops_per_sec": flops_fwd / t_f / 1e9,
                            "fwdbwd_tflops_per_sec": 3 * flops_fwd / t_fb / 1e9}, device, card)
    return records


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--part", choices=["chain", "fusedmlp", "all"], default="all")
    ap.add_argument("--rows", type=int, default=131072,
                    help="rows of the megabatch (default: 2048 rays x 64 samples)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--widths", default="",
                    help="comma list of widths (default: 256,512,1024 for chain, "
                         "256,1024 for fusedmlp)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    widths = tuple(int(w) for w in args.widths.split(",") if w)
    _stderr(f"device={device} card={card} rows={args.rows}")
    records: List[dict] = []
    if args.part in ("chain", "all"):
        records += bench_chain(widths or CHAIN_WIDTHS, args.rows, args.depth, args.reps,
                               device, card)
    if args.part in ("fusedmlp", "all"):
        records += bench_fused_mlp(widths or FUSED_WIDTHS, args.rows, args.reps, device, card)
    return records


if __name__ == "__main__":
    main()
