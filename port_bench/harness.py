"""The benchmark of smpl_nerf_tpu_torch, driven by data.

    python port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so a later change adds a configuration, a
traffic mix, a traffic kind, a cell or a per-layer metric by adding files and
BENCHMARK.json entries:

* BENCHMARK.json `workloads[name]` names its configuration and traffic;
* a configuration is the file its `configs` entry names
  (port_bench/configs/<name>.json): the program's flags as run, the source,
  what was reduced and what the benchmark assumed;
* a traffic mix is port_bench/traffic/<traffic>.json, whose `kind` names the
  generator port_bench/traffic/<kind>.py (`run(run) -> Outcome`);
* a cell is port_bench/cells/<name>.json: the limits of its correctness check,
  and whether its weights start with the density centred (scene.make_weights);
* a per-layer metric is port_bench/metrics/<metric>.py (`read(record)`,
  None where the traced window holds nothing to read).

A run warms up inside set-up, measures one window, reads the device peak,
frees the program's state and then checks what the window produced against
the plain reference (reference.py, checks.py). With --trace 1 the window is
shorter and traced (trace.py), and the per-layer metrics are reported.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "smpl_nerf_tpu")
CACHE_DIR = CHECKOUT / "build" / "port_bench_cache"


def set_cache_dirs() -> None:
    """Every cache the run could write lies at a fixed path in the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE_DIR / sub)


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Workload:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic mix's parameters
    cell: dict            # the cell file
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def flags(self) -> dict:
        return self.config["flags"]

    def generator(self):
        kind = self.traffic["kind"]
        return load_module(BENCH_DIR / "traffic" / f"{kind}.py", f"port_bench_traffic_{kind}")


def resolve(name: str, root: Path = CHECKOUT) -> Workload:
    """The workload `name` of root/BENCHMARK.json with every file it names."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    bench_dir = root / BENCH_DIR.name
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    cell = load_json(bench_dir / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if m.get("workloads") is None or name in m["workloads"]]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    return Workload(name, int(w["chips"]), config, traffic, cell, e2e, per_layer)


def flag_argv(flags: dict) -> list:
    argv = ["--config="]          # no config file: every flag is in the configuration
    for key, value in flags.items():
        for v in (value if isinstance(value, list) else [value]):
            argv += [f"--{key}", str(v)]
    return argv


@dataclasses.dataclass
class Run:
    """One run of a cell, as the traffic generator sees it."""
    workload: Workload
    seed: int
    seconds: float
    trace: bool
    device: object                      # torch.device
    t0: float                           # perf_counter at process start
    fault: Optional[str] = None         # a planted fault (tests, calibrate.py)
    steps_only: bool = False            # calibrate.py: stop once the checked work is done
    control: bool = False               # calibrate.py: also read the fp8 control
    overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def flags(self) -> dict:
        return {**self.workload.flags, **self.overrides.get("flags", {})}

    @property
    def params(self) -> dict:
        return {**self.workload.traffic, **self.overrides.get("traffic", {})}

    def program_args(self):
        from port_bench import scene
        from smpl_nerf_tpu_torch import config as config_mod

        argv = flag_argv(self.flags) + ["--seed", str(scene.program_seed(self.seed))]
        return config_mod.config_parser().parse_args(argv)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a traffic generator hands back."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: Dict[str, float]
    record: Optional[dict] = None       # the traced window, for the metric readers
    summary: object = None              # trace.DeviceSummary of the traced window
    breakdown: Optional[dict] = None
    window_s: float = 0.0
    memory_peak_bytes: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    control_readings: Optional[Dict[str, float]] = None
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def launch_counts() -> Dict[str, int]:
    """The program's own launch counters (ops/*.launches)."""
    from smpl_nerf_tpu_torch.ops import (expert_tiles, fused_mlp, fused_mlp_v2, relu_matmul,
                                         sample_pdf_cuda)

    return {"sample_pdf": sample_pdf_cuda.launches, "fused_mlp_v2_fwd": fused_mlp_v2.launches,
            "fused_mlp_v2_bwd": fused_mlp_v2.launches_bwd, "fused_mlp_fwd": fused_mlp.launches,
            "expert_tiles": expert_tiles.launches, "relu_matmul": relu_matmul.launches}


def free_program() -> None:
    """Return the memory of the program's dropped state, so that the
    reference runs in free memory."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,clocks.mem,power.limit,"
             "power.draw,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def per_layer_values(w: Workload, outcome: Outcome) -> Dict[str, dict]:
    """The per-layer metrics of the cell that its readers find in the record."""
    out = {}
    for entry in w.per_layer:
        name = entry["name"]
        reader = load_module(BENCH_DIR / "metrics" / f"{name}.py", f"port_bench_metric_{name}")
        value = reader.read(outcome.record)
        if value is not None:
            out[name] = {"value": value, "unit": entry["unit"]}
    return out


def run_cell(run: Run) -> tuple:
    """(Outcome, checks) of one run: the traffic, then the comparison."""
    from port_bench import checks

    outcome = run.workload.generator().run(run)
    verdict = checks.judge(outcome.readings, run.workload.cell["limits"])
    return outcome, verdict


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    set_cache_dirs()
    import torch

    w = resolve(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < w.chips:
        print(f"{a.workload} needs {w.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    err = sys.stderr
    print(f"card: {card_line()}", file=err)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", file=err)
    run = Run(w, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0), t0)
    outcome, verdict = run_cell(run)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded modules of JAX or the JAX package: {bad}", file=err)
        return 3
    print(f"launches in the window: {json.dumps(outcome.launches)}", file=err)
    print(f"memory_peak_bytes: {outcome.memory_peak_bytes}", file=err)
    for key, value in outcome.notes.items():
        print(f"{key}: {value}", file=err)
    if a.trace:
        metrics = per_layer_values(w, outcome)
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in w.end_to_end}
    ok = (outcome.failed == 0 and all(c["ok"] for c in verdict.values())
          and all(math.isfinite(m["value"]) for m in metrics.values()))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": ok, "attempted": outcome.attempted, "failed": outcome.failed,
              "metrics": metrics, "device": device}
    if a.trace:
        device["busy_s"] = outcome.summary.busy_s
        device["window_s"] = outcome.window_s
        result["breakdown"] = outcome.breakdown
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in verdict.items()}
    for k, c in verdict.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), flush=True)
    return 0
