"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 1,2,3] [--faults half_batch,altered] [--out FILE]

For each seed, one run of the cell's traffic as far as its checked work
(the first three training steps, or `sample_views` views) and the
comparison with the reference: the program's readings. For each --control
seed also the control's (the reference in float8 put in the program's
place), and for each fault the readings of the program with that fault
planted. All in one process, so set-up is paid once for the imports. Prints
one JSON line per run and a summary: per number, the largest program
reading, the smallest control reading and the smallest reading of each fault.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import harness  # noqa: E402


def _ints(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--flags", default="",
                   help="key=value,... flags over the configuration's (a witness run)")
    a = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    w = harness.resolve(a.workload)
    flags = {}
    for item in filter(None, a.flags.split(",")):
        key, value = item.split("=")
        flags[key] = type(w.flags[key])(value)
    device = torch.device(a.device)
    rows = []

    def one(seed, fault=None, control=False):
        r = harness.Run(w, seed, 0.0, False, device, time.perf_counter(), fault=fault,
                        steps_only=True, control=control, overrides={"flags": flags})
        t = time.perf_counter()
        outcome, _ = harness.run_cell(r)
        row = {"seed": seed, "fault": fault, "readings": outcome.readings,
               "control": outcome.control_readings, "seconds": time.perf_counter() - t,
               **outcome.notes}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in a.seeds:
        one(seed, control=seed in a.control)
    for fault in [f for f in a.faults.split(",") if f]:
        for seed in a.control or a.seeds[:3]:
            one(seed, fault=fault)
    names = list(rows[0]["readings"])
    program = [r["readings"] for r in rows if r["fault"] is None]
    control = [r["control"] for r in rows if r["control"]]
    summary = {"workload": a.workload, "card": harness.card_line() if a.device == "cuda" else "cpu",
               "program_max": {n: max(x[n] for x in program) for n in names},
               "control_min": {n: min(x[n] for x in control) for n in names} if control else None,
               "faults_min": {f: {n: min(r["readings"][n] for r in rows if r["fault"] == f)
                                  for n in names}
                              for f in {r["fault"] for r in rows if r["fault"]}}}
    print(json.dumps(summary), flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
