"""Seconds of set-up spent building or loading the kernels: the union of the
program's `ops.load` spans (ops/_build.py) that end before the device-only
stretch opens; port_bench/spans.py."""
from port_bench import spans


def read(rec):
    if rec is None or "spans" not in rec or rec["spans_dropped"]:
        return None
    lo = rec["stretch_ns"][0]
    return spans.union_s((s, e) for name, s, e, _, _ in rec["spans"]
                         if name == "ops.load" and e is not None and e <= lo)
