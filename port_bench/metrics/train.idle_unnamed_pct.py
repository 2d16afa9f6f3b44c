"""The share of the device-only stretch's idle time that no span names: its
innermost program span is the epoch's container `solver.epoch`, or there is
none. What the spans fail to name, and the check that the program's clock
and the profiler's agree; port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.idle_unnamed_pct(rec, "train", "solver.epoch")
