"""Device idle time of the device-only stretch whose innermost program span
lies under `solver.forward` (the loss function's pipeline passes), as a
share of the stretch; port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.idle_under_pct(rec, "train", ("solver.forward",))
