"""Device idle time of the device-only stretch whose innermost program span
is `pass.lbs` (the SMPL-driven families' in-step LBS, warps and per-ray
gathers), as a share of the stretch; port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.idle_under_pct(rec, "train", ("pass.lbs",))
