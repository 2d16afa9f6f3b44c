"""The share of the device-only stretch's idle time that no span names: its
innermost program span is the view's container `render.view`, or there is
none (the harness's loop between views); port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.idle_unnamed_pct(rec, "views", "render.view")
