"""Host ms of one batch of a view in the device-only stretch: the median of
the program's `render.batch` spans (render/batched.py), port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.median_ms(rec, "views", "render.batch")
