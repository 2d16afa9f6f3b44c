"""Device idle time of the device-only stretch whose innermost program span
lies under `render.batch` (a batch of render_rays_batched, its pipeline
passes included), as a share of the stretch; port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.idle_under_pct(rec, "views", ("render.batch",))
