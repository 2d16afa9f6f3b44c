"""Rows a launch of kernel B (ops/fused_mlp_v2.py) took in the window of
views: the program's `fused_mlp_v2.rows` counter over its `launches`, both
counted over the device-only stretch."""


def read(rec):
    if rec is None or rec.get("kind") != "views":
        return None
    rows = (rec.get("rows") or {}).get("fused_mlp_v2_fwd")   # none: no counter, or untraced
    launches = rec["launches"].get("fused_mlp_v2_fwd", 0)
    return rows / launches if rows is not None and launches else None
