"""The whole render's share of the card's bf16 peak: the forward FLOPs of
every net over every view's rays, over the window's seconds (counts.py)."""
from port_bench import counts


def read(rec):
    if rec is None or rec["kind"] != "views":
        return None
    flops = counts.forward_flops(rec["flags"], rec["eval_rays"])
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
