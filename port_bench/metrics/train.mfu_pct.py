"""The whole training window's share of the card's bf16 peak: every step's
forward + backward FLOPs of the coarse, fine and warp nets, and each
epoch's validation forward, over the window's seconds (counts.py)."""
from port_bench import counts


def read(rec):
    if rec is None or rec["kind"] != "train":
        return None
    f = rec["flags"]
    flops = (counts.train_flops(f, rec["steps"] * rec["batch"])
             + counts.forward_flops(f, rec["eval_rays"]))
    return 100.0 * flops / (rec["window_s"] * counts.PEAK_BF16_FLOPS)
