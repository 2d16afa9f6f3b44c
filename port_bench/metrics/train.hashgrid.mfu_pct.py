"""The whole training window's share of the card's bf16 peak on hash-grid
fields: every step's forward + backward FLOPs of the two fields' MLPs, their
encodings' blend and the warp field, and each epoch's validation forward,
over the window's seconds (port_bench/counts_hashgrid.py). None for a
configuration without hash-grid fields."""
from port_bench import counts_hashgrid


def read(rec):
    if rec is None or rec.get("kind") != "train":
        return None
    f = rec["flags"]
    if int(f.get("grid_encoding", 0)) != 2 or "hash_grid" not in f:
        return None
    flops = (counts_hashgrid.train_flops(f, rec["steps"] * rec["batch"])
             + counts_hashgrid.forward_flops(f, rec["eval_rays"]))
    return 100.0 * flops / (rec["window_s"] * counts_hashgrid.PEAK_BF16_FLOPS)
