"""Kernel C (ops/fused_mlp_v2.py, csrc/fused_mlp_v2_bwd.cu, three kernels a
launch) against its bound: 3x the forward FLOPs of the nets it took, at the
bf16 peak, over its device time by kernel name. Read only where C took every
net of every step (its launch counter says 2 a step); a change that renames
or replaces C's kernels points KERNELS at what replaces them."""
from port_bench import counts

KERNELS = ("fused_mlp_v2_bwd_kernel", "fused_mlp_v2_dw_kernel", "fused_mlp_v2_dw_reduce_kernel")


def read(rec):
    if rec is None or rec["kind"] != "train":
        return None
    seconds = rec["summary"].kernel_seconds(*KERNELS)
    if seconds <= 0 or rec["launches"].get("fused_mlp_v2_bwd") != 2 * rec["steps"]:
        return None
    flops = 3.0 * counts.net_forward_flops(rec["flags"], rec["steps"] * rec["batch"])
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / seconds
