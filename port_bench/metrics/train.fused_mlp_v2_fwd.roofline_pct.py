"""Kernel B (ops/fused_mlp_v2.py, csrc/fused_mlp_v2_fwd.cu) in the training
window (steps and validation) against its bound: the forward FLOPs of the
nets it took, at the bf16 peak, over its device time by kernel name. Read
only where B took both nets of every step and validation batch (its launch
counter says so); a change that renames or replaces B's kernel points
KERNELS at what replaces it."""
from port_bench import counts

KERNELS = ("fused_mlp_v2_fwd_kernel",)


def read(rec):
    if rec is None or rec["kind"] != "train":
        return None
    seconds = rec["summary"].kernel_seconds(*KERNELS)
    expected = 2 * (rec["steps"] + rec["eval_batches"])
    if seconds <= 0 or rec["launches"].get("fused_mlp_v2_fwd") != expected:
        return None
    rays = rec["steps"] * rec["batch"] + rec["eval_padded_rays"]
    return 100.0 * counts.net_forward_flops(rec["flags"], rays) / counts.PEAK_BF16_FLOPS / seconds
