"""Kernel D (ops/fused_mlp.py, csrc/fused_mlp_fwd.cu) in the window of views
against its bound: the forward FLOPs of the nets it took (pre-encoded rows of
the prefix, positional and directional blocks, padded rows of a last batch
included), at the bf16 peak, over its device time by kernel name. Read only
where D took both nets of every batch (its launch counter says so); a change
that renames or replaces D's kernel points KERNELS at what replaces it."""
from port_bench import counts

KERNELS = ("fused_mlp_fwd_kernel",)


def read(rec):
    if rec is None or rec["kind"] != "views":
        return None
    seconds = rec["summary"].kernel_seconds(*KERNELS)
    if seconds <= 0 or rec["launches"].get("fused_mlp_fwd") != 2 * rec["eval_batches"]:
        return None
    flops = counts.net_forward_flops(rec["flags"], rec["eval_padded_rays"])
    return 100.0 * flops / counts.PEAK_BF16_FLOPS / seconds
