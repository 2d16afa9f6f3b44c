"""The vertex attention's share of its bound: the bound time of a training
step's (sample, vertex) pairs (port_bench/counts_dynamic.py: the published
math once per pair, the larger of the FP32 and special-function pipes' times
on the H100) over the device time of the operations launched under
`pass.warp` in a step (train.vertex_attention_ms_per_step)."""
from port_bench import counts_dynamic
from port_bench.harness import BENCH_DIR, load_module

_ms = load_module(BENCH_DIR / "metrics" / "train.vertex_attention_ms_per_step.py",
                  "port_bench_metric_train.vertex_attention_ms_per_step")


def read(rec):
    seconds = _ms.attention_s(rec)
    if seconds is None or not rec.get("vertices"):
        return None
    bound = counts_dynamic.attention_bound_s(
        counts_dynamic.pairs_per_step(rec["flags"], rec["vertices"]))
    return 100.0 * bound * rec["steps"] / seconds
