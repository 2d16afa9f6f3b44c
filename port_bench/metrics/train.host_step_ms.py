"""Host ms of a training step in the device-only stretch: the median of the
program's `solver.step` spans (training/solver.py: forward, backward and
Adam enqueued; nothing synchronises inside), port_bench/spans.py."""
from port_bench import spans


def read(rec):
    return spans.median_ms(rec, "train", "solver.step")
