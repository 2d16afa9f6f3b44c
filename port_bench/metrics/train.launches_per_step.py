"""CUDA kernels on the device in the traced window (copies and sets left
out) per training step; each epoch's validation counts in."""


def read(rec):
    if rec is None or rec["kind"] != "train" or not rec["steps"]:
        return None
    return rec["summary"].launches / rec["steps"]
