"""CUDA kernels on the device in the traced window (copies and sets left
out) per view."""


def read(rec):
    if rec is None or rec["kind"] != "views" or not rec["views"]:
        return None
    return rec["summary"].launches / rec["views"]
