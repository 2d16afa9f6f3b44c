"""Device ms a training step of the operations launched under the program's
`pass.warp` span inside `solver.step` (dummy_dynamic: the vertex attention
alone), from the traced stretch's attribution of each device operation to the
span open when it was launched (traffic/train_dynamic.py); the validation's
attention is left out. None where the record has no attribution."""


def attention_s(rec):
    """Device seconds of the training steps' pass.warp operations, or None."""
    if rec is None or rec.get("kind") != "train" or not rec.get("steps"):
        return None
    kernels = rec.get("kernels")
    if not kernels or not kernels.get("by_span"):
        return None
    seconds = sum(s for path, (s, _) in kernels["by_span"].items()
                  if "pass.warp" in path.split("/") and "solver.step" in path.split("/"))
    return seconds if seconds > 0 else None


def read(rec):
    seconds = attention_s(rec)
    return None if seconds is None else 1e3 * seconds / rec["steps"]
