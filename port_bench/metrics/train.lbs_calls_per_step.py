"""The program's `smpl.lbs_calls` over the traced stretch (calls of
models/smpl.smpl_forward, counted from the host) per training step of it.
None where the record holds no such counter."""


def read(rec):
    if rec is None or rec.get("kind") != "train" or not rec.get("steps"):
        return None
    calls = (rec.get("counters") or {}).get("smpl.lbs_calls")
    return None if calls is None else calls / rec["steps"]
