"""Device ms a training step of the operations launched under the program's
`pass.encode` span inside `solver.step` (the hash-grid encoding's forward,
models/grid_nerf.hash_grid_encode, of the coarse and fine fields; its
backward runs under `solver.backward`), from the traced stretch's
attribution of each device operation to the span open when it was launched
(traffic/train_hashgrid.py); the validation's encoding is left out. None
where the record has no attribution or nothing ran there."""


def read(rec):
    if rec is None or rec.get("kind") != "train" or not rec.get("steps"):
        return None
    kernels = rec.get("kernels")
    if not kernels or not kernels.get("by_span"):
        return None
    seconds = sum(s for path, (s, _) in kernels["by_span"].items()
                  if {"solver.step", "pass.encode"} <= set(path.split("/")))
    return 1e3 * seconds / rec["steps"] if seconds > 0 else None
