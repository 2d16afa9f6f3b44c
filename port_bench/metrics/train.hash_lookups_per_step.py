"""The program's `grid.lookups` over the traced stretch (table lookups of the
hash-grid encoding, rows x levels x 8 corners, counted from the shapes on the
host: models/grid_nerf.lookups) per training step of it; the epoch's
validation counts in. None where the record holds no such counter."""


def read(rec):
    if rec is None or rec.get("kind") != "train" or not rec.get("steps"):
        return None
    lookups = (rec.get("counters") or {}).get("grid.lookups")
    return None if lookups is None else lookups / rec["steps"]
