"""A seeded body in the licensed SMPL model's pkl format (frozen yardstick).

The licensed pkl (basicModel_f_lbs_10_207_0_v1.0.0.pkl) is not in the
repository, so a run draws a body of the same format and sizes from its
seed, as it draws the nets' weights, and hands the program the file through
--smpl_model_path: the program loads it through `load_smpl_pkl`, the path a
licensed user takes. Nothing here imports the program.

Sizes (SMPL's): 6,890 vertices, 13,776 faces, 24 joints on SMPL's kinematic
tree, `shapedirs` [6890, 3, 10], `posedirs` [6890, 3, 207], a sparse
`J_regressor` [24, 6890] (a scipy csc_matrix where scipy imports, as in the
published file; a dense array otherwise, which the loader reads the same
way), `weights` [6890, 24]; besides `kintree_table`, `J`, `bs_style`,
`bs_type`.

Geometry: the vertices lie on the scene's body (scene.py's ellipsoids: torso,
head, two legs, two arms at the rest angle), each part a UV-sphere grid (its
two poles and rings of segments; 13,756 faces) with five 4-triangle bridges
that join the head and the limbs to the torso (20 faces), so the vertex
attention of the dynamic family finds real neighbours around every sample
near the body. Joints: SMPL's 24, placed on the scene's body; the regressor
row of a joint averages its 16 nearest vertices; each vertex is skinned to
the joints of its part's chain by a Gaussian of its distance to them (the
arms hang below the collar joints 13 / 14, whose z-rotations are body_pose
38 / 41, the benchmark's arm angles). The seed moves the vertices along
their surface, the blend shapes and nothing of the sizes. The blend shapes
are small: shapedirs N(0, 1e-3), posedirs N(0, 2e-3) per entry.
"""
from __future__ import annotations

import math
import os
import pickle
from pathlib import Path

import numpy as np

from port_bench import scene

NUM_VERTICES, NUM_FACES, NUM_JOINTS = 6890, 13776, 24
SHAPE_COLUMNS, POSE_COLUMNS = 10, 207
PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12,
                    13, 14, 16, 17, 18, 19, 20, 21], np.int64)
BODY_STREAM = 21

# (name, centre, radii, rings, segments, chain joints); the arms are placed below
_PARTS = (("torso", (0.0, 0.10, 0.0), (0.22, 0.38, 0.13), 56, 48, (0, 3, 6, 9, 12)),
          ("head", (0.0, 0.68, 0.0), (0.13, 0.15, 0.13), 38, 21, (12, 15)),
          ("leg_l", (0.10, -0.65, 0.0), (0.08, 0.40, 0.08), 44, 24, (1, 4, 7, 10)),
          ("leg_r", (-0.10, -0.65, 0.0), (0.08, 0.40, 0.08), 44, 24, (2, 5, 8, 11)))
_ARMS = (("arm_l", 1.0, 32, 20, (13, 16, 18, 20, 22)),
         ("arm_r", -1.0, 32, 20, (14, 17, 19, 21, 23)))
_SKIN_SIGMA = 0.12


def _arm_frame(side: float):
    """(centre, radii, psi) of an arm at scene.py's rest angle."""
    phi = math.radians(scene._ARM_REST_DEG)
    u = np.array([side * math.sin(phi), -math.cos(phi), 0.0])
    centre = np.array(scene._SHOULDER) * np.array([side, 1.0, 1.0]) + scene._ARM_RADII[1] * u
    return centre, np.array(scene._ARM_RADII), side * phi


def _joints() -> np.ndarray:
    """[24, 3] joint locations on the scene's body (SMPL's order)."""
    j = np.zeros((NUM_JOINTS, 3))
    j[0] = (0.0, -0.20, 0.0)
    j[3], j[6], j[9], j[12] = (0.0, 0.02, 0.0), (0.0, 0.20, 0.0), (0.0, 0.34, 0.0), (0.0, 0.48, 0.0)
    j[15] = (0.0, 0.62, 0.0)
    for side, (hip, knee, ankle, foot) in ((1.0, (1, 4, 7, 10)), (-1.0, (2, 5, 8, 11))):
        x = 0.10 * side
        j[hip], j[knee], j[ankle], j[foot] = (x, -0.28, 0.0), (x, -0.62, 0.0), (x, -0.96, 0.0), (x, -1.02, 0.04)
    for side, (collar, shoulder, elbow, wrist, hand) in ((1.0, (13, 16, 18, 20, 22)),
                                                         (-1.0, (14, 17, 19, 21, 23))):
        centre, radii, psi = _arm_frame(side)
        axis = np.array([math.sin(abs(psi)) * side, -math.cos(psi), 0.0])
        top = centre - radii[1] * axis
        j[collar] = (0.08 * side, 0.42, 0.0)
        j[shoulder] = top
        j[elbow] = centre + 0.05 * axis
        j[wrist] = centre + 0.22 * axis
        j[hand] = centre + 0.27 * axis
    return j


def _uv_sphere(rings: int, segments: int, jitter: np.ndarray):
    """(unit-sphere points [rings*segments + 2, 3], faces [2*rings*segments, 3]):
    the south pole, `rings` rings of `segments` points, the north pole; the
    points move by `jitter` (a fraction of a grid step) in both angles."""
    theta = (np.arange(1, rings + 1)[:, None] + jitter[:, :, 0]) * math.pi / (rings + 1)
    phi = (np.arange(segments)[None, :] + jitter[:, :, 1]) * 2.0 * math.pi / segments
    ring = np.stack([np.sin(theta) * np.cos(phi), -np.cos(theta),
                     np.sin(theta) * np.sin(phi)], -1).reshape(-1, 3)
    points = np.concatenate([[[0.0, -1.0, 0.0]], ring, [[0.0, 1.0, 0.0]]])
    idx = 1 + np.arange(rings * segments).reshape(rings, segments)
    nxt = np.roll(idx, -1, axis=1)
    faces = [np.stack([np.zeros(segments, np.int64), nxt[0], idx[0]], -1)]
    for r in range(rings - 1):
        a, b, c, d = idx[r], nxt[r], idx[r + 1], nxt[r + 1]
        faces += [np.stack([a, b, c], -1), np.stack([b, d, c], -1)]
    top = rings * segments + 1
    faces.append(np.stack([idx[-1], nxt[-1], np.full(segments, top)], -1))
    return points, np.concatenate(faces)


def make_body(seed: int) -> dict:
    """The pkl's dict (numpy arrays, a csc_matrix regressor where scipy
    imports) of the body of run seed `seed`."""
    rng = np.random.default_rng(scene.stream_seed(seed, BODY_STREAM))
    parts = [(name, np.array(c), np.array(r), 0.0, rings, seg, chain)
             for name, c, r, rings, seg, chain in _PARTS]
    for name, side, rings, seg, chain in _ARMS:
        centre, radii, psi = _arm_frame(side)
        parts.append((name, centre, radii, psi, rings, seg, chain))
    joints = _joints()
    verts, faces, skin, poles = [], [], [], []
    at = 0
    for name, centre, radii, psi, rings, seg, chain in parts:
        unit, f = _uv_sphere(rings, seg, rng.uniform(-0.3, 0.3, (rings, seg, 2)))
        local = unit * radii
        c, s = math.cos(psi), math.sin(psi)
        rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        v = local @ rot.T + centre
        w = np.zeros((len(v), NUM_JOINTS))
        d2 = ((v[:, None, :] - joints[list(chain)][None]) ** 2).sum(-1)
        g = np.exp(-(d2 - d2.min(1, keepdims=True)) / (2.0 * _SKIN_SIGMA ** 2))
        w[:, list(chain)] = g / g.sum(1, keepdims=True)
        verts.append(v)
        faces.append(f + at)
        skin.append(w)
        poles.append((at, at + len(v) - 1))
        at += len(v)
    v_template = np.concatenate(verts)
    faces = np.concatenate(faces)
    # five bridges to the torso (part 0): the head's south pole, each leg's
    # north pole and each arm's north pole, to the 4 nearest torso vertices
    torso = v_template[:poles[0][1] + 1]
    bridges = []
    for k, (south, north) in enumerate(poles[1:], 1):
        pole = south if k == 1 else north
        near = np.argsort(((torso - v_template[pole]) ** 2).sum(-1))[:5]
        bridges += [[pole, near[i], near[i + 1]] for i in range(4)]
    faces = np.concatenate([faces, np.array(bridges)]).astype(np.uint32)
    regressor = np.zeros((NUM_JOINTS, len(v_template)))
    for j in range(NUM_JOINTS):
        near = np.argsort(((v_template - joints[j]) ** 2).sum(-1))[:16]
        regressor[j, near] = 1.0 / 16.0
    kintree = np.stack([PARENTS, np.arange(NUM_JOINTS)]).astype(np.int64)
    kintree[0, 0] = 4294967295
    body = {"v_template": v_template,
            "shapedirs": rng.normal(0.0, 1e-3, (len(v_template), 3, SHAPE_COLUMNS)),
            "posedirs": rng.normal(0.0, 2e-3, (len(v_template), 3, POSE_COLUMNS)),
            "J_regressor": _sparse(regressor), "weights": np.concatenate(skin),
            "f": faces, "kintree_table": kintree, "J": regressor @ v_template,
            "bs_style": "lbs", "bs_type": "lrotmin"}
    assert body["v_template"].shape == (NUM_VERTICES, 3) and faces.shape == (NUM_FACES, 3)
    return body


def _sparse(dense: np.ndarray):
    try:
        from scipy.sparse import csc_matrix
    except ImportError:
        return dense
    return csc_matrix(dense)


def arrays(body: dict) -> dict:
    """The arrays LBS reads, float32: v_template, shapedirs, posedirs,
    J_regressor (dense), weights; and parents [24]."""
    out = {k: np.asarray(body[k].toarray() if hasattr(body[k], "toarray") else body[k],
                         np.float32)
           for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights")}
    out["parents"] = PARENTS.copy()
    return out


def write_body(seed: int, cache_dir: Path) -> tuple:
    """(path of the seed's pkl, the body): written once per seed under
    cache_dir/bodies/, through a temporary file and a rename."""
    body = make_body(seed)
    path = Path(cache_dir) / "bodies" / f"smpl_body_{int(seed)}.pkl"
    if not path.is_file():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as fh:
            pickle.dump(body, fh, protocol=2)
        os.replace(tmp, path)
    return path, body
