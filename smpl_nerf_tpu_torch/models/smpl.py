"""Differentiable SMPL body model in PyTorch (linear blend skinning).

Counterpart of smpl_nerf_tpu/models/smpl.py. `smpl_forward` is the LBS
forward: shape blendshapes, rest joints, Rodrigues per joint, pose
blendshapes, the kinematic chain, then skinning. It takes a batch of poses
([..., 69] -> [..., V, 3]) and is differentiable in betas and body_pose, which
the image-wise family needs.

Two ways to get a model, as in the JAX package:
  * ``load_smpl_pkl(path)`` parses the licensed SMPL .pkl (chumpy arrays and
    the scipy sparse joint regressor are read without importing either);
  * ``procedural_human()`` builds an articulated human with the same 24-joint
    SMPL kinematic tree and 69-dim body_pose contract from capsule limbs
    (3,120 vertices at the default tessellation), with smooth skinning weights
    and striped vertex colours.

Pose convention: body_pose[69] is the axis-angle of joints 1..23;
pose[3*(j-1):3*j] rotates the subtree below joint j about joint j. The arm
angles at indices 38 / 41 are the z-rotations of the collar joints 13 / 14.

`lbs_calls` counts the calls of `smpl_forward`, `lbs_poses` the poses they
skinned (no device sync).
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional

import numpy as np
import torch

NUM_JOINTS = 24
lbs_calls = 0         # smpl_forward calls
lbs_poses = 0         # poses they skinned
PARENTS = np.array([-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12,
                    13, 14, 16, 17, 18, 19, 20, 21], np.int32)


@dataclasses.dataclass
class SmplModel:
    """Static model data (numpy); `tensors(device)` holds float32 copies per device."""
    v_template: np.ndarray       # [V, 3]
    shapedirs: np.ndarray        # [V, 3, B] shape blendshapes
    posedirs: np.ndarray         # [V, 3, 207] pose blendshapes (may be empty)
    joint_regressor: np.ndarray  # [24, V]
    lbs_weights: np.ndarray      # [V, 24]
    faces: np.ndarray            # [F, 3] int32
    parents: np.ndarray          # [24]
    vertex_colors: Optional[np.ndarray] = None  # [V, 3] in [0,1] (procedural)
    uv: Optional[np.ndarray] = None             # [V, 2] (real SMPL + uv map)
    rest_joints: Optional[np.ndarray] = None    # [24, 3] exact rest joints (procedural;
                                                # its shapedirs are zero, so the
                                                # regressor is bypassed)
    _cache: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_vertices(self) -> int:
        return self.v_template.shape[0]

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The arrays LBS reads, as float32 tensors on `device` (made once)."""
        key = str(torch.device(device))
        if key not in self._cache:
            names = ("v_template", "shapedirs", "posedirs", "joint_regressor", "lbs_weights")
            out = {n: torch.as_tensor(np.asarray(getattr(self, n), np.float32), device=device)
                   for n in names}
            if self.rest_joints is not None:
                out["rest_joints"] = torch.as_tensor(
                    np.asarray(self.rest_joints, np.float32), device=device)
            self._cache[key] = out
        return self._cache[key]


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Batched axis-angle [..., 3] -> rotation matrices [..., 3, 3].

    Gradient-safe at the zero rotation: sqrt(max(|aa|^2, eps)) keeps the
    norm's derivative finite there (zero joint angles are the common case).
    """
    sq = torch.sum(axis_angle * axis_angle, -1, keepdim=True)
    angle = torch.sqrt(torch.clamp(sq, min=1e-16))
    axis = axis_angle / torch.clamp(angle, min=1e-8)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack([torch.stack([zeros, -z, y], -1),
                     torch.stack([z, zeros, -x], -1),
                     torch.stack([-y, x, zeros], -1)], -2)
    a = angle[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * torch.matmul(K, K)


def smpl_forward(model: SmplModel, betas, body_pose, global_orient=None,
                 transl=None) -> torch.Tensor:
    """LBS forward: (betas [B], body_pose [..., 69]) -> vertices [..., V, 3].

    Runs on body_pose's device (a numpy pose runs on the CPU). The chain walk
    is a Python loop over the fixed 24-joint tree, batched over the poses.
    """
    global lbs_calls, lbs_poses
    body_pose = torch.as_tensor(body_pose, dtype=torch.float32)
    device = body_pose.device
    lead = body_pose.shape[:-1]
    pose = body_pose.reshape(-1, 23, 3)
    P = pose.shape[0]
    lbs_calls += 1
    lbs_poses += P
    t = model.tensors(device)
    betas = torch.as_tensor(betas, dtype=torch.float32, device=device).reshape(-1)
    nb = min(betas.shape[0], t["shapedirs"].shape[-1])

    v_shaped = t["v_template"] + torch.einsum("vcb,b->vc", t["shapedirs"][..., :nb], betas[:nb])
    joints = t["rest_joints"] if "rest_joints" in t else t["joint_regressor"] @ v_shaped

    if global_orient is None:
        root = torch.zeros((P, 1, 3), dtype=torch.float32, device=device)
    else:
        root = torch.as_tensor(global_orient, dtype=torch.float32,
                               device=device).reshape(1, 1, 3).expand(P, 1, 3)
    rots = rodrigues(torch.cat([root, pose], 1))                     # [P, 24, 3, 3]

    v_posed = v_shaped.expand(P, -1, -1)
    if t["posedirs"].numel():
        eye = torch.eye(3, device=device)
        pose_feature = (rots[:, 1:] - eye).reshape(P, -1)            # [P, 207]
        v_posed = v_posed + torch.einsum("vcp,np->nvc", t["posedirs"], pose_feature)

    # [0, 0, 0, 1] made on the device: a host tensor would be a blocking copy
    bottom = torch.zeros((P, 1, 4), device=device)
    bottom[..., 3] = 1.0

    def homogeneous(rot, trans):
        return torch.cat([torch.cat([rot, trans[..., None]], -1), bottom], -2)

    parents = model.parents
    transforms = [homogeneous(rots[:, 0], joints[0].expand(P, 3))]
    for j in range(1, NUM_JOINTS):
        rel = homogeneous(rots[:, j], (joints[j] - joints[parents[j]]).expand(P, 3))
        transforms.append(transforms[parents[j]] @ rel)
    A = torch.stack(transforms, 1)                                   # [P, 24, 4, 4]

    # remove the rest-pose joint locations: G_j = A_j @ translate(-J_j)
    joints_h = torch.einsum("njrc,jc->njr", A[:, :, :3, :3], joints)
    G = torch.cat([A[:, :, :3, :3], (A[:, :, :3, 3] - joints_h)[..., None]], -1)  # [P, 24, 3, 4]

    T = torch.einsum("vj,njrc->nvrc", t["lbs_weights"], G)          # [P, V, 3, 4]
    verts = torch.einsum("nvrc,nvc->nvr", T[..., :3], v_posed) + T[..., 3]
    if transl is not None:
        verts = verts + torch.as_tensor(transl, dtype=torch.float32,
                                        device=device).reshape(1, 1, 3)
    return verts.reshape(lead + verts.shape[1:])


# --------------------------------------------------------------------------
# Licensed SMPL pkl loading (no chumpy, no scipy)
# --------------------------------------------------------------------------

class _Stub:
    """What the unpickler makes of a chumpy array or a scipy sparse matrix:
    their pickled attributes, nothing else."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {})


class _SparseStub(_Stub):
    def toarray(self) -> np.ndarray:
        """Dense copy of a pickled scipy csc_matrix / csr_matrix."""
        shape = tuple(self.__dict__.get("_shape", self.__dict__.get("shape")))
        data, indices, indptr = (np.asarray(self.__dict__[k])
                                 for k in ("data", "indices", "indptr"))
        out = np.zeros(shape, data.dtype)
        by_column = self.fmt == "csc"
        for i in range(len(indptr) - 1):
            sl = slice(indptr[i], indptr[i + 1])
            if by_column:
                out[indices[sl], i] = data[sl]
            else:
                out[i, indices[sl]] = data[sl]
        return out


class _ChumpyUnpickler(pickle.Unpickler):
    """Unpickle SMPL pkls without chumpy or scipy: chumpy arrays keep their
    data in attribute `x`; sparse matrices become `_SparseStub`s."""

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _Stub
        if module.startswith("scipy.sparse") and name in ("csc_matrix", "csr_matrix"):
            return type(name, (_SparseStub,), {"fmt": name[:3]})
        return super().find_class(module, name)


def _to_np(x) -> np.ndarray:
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    if hasattr(x, "x"):  # chumpy stub: data lives in attribute 'x'
        return np.asarray(x.x)
    return np.asarray(x)


def load_smpl_pkl(path: str, uv_map_path: Optional[str] = None) -> SmplModel:
    """Load a licensed SMPL model pkl (e.g. basicModel_f_lbs_10_207_0_v1.0.0.pkl)."""
    with open(path, "rb") as fh:
        data = _ChumpyUnpickler(fh, encoding="latin1").load()
    v_template = _to_np(data["v_template"]).astype(np.float32)
    shapedirs = _to_np(data["shapedirs"]).astype(np.float32)
    posedirs = _to_np(data["posedirs"]).astype(np.float32)
    joint_regressor = _to_np(data["J_regressor"]).astype(np.float32)
    lbs_weights = _to_np(data["weights"]).astype(np.float32)
    faces = _to_np(data["f"]).astype(np.int32)
    uv = np.load(uv_map_path).astype(np.float32) if uv_map_path else None
    return SmplModel(v_template, shapedirs, posedirs, joint_regressor,
                     lbs_weights, faces, PARENTS.copy(), None, uv)


# --------------------------------------------------------------------------
# Procedural human (no licensed data required)
# --------------------------------------------------------------------------

_REST_JOINTS = np.array([
    [0.00, 0.00, 0.00],    # 0 pelvis
    [0.09, -0.09, 0.00],   # 1 L_hip
    [-0.09, -0.09, 0.00],  # 2 R_hip
    [0.00, 0.11, 0.00],    # 3 spine1
    [0.10, -0.48, 0.00],   # 4 L_knee
    [-0.10, -0.48, 0.00],  # 5 R_knee
    [0.00, 0.23, 0.00],    # 6 spine2
    [0.11, -0.85, 0.00],   # 7 L_ankle
    [-0.11, -0.85, 0.00],  # 8 R_ankle
    [0.00, 0.33, 0.00],    # 9 spine3
    [0.12, -0.93, 0.10],   # 10 L_foot
    [-0.12, -0.93, 0.10],  # 11 R_foot
    [0.00, 0.45, 0.00],    # 12 neck
    [0.06, 0.40, 0.00],    # 13 L_collar
    [-0.06, 0.40, 0.00],   # 14 R_collar
    [0.00, 0.58, 0.00],    # 15 head
    [0.17, 0.42, 0.00],    # 16 L_shoulder
    [-0.17, 0.42, 0.00],   # 17 R_shoulder
    [0.43, 0.42, 0.00],    # 18 L_elbow
    [-0.43, 0.42, 0.00],   # 19 R_elbow
    [0.68, 0.42, 0.00],    # 20 L_wrist
    [-0.68, 0.42, 0.00],   # 21 R_wrist
    [0.76, 0.42, 0.00],    # 22 L_hand
    [-0.76, 0.42, 0.00],   # 23 R_hand
], np.float32)

# capsule limbs: (skin_joint, start_joint, end_joint_or_offset, radius_start,
# radius_end, hue); each bone runs from joint start toward the end joint or
# the offset from start
_BONES = [
    (0, 0, 3, 0.115, 0.105, 0.00),        # pelvis->spine1 (lower torso)
    (3, 3, 6, 0.105, 0.10, 0.08),         # spine1->spine2
    (6, 6, 9, 0.10, 0.095, 0.16),         # spine2->spine3 (chest)
    (9, 9, 12, 0.095, 0.05, 0.24),        # spine3->neck
    (12, 12, 15, 0.035, 0.035, 0.32),     # neck
    (15, 15, (0.0, 0.14, 0.02), 0.085, 0.075, 0.40),  # head
    (1, 1, 4, 0.072, 0.055, 0.50),        # L thigh
    (2, 2, 5, 0.072, 0.055, 0.55),        # R thigh
    (4, 4, 7, 0.05, 0.038, 0.60),         # L shin
    (5, 5, 8, 0.05, 0.038, 0.65),         # R shin
    (7, 7, 10, 0.035, 0.03, 0.70),        # L foot
    (8, 8, 11, 0.035, 0.03, 0.73),        # R foot
    (13, 13, 16, 0.05, 0.045, 0.78),      # L collar->shoulder
    (14, 14, 17, 0.05, 0.045, 0.80),      # R collar->shoulder
    (16, 16, 18, 0.045, 0.036, 0.84),     # L upper arm
    (17, 17, 19, 0.045, 0.036, 0.87),     # R upper arm
    (18, 18, 20, 0.034, 0.028, 0.90),     # L forearm
    (19, 19, 21, 0.034, 0.028, 0.93),     # R forearm
    (20, 20, 22, 0.027, 0.022, 0.96),     # L hand
    (21, 21, 23, 0.027, 0.022, 0.98),     # R hand
]


def _hsv_to_rgb(h, s, v):
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def _capsule(start, end, r0, r1, rings, segments):
    """Capsule vertices, faces and the position t in [0, 1] along the bone of
    each vertex, from `start` to `end` with the radius lerped r0 -> r1."""
    start, end = np.asarray(start, np.float64), np.asarray(end, np.float64)
    axis = end - start
    length = np.linalg.norm(axis)
    axis_n = axis / max(length, 1e-9)
    up = np.array([0.0, 0.0, 1.0]) if abs(axis_n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    u = np.cross(axis_n, up)
    u /= np.linalg.norm(u)
    w = np.cross(axis_n, u)
    verts, params = [], []
    cap_rings = 3
    ts = np.concatenate([np.zeros(cap_rings), np.linspace(0, 1, rings), np.ones(cap_rings)])
    cap_angles_bottom = np.linspace(-np.pi / 2, 0, cap_rings, endpoint=False)
    cap_angles_top = np.linspace(0, np.pi / 2, cap_rings + 1)[1:]
    all_rings = []
    for k, t in enumerate(ts):
        r = r0 + (r1 - r0) * t
        center = start + axis * t
        if k < cap_rings:                       # bottom hemisphere
            a = cap_angles_bottom[k]
            ring_r = r * np.cos(a)
            center = center + axis_n * (r * np.sin(a))
        elif k >= cap_rings + rings:            # top hemisphere
            a = cap_angles_top[k - cap_rings - rings]
            ring_r = r * np.cos(a)
            center = center + axis_n * (r * np.sin(a))
        else:
            ring_r = r
        ring = []
        for s in range(segments):
            ang = 2 * np.pi * s / segments
            ring.append(len(verts))
            verts.append(center + ring_r * (np.cos(ang) * u + np.sin(ang) * w))
            params.append(t)
        all_rings.append(ring)
    faces = []
    for k in range(len(all_rings) - 1):
        a_ring, b_ring = all_rings[k], all_rings[k + 1]
        for s in range(segments):
            s2 = (s + 1) % segments
            faces.append([a_ring[s], b_ring[s], b_ring[s2]])
            faces.append([a_ring[s], b_ring[s2], a_ring[s2]])
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            np.asarray(params, np.float32))


def procedural_human(rings: int = 7, segments: int = 12) -> SmplModel:
    """Built-in articulated human: SMPL kinematic tree, capsule limbs, striped colours.

    The default tessellation gives 3,120 vertices and 6,000 faces. Skinning
    weights blend toward the parent joint near each bone's origin, so limbs
    bend without tearing.
    """
    all_v, all_f, all_w, all_c = [], [], [], []
    offset = 0
    for (skin_j, start_j, end_spec, r0, r1, hue) in _BONES:
        start = _REST_JOINTS[start_j]
        end = (start + np.asarray(end_spec, np.float32) if isinstance(end_spec, tuple)
               else _REST_JOINTS[end_spec])
        v, f, t = _capsule(start, end, r0, r1, rings, segments)
        all_v.append(v)
        all_f.append(f + offset)
        offset += len(v)
        # up to 50 % parent weight at the bone's base (t < 0.25)
        w = np.zeros((len(v), NUM_JOINTS), np.float32)
        parent = PARENTS[skin_j] if PARENTS[skin_j] >= 0 else skin_j
        blend = np.clip(0.25 - t, 0.0, 0.25) / 0.25 * 0.5
        w[:, skin_j] = 1.0 - blend
        w[:, parent] += blend
        all_w.append(w)
        # a base hue per bone, striped along the bone
        base = np.asarray(_hsv_to_rgb(hue, 0.55, 0.85), np.float32)
        alt = np.asarray(_hsv_to_rgb((hue + 0.45) % 1.0, 0.65, 0.6), np.float32)
        stripe = 0.5 * (1 + np.sin(t * 24.0))[:, None]
        all_c.append(base[None] * stripe + alt[None] * (1 - stripe))
    v_template = np.concatenate(all_v)
    V = len(v_template)
    # an approximate regressor (inverse distance over the 8 nearest vertices),
    # kept for the interface; smpl_forward uses the exact rest_joints
    joint_regressor = np.zeros((NUM_JOINTS, V), np.float32)
    for j in range(NUM_JOINTS):
        d = np.linalg.norm(v_template - _REST_JOINTS[j], axis=1)
        nearest = np.argsort(d)[:8]
        w = 1.0 / np.maximum(d[nearest], 1e-4)
        joint_regressor[j, nearest] = w / w.sum()
    return SmplModel(
        v_template=v_template,
        shapedirs=np.zeros((V, 3, 10), np.float32),
        posedirs=np.zeros((V, 3, 0), np.float32),
        joint_regressor=joint_regressor,
        lbs_weights=np.concatenate(all_w),
        faces=np.concatenate(all_f),
        parents=PARENTS.copy(),
        vertex_colors=np.concatenate(all_c).astype(np.float32),
        rest_joints=_REST_JOINTS.copy(),
    )


def get_human_poses(joints, start_angle: float, end_angle: float,
                    number_steps: int) -> np.ndarray:
    """[N, 1, 69] pose sweep: the listed joints get the angle (degrees -> radians),
    the rest zero."""
    angles = np.linspace(start_angle, end_angle, number_steps)
    poses = np.zeros((number_steps, 1, 69), np.float32)
    for i, angle in enumerate(angles):
        for joint in joints:
            poses[i, 0, int(joint)] = np.deg2rad(angle)
    return poses


_DEFAULT_BETAS = np.array([[-0.3596, -1.0232, -1.7584, -2.0465, 0.3387,
                            -0.8562, 0.8869, 0.5013, 0.5338, -0.0210]], np.float32)
_DEFAULT_EXPRESSION = np.array([[2.7228, -1.8139, 0.6270, -0.5565, 0.3251,
                                 0.5643, -1.2158, 1.4149, 0.4050, 0.6516]], np.float32)


def default_betas() -> np.ndarray:
    """The fixed betas the reference's renderer uses."""
    return _DEFAULT_BETAS.copy()


def default_expression() -> np.ndarray:
    """The fixed expression vector the reference's renderer uses."""
    return _DEFAULT_EXPRESSION.copy()


def distorted_betas(betas: np.ndarray, var: Optional[float] = None,
                    mean: Optional[float] = None, beta0: Optional[float] = None,
                    rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """Shape-coefficient distortion: N(0, var) noise on every beta, beta[0]
    shifted by `mean`, or beta[0] set to `beta0`."""
    arr = np.array(betas, np.float32, copy=True)
    out = arr.reshape(-1)
    rng = rng or np.random.RandomState(0)
    if var is not None:
        out += (var ** 0.5) * rng.randn(out.shape[0]).astype(np.float32)
    if mean is not None:
        out[0] += mean
    if beta0 is not None:
        out[0] = beta0
    return arr
