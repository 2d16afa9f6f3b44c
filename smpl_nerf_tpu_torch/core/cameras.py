"""Camera path constructors (numpy copy of smpl_nerf_tpu/core/cameras.py).

Euler-angle pose matrices and circle / sphere / circle-on-sphere camera paths;
every constructor returns a stacked [N, 4, 4] float64 batch; `get_xyzphitheta`
reads position and Euler angles back from a pose (the nearest-neighbour
baseline's features). Poses are tiny, so they are built on the host.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _euler_xyz_to_matrix(phi: np.ndarray, theta: np.ndarray, psi: np.ndarray) -> np.ndarray:
    """Rotation matrices from intrinsic xyz euler angles in degrees.

    Matches scipy.spatial.transform.Rotation.from_euler('xyz', ..., degrees=True)
    (used by reference camera.py:33): R = Rz(psi) @ Ry(theta) @ Rx(phi).
    """
    phi, theta, psi = np.radians(phi), np.radians(theta), np.radians(psi)
    cx, sx = np.cos(phi), np.sin(phi)
    cy, sy = np.cos(theta), np.sin(theta)
    cz, sz = np.cos(psi), np.sin(psi)
    zeros = np.zeros_like(cx)
    ones = np.ones_like(cx)
    rx = np.stack([
        np.stack([ones, zeros, zeros], -1),
        np.stack([zeros, cx, -sx], -1),
        np.stack([zeros, sx, cx], -1),
    ], -2)
    ry = np.stack([
        np.stack([cy, zeros, sy], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([-sy, zeros, cy], -1),
    ], -2)
    rz = np.stack([
        np.stack([cz, -sz, zeros], -1),
        np.stack([sz, cz, zeros], -1),
        np.stack([zeros, zeros, ones], -1),
    ], -2)
    return rz @ ry @ rx


def get_pose_matrix(x=0.0, y=0.0, z=0.0, phi=0.0, theta=0.0, psi=0.0) -> np.ndarray:
    """4x4 homogeneous pose from translation + xyz euler angles (degrees).

    Reference: camera.py:7-37.
    """
    rot = _euler_xyz_to_matrix(np.asarray(phi, np.float64), np.asarray(theta, np.float64),
                               np.asarray(psi, np.float64))
    pose = np.eye(4)
    pose[:3, :3] = rot
    pose[:3, 3] = [x, y, z]
    return pose


def get_circle_pose(theta: float, r: float) -> np.ndarray:
    """Pose on the xz-circle of radius r around the y axis. Reference: camera.py:62-83."""
    z = r * np.cos(np.radians(theta))
    x = r * np.sin(np.radians(theta))
    return get_pose_matrix(x=x, z=z, theta=theta)


def get_sphere_pose(phi: float, theta: float, r: float) -> np.ndarray:
    """Pose on a sphere (spherical coordinates), camera facing origin.

    Reference: camera.py:86-110.
    """
    z = r * np.cos(np.radians(phi)) * np.cos(np.radians(theta))
    x = r * np.cos(np.radians(phi)) * np.sin(np.radians(theta))
    y = r * np.sin(np.radians(phi))
    return get_pose_matrix(x=x, y=y, z=z, theta=theta, phi=-phi)


def get_sphere_poses(start_angle: float, end_angle: float, number_steps: int,
                     r: float) -> Tuple[np.ndarray, np.ndarray]:
    """Grid of number_steps**2 poses over [start, end]^2 in (phi, theta).

    Reference: camera.py:113-141 (tile(phis) x repeat(thetas) ordering).
    """
    phis = np.linspace(start_angle, end_angle, number_steps)
    thetas = np.linspace(start_angle, end_angle, number_steps)
    angles = np.transpose([np.tile(phis, len(thetas)), np.repeat(thetas, len(phis))])
    poses = np.stack([get_sphere_pose(phi, theta, r) for (phi, theta) in angles])
    return poses, angles


def get_circle_poses(start_angle: float, end_angle: float, number_steps: int,
                     r: float) -> Tuple[np.ndarray, np.ndarray]:
    """Poses along a circle arc. Reference: camera.py:144-169."""
    thetas = np.linspace(start_angle, end_angle, number_steps)
    poses = np.stack([get_circle_pose(theta, r) for theta in thetas])
    return poses, thetas


def get_circle_on_sphere_poses(number_steps: int, circle_radius: float,
                               sphere_radius: float, center_theta: float = 0.0,
                               center_phi: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Poses along a small circle drawn on a sphere. Reference: camera.py:172-206."""
    angles = np.linspace(0, np.pi * 2, number_steps)
    poses = []
    for angle in angles:
        phi = circle_radius * np.cos(angle) + center_phi
        theta = circle_radius * np.sin(angle) + center_theta
        poses.append(get_sphere_pose(phi, theta, sphere_radius))
    return np.stack(poses), angles


def get_xyzphitheta(pose: np.ndarray) -> np.ndarray:
    """(x, y, z, -phi, theta, psi) of a pose matrix, angles in degrees: the
    inverse of the extrinsic xyz Euler composition R = Rz(psi) Ry(theta) Rx(phi)."""
    trans = pose[:3, 3]
    rot = pose[:3, :3]
    theta = np.degrees(np.arcsin(np.clip(-rot[2, 0], -1.0, 1.0)))
    phi = np.degrees(np.arctan2(rot[2, 1], rot[2, 2]))
    psi = np.degrees(np.arctan2(rot[1, 0], rot[0, 0]))
    return np.concatenate((trans, [-phi, theta, psi]))
