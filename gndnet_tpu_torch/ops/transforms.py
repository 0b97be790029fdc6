"""Rigid-transform utilities: quaternion <-> euler <-> matrix, cloud transform.

The port's own copy of `gndnet_tpu.ops.transforms` (numpy only), which
replaces the reference's numba transform kernels (reference:
utils/transform.py:8-165).  The per-point python loop (`transformCloud`,
transform.py:154-165) becomes a single (N,3) @ (3,3) matmul plus
translation, in numpy on the host.
"""

from __future__ import annotations

import math

import numpy as np


def euler_from_quaternion(x: float, y: float, z: float, w: float) -> tuple:
    """Quaternion (x,y,z,w) -> (roll, pitch, yaw) radians
    (reference utils/transform.py:16-37)."""
    t0 = 2.0 * (w * x + y * z)
    t1 = 1.0 - 2.0 * (x * x + y * y)
    roll = math.atan2(t0, t1)
    t2 = max(-1.0, min(1.0, 2.0 * (w * y - z * x)))
    pitch = math.asin(t2)
    t3 = 2.0 * (w * z + x * y)
    t4 = 1.0 - 2.0 * (y * y + z * z)
    yaw = math.atan2(t3, t4)
    return roll, pitch, yaw


def quaternion_from_euler(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """(roll, pitch, yaw) -> quaternion [x, y, z, w]
    (reference utils/transform.py:39-57)."""
    cr, sr = math.cos(roll / 2), math.sin(roll / 2)
    cp, sp = math.cos(pitch / 2), math.sin(pitch / 2)
    cy, sy = math.cos(yaw / 2), math.sin(yaw / 2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def quaternion_rotation_matrix(q: np.ndarray) -> np.ndarray:
    """Quaternion [x, y, z, w] -> 3x3 rotation matrix
    (reference utils/transform.py:59-93)."""
    qx, qy, qz, qw = q
    return np.array([
        [2 * (qw * qw + qx * qx) - 1, 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 2 * (qw * qw + qy * qy) - 1, 2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 2 * (qw * qw + qz * qz) - 1],
    ])


def transformation_matrix(translation, rotation) -> np.ndarray:
    """(3,) translation + (3,3) rotation -> 4x4 homogeneous matrix
    (reference utils/transform.py:99-105)."""
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = np.asarray(translation)
    return m


def transform_from_translation_quaternion(translation, quaternion) -> np.ndarray:
    """The TransformStamped -> matrix path without ROS types
    (reference utils/transform.py:107-111)."""
    return transformation_matrix(
        translation, quaternion_rotation_matrix(np.asarray(quaternion)))


def transform_cloud(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to (N, >=3) points; extra columns pass through.

    One matmul instead of the reference's per-point loop
    (utils/transform.py:154-165)."""
    out = np.array(points, copy=True)
    out[:, :3] = points[:, :3] @ matrix[:3, :3].T + matrix[:3, 3]
    return out


def rotate_cloud_euler_zyx(points: np.ndarray, angles_deg) -> np.ndarray:
    """Rotate xyz by euler angles given in 'zyx' order in degrees, matching
    scipy Rotation.from_euler('zyx', ...) as used by the reference
    (dataset_generator_utils.py:200-206, dataset_augmentation.py:141-154)."""
    from scipy.spatial.transform import Rotation as R

    r = R.from_euler("zyx", angles_deg, degrees=True).as_matrix()
    out = np.array(points, copy=True)
    out[:, :3] = points[:, :3] @ r.T
    return out
