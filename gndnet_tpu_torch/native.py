"""ctypes bindings to the port's native host library
(`csrc/host/gndnet_host.cpp`).

The port's own copy of `gndnet_tpu.native`, with the same API: C++ host-side
equivalents of the reference's numba layer (reference:
utils/point_cloud_ops.py, utils/utils.py:198-248, utils/transform.py,
ros_node.py:58-138):

* `voxelize`: the reference's exact sequential voxelizer, including the
  break-on-capacity quirk; a host-parity oracle;
* `segment_cloud_host`, `shift_cloud_host`, `transform_cloud_host`;
* `NativeMailbox`: lock-free latest-value triple buffer for streaming.

This is host code, not a kernel.  The library is built with g++ at first
use into `_build/` (listed in .gitignore), under a file name that carries a
hash of the source and flags, so an edited source is rebuilt and a stale
library is never loaded; the build writes a temporary file and renames it.
`available()` returns False where no g++ can build it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "host", "gndnet_host.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None
_lock = threading.Lock()


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libgndnet_host_{digest.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, path)
    return True


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None

        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        lib.voxelize.restype = ctypes.c_int
        lib.voxelize.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, f32p, i32p, i32p, ctypes.c_int,
        ]
        lib.segment_cloud.restype = None
        lib.segment_cloud.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, f32p, ctypes.c_float,
            f32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, f32p,
        ]
        lib.shift_cloud.restype = None
        lib.shift_cloud.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_float]
        lib.transform_cloud.restype = None
        lib.transform_cloud.argtypes = [f32p, ctypes.c_int64, ctypes.c_int,
                                        f64p]
        lib.mailbox_create.restype = ctypes.c_void_p
        lib.mailbox_create.argtypes = [ctypes.c_int64]
        lib.mailbox_destroy.restype = None
        lib.mailbox_destroy.argtypes = [ctypes.c_void_p]
        lib.mailbox_write.restype = ctypes.c_int
        lib.mailbox_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64,
                                      ctypes.c_int64]
        lib.mailbox_read_latest.restype = ctypes.c_int64
        lib.mailbox_read_latest.argtypes = [
            ctypes.c_void_p, u8p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (no g++?)")
    return lib


def voxelize(points: np.ndarray, voxel_size, pc_range, max_points: int,
             max_voxels: int, reverse_index: bool = True,
             reference_break: bool = True):
    """Reference-exact sequential voxelization on the host.

    Returns (voxels, coors, num_points) trimmed to the created voxel count,
    the same dynamic-shape contract as the reference's points_to_voxel
    (utils/point_cloud_ops.py:107-167)."""
    lib = _require()
    points = np.ascontiguousarray(points, np.float32)
    n, f = points.shape
    vs = np.asarray(voxel_size, np.float32)
    pr = np.asarray(pc_range, np.float32)
    grid = np.round((pr[3:] - pr[:3]) / vs).astype(np.int64)
    coor_map = np.full(int(grid.prod()), -1, np.int32)
    voxels = np.zeros((max_voxels, max_points, f), np.float32)
    coors = np.zeros((max_voxels, 3), np.int32)
    num_points = np.zeros(max_voxels, np.int32)
    n_vox = lib.voxelize(points, n, f, vs, pr, max_points, max_voxels,
                         int(reverse_index), coor_map, voxels, coors,
                         num_points, int(reference_break))
    return voxels[:n_vox], coors[:n_vox], num_points[:n_vox]


def segment_cloud_host(points: np.ndarray, grid_range, cell: float,
                       elevation: np.ndarray, threshold: float) -> np.ndarray:
    """Per-point {1, 0, -1} float32 labels against elevation[x, y]."""
    lib = _require()
    points = np.ascontiguousarray(points, np.float32)
    elevation = np.ascontiguousarray(elevation, np.float32)
    out = np.empty(points.shape[0], np.float32)
    lib.segment_cloud(points, points.shape[0], points.shape[1],
                      np.asarray(grid_range, np.float32), cell, elevation,
                      elevation.shape[0], elevation.shape[1], threshold, out)
    return out


def _check_inplace(points: np.ndarray) -> None:
    if points.dtype != np.float32 or not points.flags.c_contiguous:
        raise ValueError("points must be a C-contiguous float32 array "
                         "(updated in place)")


def shift_cloud_host(points: np.ndarray, dz: float) -> np.ndarray:
    """Add dz to z in place; returns points."""
    lib = _require()
    _check_inplace(points)
    lib.shift_cloud(points, points.shape[0], points.shape[1], dz)
    return points


def transform_cloud_host(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to xyz in place; returns points."""
    lib = _require()
    _check_inplace(points)
    m = np.ascontiguousarray(matrix, np.float64)
    lib.transform_cloud(points, points.shape[0], points.shape[1], m)
    return points


class NativeMailbox:
    """Lock-free latest-value mailbox over fixed-size byte slots.

    Single producer / single consumer; the producer never blocks and the
    consumer always sees the newest published payload (stale payloads are
    overwritten, reproducing the reference's drop-old semantics,
    ros_node.py:132-138, without a lock)."""

    def __init__(self, capacity_bytes: int):
        self._lib = _require()
        self.capacity = int(capacity_bytes)
        self._handle = self._lib.mailbox_create(self.capacity)
        self._seq = 0

    def write(self, payload: np.ndarray) -> int:
        """Publish a payload (any dtype/shape, flattened bytes); returns seq."""
        buf = np.ascontiguousarray(payload).view(np.uint8).reshape(-1)
        self._seq += 1
        rc = self._lib.mailbox_write(self._handle, buf, buf.size, self._seq)
        if rc != 0:
            raise ValueError(
                f"payload of {buf.size} bytes exceeds capacity {self.capacity}")
        return self._seq

    def read_latest(self, out: np.ndarray):
        """Copy the newest unseen payload into `out` (uint8, flat).
        Returns (nbytes, seq); nbytes == 0 means nothing new."""
        if out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError("out must be a C-contiguous uint8 array")
        seq = ctypes.c_int64(-1)
        n = self._lib.mailbox_read_latest(self._handle, out, out.size,
                                          ctypes.byref(seq))
        return int(n), int(seq.value)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mailbox_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
