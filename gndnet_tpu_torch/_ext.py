"""Build and load the hand-written Hopper kernels of `csrc/`, and the
device rule every entry point follows.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
by `nvcc` into its own shared library under `_build/` (listed in
.gitignore), then loaded with `ctypes`.  The library's file name carries a
hash of its source and flags, so an edited source is rebuilt and a stale
library is never loaded.  Builds hold a file lock in `_build/`, so the
processes of a multi-process run that load the same library at once get
one build of it.  Every C entry takes its pointers and the CUDA
stream as `c_void_p`, launches on PyTorch's current stream, allocates
nothing, and returns `cudaGetLastError()`; `check` raises on a non-zero
code.  Nothing here runs at import time: this module imports on hosts
without `nvcc` or a card, where the wrappers take their plain versions for
CPU tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C signatures: name -> (library, argtypes).  Every entry returns int.
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "bitonic_sort_i32": ("bitonic_sort", [_P, _I, _P]),
    "bitonic_sort2_i32": ("bitonic_sort2", [_P, _P, _P, _P, _P, _I, _I, _P]),
    "cluster_radix_sort_i32": ("cluster_radix_sort", [_P, _P, _I, _P]),
    "cluster_radix_sort2_i32": ("cluster_radix_sort", [_P, _P, _P, _P, _I,
                                                       _P]),
    "cluster_radix_sort_capacity": ("cluster_radix_sort", [_I]),
    "cell_histogram_i32": ("cell_histogram", [_P, _P, _P, _I, _I, _I, _I,
                                              _P]),
    "cell_histogram_capacity": ("cell_histogram", []),
    "affine_scan_gather": ("affine_scan", [_P, _P, _P, _P, _P, _P, _I, _I,
                                           _I, _I, _I, _P]),
    "affine_scan_argmax": ("affine_scan", [_P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _I, _I, _I, _P]),
    "affine_bwd_dmmat": ("affine_bwd", [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                        _I, _I, _I, _P]),
    "suffix_segment_reduce": ("suffix_segment", [_P, _P, _P, _P, _L, _I, _I,
                                                 _I, _I, _I, _P]),
    "affine_segment_scan": ("prefix_segment", [_P, _P, _P, _P, _P, _P, _P, _L,
                                               _I, _I, _I, _I, _P]),
    "segment_broadcast_t": ("prefix_segment", [_P, _P, _P, _P, _P, _L, _I, _I,
                                               _P]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}


def resolve_device(device=None) -> torch.device:
    """The device rule of the port's entry points: the card unless the
    caller names another device.  Raises when the card is asked for (also
    by default) and CUDA is unavailable; never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gndnet_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def source_digest(name: str) -> str:
    """The hash of `csrc/<name>.cu` and the flags, which names its library."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{source_digest(name)}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, temporary output, final path)."""
    path = _lib_path(name)
    if os.path.exists(path):
        return None, None, path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, path


def _finish_build(name: str, proc, tmp: str, path: str) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, path)


def sources() -> list[str]:
    return sorted({lib for lib, _ in SIGNATURES.values()})


@contextlib.contextmanager
def _build_lock():
    """This process's lock, then an exclusive `flock` on `_build/.lock`:
    builds in several processes at once (the ranks of a multi-process
    run) take turns, and a process that waited finds the library the
    first one built instead of building it again."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> float:
    """Compile every kernel source that has no current library, one nvcc
    per source, all started together.  Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with _build_lock():
        started = [(name, *_start_build(name)) for name in sources()]
        try:
            for name, proc, tmp, path in started:
                _finish_build(name, proc, tmp, path)
        finally:
            for _, proc, _, _ in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return time.perf_counter() - t0


def function(entry: str):
    """The C entry `entry`, building and loading its library on first use."""
    fn = _fns.get(entry)
    if fn is not None:
        return fn
    lib_name, argtypes = SIGNATURES[entry]
    with _build_lock():
        lib = _libs.get(lib_name)
        if lib is None:
            _finish_build(lib_name, *_start_build(lib_name))
            lib = ctypes.CDLL(_lib_path(lib_name))
            _libs[lib_name] = lib
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(code: int, entry: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {code}")


def require_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on the CUDA device")
