"""Warm start: a persistent cache of the built kernels, and the artifact that
`GroundInferenceEngine.aot_save` writes and `aot_load` checks.

Counterpart of `gndnet_tpu.utils.compile_cache`.  In the JAX package a warm
start is a persistent XLA compilation cache plus a serialized executable of
the serving program for one padded shape.  On the card the port's cold start
is the nvcc build of `csrc/` and each kernel's first launch, and the
counterpart of a shape-specialised executable is one CUDA graph of the
engine's `run` per bucket shape, which `aot_load` captures on the engine's
device (a graph cannot be written to a file):

* `enable_compilation_cache(dir)` points `_ext`'s build directory at `dir`,
  so later processes load the libraries nvcc wrote there instead of
  building them again.
* `save_compiled(path, device, meta)` / `load_compiled(path, device)` write
  and check a single JSON file (written atomically) that records what the
  graph will be captured for: the platform, the torch and CUDA versions,
  the card's name and compute capability, the hash of every kernel source
  in `_ext.SIGNATURES`, and the caller's meta (the example shape and the
  transfer type).  `load_compiled` raises ValueError where any of them
  differs from what this process would build and run.
"""

from __future__ import annotations

import json
import os

import torch

from gndnet_tpu_torch import _ext

_AOT_MAGIC = "gndnet-torch-aot-v1"


def enable_compilation_cache(cache_dir: str) -> str:
    """Build and load the kernel libraries under `cache_dir` from now on.
    Returns the directory."""
    os.makedirs(cache_dir, exist_ok=True)
    _ext.BUILD_DIR = os.path.abspath(cache_dir)
    return _ext.BUILD_DIR


def _target(device) -> dict:
    """What a graph captured on `device` depends on."""
    dev = torch.device(device)
    target = {"platform": dev.type, "torch_version": torch.__version__,
              "cuda_version": torch.version.cuda,
              "kernels": {name: _ext.source_digest(name)
                          for name in _ext.sources()}}
    if dev.type == "cuda":
        target["device_name"] = torch.cuda.get_device_name(dev)
        target["capability"] = list(torch.cuda.get_device_capability(dev))
    return target


def save_compiled(path: str, device, meta: dict | None = None) -> int:
    """Write the artifact for `device` to `path`; returns its byte size."""
    payload = {"magic": _AOT_MAGIC, **_target(device),
               "meta": dict(meta or {})}
    data = json.dumps(payload, sort_keys=True).encode()
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)       # atomic: a crashed writer never half-writes
    return len(data)


def load_compiled(path: str, device) -> dict:
    """Check an artifact written by `save_compiled` against what `device`
    and this process would run; returns its meta.  Raises ValueError on a
    mismatch."""
    try:
        with open(path, "rb") as f:
            payload = json.loads(f.read())
    except (UnicodeDecodeError, json.JSONDecodeError):
        payload = None
    if not isinstance(payload, dict) or payload.get("magic") != _AOT_MAGIC:
        raise ValueError(f"{path} is not a gndnet AOT artifact")
    now = _target(device)
    if payload.get("platform") != now["platform"]:
        raise ValueError(
            f"AOT artifact was compiled for {payload.get('platform')!r}, "
            f"current device is {now['platform']!r}")
    if payload.get("torch_version") != now["torch_version"]:
        raise ValueError(
            f"AOT artifact was compiled with torch "
            f"{payload.get('torch_version')}, running {now['torch_version']} "
            f"(re-run aot_save)")
    for key in ("cuda_version", "capability"):
        if payload.get(key) != now.get(key):
            raise ValueError(
                f"AOT artifact was compiled for {key} {payload.get(key)}, "
                f"this process has {now.get(key)}")
    stale = sorted(name for name, digest in now["kernels"].items()
                   if payload.get("kernels", {}).get(name) != digest)
    if stale:
        raise ValueError(
            f"AOT artifact was compiled for other kernel sources: {stale} "
            f"changed since (re-run aot_save)")
    return payload.get("meta", {})
