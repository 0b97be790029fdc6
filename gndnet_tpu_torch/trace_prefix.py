"""Where a K8 block's time goes on the card, phase by phase.

    python -m gndnet_tpu_torch.trace_prefix [--out FILE]

Builds a copy of `csrc/prefix_segment.cu` whose K8 kernel writes the
card's %globaltimer (ns) at the end of each phase, one row a tile, runs it
on the affine profile's K8 inputs (`profile_affine.Setup`'s seeds: 102 400
rows over 10 001 uniform random cells, (8, 64) weights) and on one cell
throughout, f32 and bf16 out, checks every output against the plain
version to the bit, and prints one JSON line a case: the span of the
launch and, for each phase, the mean, median and largest microseconds of
a tile (stamps at block barriers, read by thread 0; the timer ticks in
fractions of a microsecond, so short phases read coarse).  Phases:
`stage` (ticket to staged rows, cells, mmat8 and run-start bits),
`scan` (the sums' slices and the maxima's segment tails), `publish`
(carries inside the tile, the aggregate and its flag), `early_out` (rows
past the tile's first run), `look_back` (the carry from the tiles before
and its fold), `late_out` (the tile's first run).  Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from gndnet_tpu_torch import _ext
from gndnet_tpu_torch.ops import affine_aux
from gndnet_tpu_torch.profile_serve import card

STAMPS = 8
# (text of the kernel, stamp written just after it)
_MARKS = [
    ("  if (tid == 0) {\n    s_ticket = take_ticket(a.sy);\n"
     "    s_first = a.T;\n  }\n  __syncthreads();\n", 0),
    ("  const float* pa = BF16 ? sptsr : spts;   // the product's operands\n",
     1),
    ("    mtail[tid] = v;\n  }\n  __syncthreads();\n", 2),
    ("      publish(a.sy, flags + t, tcont && whole ? AGGREGATE : FINAL);\n",
     3),
    ("  if (whole && tid == 0) publish(a.sy, flags + t, INCLUSIVE);\n", 5),
]
_PHASES = (("stage", 0, 1), ("scan", 1, 2), ("publish", 2, 3),
           ("early_out", 3, 4), ("look_back", 4, 5), ("late_out", 5, 6))


def instrumented_source() -> str:
    """csrc/prefix_segment.cu with the K8 stamps; raises if the kernel no
    longer has a marked place."""
    with open(os.path.join(_ext.CSRC, "prefix_segment.cu")) as f:
        src = f.read()
    head = "namespace {\n"
    src = src.replace(head, head + (
        "__device__ unsigned long long* g_trace;\n"
        "__device__ __forceinline__ void stamp(unsigned ticket, int k) {\n"
        "  unsigned long long t;\n"
        "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
        f"  if (threadIdx.x == 0 && g_trace) g_trace[ticket * {STAMPS} + k]"
        " = t;\n}\n"
        "#define STAMP(k) stamp(s_ticket, k);\n"), 1)
    for text, k in _MARKS:
        if text not in src:
            raise RuntimeError(f"trace_prefix: mark {k} not found")
        src = src.replace(text, text + f"  STAMP({k})\n", 1)
    for text, stamp in (("  if (!tcont) return;\n", 4),
                        ("    max_out(rs0, min(rs1, first), v);\n  }\n}\n",
                         6)):
        if text not in src:
            raise RuntimeError(f"trace_prefix: mark {stamp} not found")
        barrier = f"  __syncthreads();\n  STAMP({stamp})\n"
        src = src.replace(text, barrier + text if stamp == 4
                          else text[:-2] + barrier + "}\n", 1)
    return src + ('\nextern "C" int set_trace(void* p) {\n'
                  '  return cudaMemcpyToSymbol(g_trace, &p, sizeof(p));\n}\n')


def build() -> ctypes.CDLL:
    os.makedirs(_ext.BUILD_DIR, exist_ok=True)
    src = os.path.join(_ext.BUILD_DIR, "trace_prefix.cu")
    lib = os.path.join(_ext.BUILD_DIR, "libtrace_prefix.so")
    with open(src, "w") as f:
        f.write(instrumented_source())
    subprocess.run([_ext._nvcc(), *_ext.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def inputs(dev):
    """profile_affine.Setup's K8 inputs at kitti_sem's padded scan."""
    n, cells = 102_400, 100 * 100
    cell = np.sort(np.random.default_rng(1).integers(0, cells + 1, n))
    pts8 = np.concatenate(
        [np.random.default_rng(2).normal(size=(n, 3)), np.ones((n, 1)),
         np.random.default_rng(3).uniform(size=(n, 1)), np.zeros((n, 3))],
        axis=1).astype(np.float32)
    mmat8 = (np.random.default_rng(4).normal(size=(8, 64)) * 0.3).astype(
        np.float32)
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (cell.astype(np.int32), pts8, mmat8))


def run(lib, dev="cuda") -> list:
    fn = lib.affine_segment_scan
    fn.argtypes = _ext.SIGNATURES["affine_segment_scan"][1]
    fn.restype = ctypes.c_int
    lib.set_trace.argtypes = [ctypes.c_void_p]
    cell, pts8, mmat8 = inputs(dev)
    n, width = pts8.shape[0], mmat8.shape[1]
    tile, _, chunks, tiles, _ = affine_aux.k8_layout(n, 4 + width)
    trace = torch.zeros(chunks * tiles * STAMPS, dtype=torch.int64,
                        device=dev)
    _ext.check(lib.set_trace(trace.data_ptr()), "set_trace")
    lines = []
    for name, c in (("random_cells", cell), ("one_cell",
                                              torch.zeros_like(cell))):
        for dtype in (torch.float32, torch.bfloat16):
            tot = torch.empty((n, 4), device=dev)
            amax = torch.empty((n, width), dtype=dtype, device=dev)
            scratch = torch.empty((2, tiles, 4 + width), device=dev)
            for _ in range(3):          # the last call's stamps are read
                trace.zero_()
                sync, epoch = affine_aux._sync(dev, chunks * tiles)
                _ext.check(fn(c.data_ptr(), pts8.data_ptr(),
                              mmat8.data_ptr(), tot.data_ptr(),
                              amax.data_ptr(), scratch.data_ptr(),
                              sync.data_ptr(), n, width, tile, epoch,
                              int(dtype == torch.bfloat16),
                              _ext.stream_ptr(tot)), "trace_prefix")
            torch.cuda.synchronize()
            want = affine_aux.affine_segment_scan_plain(
                c, pts8, mmat8, out_dtype=dtype, chunk=1)
            same = torch.equal(tot, want[0]) and torch.equal(amax, want[1])
            st = trace.view(-1, STAMPS).cpu().numpy().astype(np.float64)
            t0 = st[:, 0].min()
            end = np.maximum(st[:, 4], st[:, 6])
            line = {"case": f"k8_{name}_{str(dtype)[6:]}",
                    "equal_to_plain": same, "tiles": int(st.shape[0]),
                    "span_us": (end.max() - t0) / 1e3, "card": card()}
            for phase, i, j in _PHASES:
                ok = (st[:, i] > 0) & (st[:, j] > 0)
                d = (st[ok, j] - st[ok, i]) / 1e3
                if d.size:
                    line[phase] = {"tiles": int(d.size), "mean": d.mean(),
                                   "p50": float(np.median(d)),
                                   "max": d.max()}
            lines.append(line)
            print(json.dumps(line), flush=True)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_prefix needs a CUDA device")
    lines = run(build())
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    if not all(line["equal_to_plain"] for line in lines):
        raise SystemExit("trace_prefix: a traced output differs from the "
                         "plain version")


if __name__ == "__main__":
    main()
