"""Stage-level profile of the affine serving path on the card.

    python -m gndnet_tpu_torch.profile_affine [--only S] [--reps N]
        [--out FILE]

The counterpart of `scripts/profile_affine.py` (with the segmented
broadcast case of `scripts/probe_train.py`): each case times one stage of
the affine path, or one kernel alone, at kitti_sem's serving shapes
(102 400-point padded scans, bf16, 'default' precision, random weights
from a seed) and, for the fine_grid cases, at fine_grid's (250x250 cells,
where the packed key overflows and K10 sorts).  Scans come from
`synthetic.py`.  Every case prints one JSON line: its mean milliseconds
per call by CUDA events over `--reps` warm calls (the host's launch time
included where the card waits for it), the device milliseconds and device
operations per call by torch.profiler over as many calls, and the card's
name and power limit as nvidia-smi gives them.  `--only S` runs the cases
whose name contains S.

The JAX script sweeps the chunk size of each TPU kernel (512-2048 lanes);
the card's kernels tile by their own rules, so the sweep collapses to one
case per type: `kernel_only_102k_{f32,bf16}` (K8) and `kernel_t_102k`
(K2).  The training scans have cases of their own at kitti_sem's B=2
shapes, `argmax_packed_B2` (K5) and `argmax_pair_B2_f32` (K4), with K6
on their argmax rows (`dmmat_B2_bf16`, `dmmat_B2_f32`), and K3 has
`histogram_counts_102k` beside the `histogram_ends_*` cases.  The
`*_empty20k`, `*_u10x20k` and `*_one5000*` cases run K4, K5 and K6 on
20 000 cells that are all empty, that hold 10 rows each, or of which one
holds 5 000 rows: what each costs apart from the data's run lengths.
K8 and K9 also run on one cell throughout (`*_onecell`: every tile
carries a run from the tiles before it), and K9 on the payload table
`probe_train.py` broadcasts (`bcast_128x1.6M_payload`: each run's value
at its first row, -3e38 elsewhere); `bcast_128x1.6M_copy` copies the
table (`clone`), the bytes K9 must move, as the card's practical rate for
them.  Each line also splits the device time by kernel name
(`device_kernels`, ms a call).
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from gndnet_tpu_torch.config import fine_grid_config, kitti_sem_config
from gndnet_tpu_torch.infer import GroundInferenceEngine
from gndnet_tpu_torch.ops import affine, affine_aux, sort
from gndnet_tpu_torch.ops import pillarize as pz
from gndnet_tpu_torch.ops.postproc import segment_cloud
from gndnet_tpu_torch.profile_serve import card, kernel_times
from gndnet_tpu_torch.synthetic import synthetic_scan
from gndnet_tpu_torch.weights import init_state_dict

BCAST_SHAPE = (128, 16 * 100_352)   # probe_train.py's (C, B * Np) table
K8_CASES = ("kernel_only_102k_f32", "kernel_only_102k_bf16",
            "kernel_only_102k_f32_onecell", "kernel_only_102k_bf16_onecell")
K9_CASES = ("bcast_128x1.6M", "bcast_128x1.6M_onecell",
            "bcast_128x1.6M_payload", "bcast_128x1.6M_copy")
K10_CASES = ("affine_canvas_fine_grid", "sort2_idx_gather_102k")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean milliseconds of fn() over `reps` warm calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serving_config(base):
    """`base` at the serving settings of the affine main path (bf16 convs,
    'default' precision, 'affine')."""
    return base.replace(compute_dtype="bfloat16", matmul_precision="default",
                        fused_impl="affine")


class Setup:
    """The engines, scans and kernel inputs the cases share, made once
    from fixed seeds on the engines' device (the card): kitti_sem and
    fine_grid at the serving settings unless other configurations are
    given, `n`-point scans."""

    def __init__(self, cfg=None, fine_cfg=None, n: int = 100_000,
                 bcast_shape=BCAST_SHAPE):
        self.cfg = cfg or serving_config(kitti_sem_config())
        self.engine = GroundInferenceEngine(
            self.cfg, init_state_dict(self.cfg, seed=0))
        dev = self.device = self.engine.device
        rng = np.random.default_rng(0)
        self.scans = [synthetic_scan(self.cfg, rng, n) for _ in range(16)]
        self.padded = [torch.from_numpy(self.engine._prepare(s)[0]).to(dev)
                       for s in self.scans]
        self.pts = self.engine.device_points(self.padded[0])
        self.pts16 = self.engine.device_points(torch.stack(self.padded))
        self.fine_cfg = fine_cfg or serving_config(fine_grid_config())
        self.fine = GroundInferenceEngine(
            self.fine_cfg, init_state_dict(self.fine_cfg, seed=0))
        fine_padded = self.fine._prepare(synthetic_scan(self.fine_cfg, rng,
                                                        n))[0]
        self.fine_padded = torch.from_numpy(fine_padded).to(dev)
        self.fine_pts = self.fine.device_points(self.fine_padded)
        self.bcast_shape = bcast_shape
        self._bcast = None
        self._payload = None
        self._one = None
        self._argmax = None
        self._dmmat = {}
        self._variants = {}

        # the JAX profile's kernel inputs at the padded scan length: sorted
        # random cells of the grid, pts8 [xyz ~ N(0, 1), kept 1, extra ~
        # U(0, 1), 0, 0, 0], mmat8 ~ N(0, 0.3^2) (8, 64)
        n_pad, cells = self.pts.shape[0], self.cfg.ny * self.cfg.nx
        self.cell_k = torch.from_numpy(np.sort(
            np.random.default_rng(1).integers(0, cells + 1, n_pad)).astype(
                np.int32)).to(dev)
        pts8 = np.concatenate(
            [np.random.default_rng(2).normal(size=(n_pad, 3)),
             np.ones((n_pad, 1)),
             np.random.default_rng(3).uniform(size=(n_pad, 1)),
             np.zeros((n_pad, 3))], axis=1).astype(np.float32)
        self.pts8 = torch.from_numpy(pts8).to(dev)
        self.mmat8 = torch.from_numpy((np.random.default_rng(4).normal(
            size=(8, 64)) * 0.3).astype(np.float32)).to(dev)
        self.cell_one = torch.zeros_like(self.cell_k)
        counts = affine.histogram_counts_plain(self.cell_k[None],
                                               self.cfg.ny, self.cfg.nx)
        self.counts_k = counts.reshape(-1)
        self.starts_k = (torch.cumsum(self.counts_k, 0)
                         - self.counts_k).to(torch.int32)

    def broadcast_inputs(self):
        """probe_train.py's broadcast table: sorted random cells and
        N(0, 1) values (C, B * Np), made on first use (1.6 GB)."""
        if self._bcast is None:
            c, n = self.bcast_shape
            cell = np.sort(np.random.default_rng(5).integers(
                0, self.cfg.ny * self.cfg.nx + 1, n)).astype(np.int32)
            gen = torch.Generator(self.device).manual_seed(5)
            vals = torch.randn(c, n, generator=gen, device=self.device)
            self._bcast = (torch.from_numpy(cell).to(self.device), vals)
        return self._bcast

    def broadcast_payload(self):
        """`broadcast_inputs()` with each run's value at its first row and
        -3e38 (dominated) elsewhere, as probe_train.py broadcasts a
        per-cell payload; made on first use."""
        if self._payload is None:
            cell, vals = self.broadcast_inputs()
            starts = torch.ones_like(cell, dtype=torch.bool)
            starts[1:] = cell[1:] != cell[:-1]
            self._payload = torch.where(starts, vals, -3.0e38)
        return self._payload

    def broadcast_one_cell(self):
        """Cell ids of `broadcast_inputs()`'s length, all one cell."""
        if self._one is None:
            self._one = torch.zeros_like(self.broadcast_inputs()[0])
        return self._one

    def argmax_inputs(self):
        """K4/K5's inputs at kitti_sem's B=2 training shapes (20 000
        cells), made on first use: the first two scans' cell-sorted
        stream, run starts and counts, and the PFN's per-point matrix."""
        if self._argmax is None:
            model = self.engine.model
            pts = self.pts16[:2]
            ctx = pz.bin_points_batch(pts, model.geom)
            spts, starts, counts = pz.cell_stream(
                pts.reshape(-1, pts.shape[-1]), ctx, model.geom)
            kernel, bias = (model.voxel_feature_extractor.pfn_layers[0]
                            .effective_affine())
            mmat = pz.affine_pfn_weights(kernel, bias, pts.shape[-1],
                                         model.geom,
                                         self.cfg.with_distance)[0]
            self._argmax = (spts.contiguous(), starts, counts,
                            mmat.detach().float().contiguous())
        return self._argmax

    def dmmat_inputs(self, dtype):
        """K6's inputs on `argmax_inputs()`: the stream, the argmax rows of
        K5 (bf16, cap) or K4 (f32), a seeded N(0, 1) d_smax in `dtype`, and
        the counts; made on first use."""
        if dtype not in self._dmmat:
            spts, starts, counts, mmat = self.argmax_inputs()
            cap = self.cfg.max_points_voxel
            fn = (affine.affine_scan_argmax_packed
                  if dtype == torch.bfloat16
                  else affine.affine_scan_argmax_pair)
            _, smax, pos = fn(spts, starts, counts, mmat, cap, dtype)
            gen = torch.Generator(self.device).manual_seed(6)
            d = torch.randn(smax.shape, generator=gen,
                            device=self.device).to(dtype)
            self._dmmat[dtype] = (spts, pos, d, counts)
        return self._dmmat[dtype]

    def variant_inputs(self, kind: str):
        """(pts, starts, counts) of 20 000 cells, kitti_sem's B=2 count,
        with 4 N(0, 10^2) features a row: 'empty' (no rows), 'u10' (10
        rows each), 'one5000' (one cell of 5 000 rows, the rest empty)."""
        if kind not in self._variants:
            ncells, per = 20_000, {"empty": 0, "u10": 10, "one5000": 0}[kind]
            counts = torch.full((ncells,), per, dtype=torch.int32,
                                device=self.device)
            if kind == "one5000":
                counts[ncells // 2] = 5000
            starts = (torch.cumsum(counts, 0) - counts).to(torch.int32)
            rows = max(int(counts.sum()), 1)
            gen = torch.Generator(self.device).manual_seed(7)
            pts = torch.randn((rows, 4), generator=gen,
                              device=self.device) * 10
            self._variants[kind] = (pts, starts, counts)
        return self._variants[kind]

    def variant_dmmat(self, kind: str):
        """K6's inputs on `variant_inputs(kind)`: K5's argmax rows (cap
        4096) and a seeded bf16 d_smax."""
        key = ("dmmat", kind)
        if key not in self._variants:
            pts, starts, counts = self.variant_inputs(kind)
            mmat = self.argmax_inputs()[3]
            _, smax, pos = affine.affine_scan_argmax_packed(
                pts, starts, counts, mmat, affine.PACKED_MAX_CAP,
                torch.bfloat16)
            gen = torch.Generator(self.device).manual_seed(8)
            d = torch.randn(smax.shape, generator=gen,
                            device=self.device).to(torch.bfloat16)
            self._variants[key] = (pts, pos, d, counts)
        return self._variants[key]

    def sorted_gather(self, pts, geom, pair: bool):
        """Bin, sort the (cell, index) keys of one scan (K1 on the packed
        key, or K10 on the pair), gather the rows."""
        ctx = pz.bin_points(pts, geom)
        n = pts.shape[0]
        local = torch.where(ctx.valid, ctx.cell, geom.num_cells_3d)
        iota = torch.arange(n, dtype=torch.int32, device=pts.device)
        if pair:
            _, order = sort.sort2_i32(local, iota)
        else:
            idxcap = 1 << max(n - 1, 1).bit_length()
            skey = sort.sort_i32((local * idxcap + iota).to(torch.int32))
            order = skey % idxcap
        return pts[order.long()]


def cases(s: Setup) -> dict:
    """Case name -> a function that runs it once on the card."""
    cfg, model, geom, dev = s.cfg, s.engine.model, s.engine.model.geom, \
        s.device
    elev = torch.zeros((cfg.nx, cfg.ny), device=dev)
    canvas0 = torch.zeros((1, cfg.ny, cfg.nx, 64), dtype=torch.bfloat16,
                          device=dev)
    fine_canvas0 = torch.zeros((1, s.fine_cfg.ny, s.fine_cfg.nx, 64),
                               dtype=torch.bfloat16, device=dev)
    n_pad, cells = s.pts.shape[0], cfg.ny * cfg.nx
    loc = torch.sort(torch.from_numpy(np.random.default_rng(0).integers(
        0, cells + 1, (1, n_pad)).astype(np.int32)).to(dev), dim=-1).values
    loc16 = torch.sort(torch.from_numpy(np.random.default_rng(0).integers(
        0, cells + 1, (16, n_pad)).astype(np.int32)).to(dev), dim=-1).values
    fine_cells = s.fine_cfg.ny * s.fine_cfg.nx
    loc_fine = torch.sort(torch.from_numpy(np.random.default_rng(0).integers(
        0, fine_cells + 1, (1, n_pad)).astype(np.int32)).to(dev),
        dim=-1).values
    cap = cfg.max_points_voxel
    pts4 = s.pts8[:, :4].contiguous()
    mmat4 = s.mmat8[:4].contiguous()

    def canvas(net, pts):
        return net.canvas(pts[None])

    def variant(kind, packed, cap, dtype):
        def fn():
            pts, starts, counts = s.variant_inputs(kind)
            mmat = s.argmax_inputs()[3]
            scan = (affine.affine_scan_argmax_packed if packed
                    else affine.affine_scan_argmax_pair)
            return scan(pts, starts, counts, mmat, cap, dtype)
        return fn

    def fwd_plus_segment():
        pred = model.fused(s.pts[None])[0]
        return segment_cloud(s.pts, cfg.grid_range, cfg.voxel_size[0],
                             pred.t(), s.engine.threshold)

    def bin_sort():
        ctx = pz.bin_points(s.pts, geom)
        local = torch.where(ctx.valid, ctx.cell, geom.num_cells_3d)
        order = torch.sort(local, stable=True).indices
        return s.pts[order]

    def sort_b16():
        ctx = pz.bin_points_batch(s.pts16, geom)
        return pz.cell_stream(s.pts16.reshape(-1, 4), ctx, geom)

    return {
        "fused_fwd_102k": lambda: model.fused(s.pts[None]),
        "fused_fwd_B16": lambda: model.fused(s.pts16),
        "segment_cloud_102k": lambda: segment_cloud(
            s.pts, cfg.grid_range, cfg.voxel_size[0], elev, 0.08),
        "bin_sort_102k": bin_sort,
        "affine_canvas_102k": lambda: canvas(model, s.pts),
        "affine_canvas_fine_grid": lambda: canvas(s.fine.model,
                                                  s.fine_pts),
        "segnet_100x100": lambda: model.encoder_decoder(canvas0),
        "segnet_250x250": lambda: s.fine.model.encoder_decoder(
            fine_canvas0),
        "histogram_ends_102k": lambda: affine.histogram_ends(
            loc, cfg.ny, cfg.nx),
        "histogram_ends_B16": lambda: affine.histogram_ends(
            loc16, cfg.ny, cfg.nx),
        "histogram_ends_fine_grid": lambda: affine.histogram_ends(
            loc_fine, s.fine_cfg.ny, s.fine_cfg.nx),
        "histogram_counts_102k": lambda: affine.histogram_counts(
            loc, cfg.ny, cfg.nx),
        "argmax_packed_B2": lambda: affine.affine_scan_argmax_packed(
            *s.argmax_inputs(), cap, torch.bfloat16),
        "argmax_pair_B2_f32": lambda: affine.affine_scan_argmax_pair(
            *s.argmax_inputs(), cap, torch.float32),
        "dmmat_B2_bf16": lambda: affine.affine_bwd_dmmat(
            *s.dmmat_inputs(torch.bfloat16), torch.bfloat16),
        "dmmat_B2_f32": lambda: affine.affine_bwd_dmmat(
            *s.dmmat_inputs(torch.float32), torch.float32),
        "argmax_pair_f32_empty20k": variant("empty", False, cap,
                                            torch.float32),
        "argmax_pair_f32_u10x20k": variant("u10", False, cap,
                                           torch.float32),
        "argmax_pair_f32_one5000_nocap": variant("one5000", False, None,
                                                 torch.float32),
        "argmax_packed_empty20k": variant("empty", True, cap,
                                          torch.bfloat16),
        "argmax_packed_u10x20k": variant("u10", True, cap, torch.bfloat16),
        "argmax_packed_one5000_cap4096": variant(
            "one5000", True, affine.PACKED_MAX_CAP, torch.bfloat16),
        **{f"dmmat_bf16_{name}": (lambda kind=kind: affine.affine_bwd_dmmat(
            *s.variant_dmmat(kind), torch.bfloat16))
           for name, kind in (("empty20k", "empty"), ("u10x20k", "u10"),
                              ("one5000", "one5000"))},
        "kernel_only_102k_f32": lambda: affine_aux.affine_segment_scan(
            s.cell_k, s.pts8, s.mmat8, out_dtype=torch.float32,
            chunk=1024),
        "kernel_only_102k_bf16": lambda: affine_aux.affine_segment_scan(
            s.cell_k, s.pts8, s.mmat8, out_dtype=torch.bfloat16,
            chunk=1024),
        **{f"kernel_only_102k_{name}_onecell": (
            lambda dtype=dtype: affine_aux.affine_segment_scan(
                s.cell_one, s.pts8, s.mmat8, out_dtype=dtype, chunk=1024))
           for name, dtype in (("f32", torch.float32),
                               ("bf16", torch.bfloat16))},
        "kernel_t_102k": lambda: affine.affine_scan_gather(
            pts4, s.starts_k, s.counts_k, mmat4, 100, torch.bfloat16),
        "kernel_t_102k_nocap": lambda: affine.affine_scan_gather(
            pts4, s.starts_k, s.counts_k, mmat4, None, torch.bfloat16),
        "sort1_packed_gather_102k": lambda: s.sorted_gather(
            s.pts, geom, pair=False),
        "sort2_idx_gather_102k": lambda: s.sorted_gather(
            s.pts, geom, pair=True),
        "sort2_idx_gather_fine_grid": lambda: s.sorted_gather(
            s.fine_pts, s.fine.model.geom, pair=True),
        "engine_run_102k": lambda: s.engine.run(s.padded[0]),
        "engine_run_fine_grid": lambda: s.fine.run(s.fine_padded),
        "fwd_plus_segment_102k": fwd_plus_segment,
        "sort_B16": sort_b16,
        "infer_many_K16": lambda: s.engine.infer_many(s.scans, eager=True),
        "infer_many_K16_graph": lambda: s.engine.infer_many(s.scans),
        "bcast_128x1.6M": lambda: affine_aux.segment_broadcast_t(
            *s.broadcast_inputs(), chunk=2048),
        "bcast_128x1.6M_onecell": lambda: affine_aux.segment_broadcast_t(
            s.broadcast_one_cell(), s.broadcast_inputs()[1], chunk=2048),
        "bcast_128x1.6M_payload": lambda: affine_aux.segment_broadcast_t(
            s.broadcast_inputs()[0], s.broadcast_payload(), chunk=2048),
        "bcast_128x1.6M_copy": lambda: s.broadcast_inputs()[1].clone(),
    }


def run(only=(), reps: int = 20, setup: Setup | None = None) -> list:
    """Time the cases whose name contains one of `only` (all when empty);
    returns the JSON lines."""
    smi = card()
    setup = setup or Setup()
    lines = []
    for name, fn in cases(setup).items():
        if only and not any(o in name for o in only):
            continue
        with torch.no_grad():
            ms = time_ms(fn, reps=reps, warm=2)
            device = kernel_times(fn, reps)
        line = {"case": name, "ms": ms,
                "device_ms": device.get("device_ms_per_call", "not measured"),
                "device_ops": device.get("device_ops_per_call",
                                         "not measured"),
                "device_kernels": {
                    k["kernel"]: k["ms_per_call"]
                    for k in device.get("top", [])[:6]},
                "reps": reps, "card": smi}
        if name.startswith("infer_many_K16"):
            line["ms_per_scan"] = ms / len(setup.scans)
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", action="append", default=[],
                    help="run the cases whose name contains this string "
                         "(repeatable)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_affine needs a CUDA device")
    lines = [{"card": card(), "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    lines += run(args.only, args.reps)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
