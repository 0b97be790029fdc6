"""Readers of the program's own host spans (`gndnet.<layer>.<stage>`, from
`gndnet_tpu_torch.utils.profiling.span`) in the trace of a `--trace 1`
run on the card.  The spans and the device operations come from one
`torch.profiler` session, so they share kineto's clock.  Every cell serves
or trains from one thread, so spans of one name do not overlap.  Per unit
means over the units completed in the traced window, as
`device.per_unit_ms` counts them.  None where the run had no traced window
or the program recorded no such span (a program without spans).
"""

from __future__ import annotations

import numpy as np

from perfbench.readers.device import _traced, _units_traced


def _intervals(run, name: str) -> np.ndarray:
    """(k, 2) [start, end) ns of the host spans called `name`, by start."""
    iv = np.array([(s, e) for s, e, n in run.trace.host if n == name],
                  np.int64).reshape(-1, 2)
    return iv[np.argsort(iv[:, 0], kind="stable")]


def _merge(iv: np.ndarray) -> np.ndarray:
    """The union of intervals sorted by start, as disjoint intervals."""
    if not len(iv):
        return iv
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
    return np.stack([iv[new, 0], ends[last]], 1)


def _overlap(outer: np.ndarray, disjoint: np.ndarray) -> np.ndarray:
    """ns of each interval of `outer` that the sorted disjoint intervals
    cover."""
    if not len(disjoint) or not len(outer):
        return np.zeros(len(outer), np.int64)
    starts, ends = disjoint[:, 0], disjoint[:, 1]
    before = np.concatenate([[0], np.cumsum(ends - starts)])

    def covered_until(t):
        i = np.searchsorted(starts, t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.where(i > 0, np.clip(t - starts[j], 0, ends[j] - starts[j]),
                        0)
        return before[j] + part

    return covered_until(outer[:, 1]) - covered_until(outer[:, 0])


def _self_ns(run, span: str, less) -> np.ndarray | None:
    """ns of each `span`, less what the spans named in `less` cover
    inside it; None without a traced window or without such spans."""
    if not _traced(run):
        return None
    iv = _intervals(run, span)
    if not len(iv):
        return None
    inner = np.concatenate([np.zeros((0, 2), np.int64)]
                           + [_intervals(run, n) for n in less])
    inner = _merge(inner[np.argsort(inner[:, 0], kind="stable")])
    return (iv[:, 1] - iv[:, 0]) - _overlap(iv, inner)


def host_ms(run, span: str, less=(), per: str = "unit"):
    """Host milliseconds in `span` (less the spans `less` inside it) per
    unit completed in the traced window ('unit'), or per call of `batch`
    units ('call')."""
    ns = _self_ns(run, span, less)
    units = _units_traced(run) if ns is not None else 0
    if not units:
        return None
    scale = run.shape["batch"] if per == "call" else 1
    return float(ns.sum()) / 1e6 * scale / units


def host_percentile_ms(run, span: str, q: float, less=()):
    """The q-th percentile, over the spans of the traced window, of a
    `span`'s host milliseconds less the spans `less` inside it."""
    ns = _self_ns(run, span, less)
    return None if ns is None else float(np.percentile(ns, q)) / 1e6


def idle_in_pct(run, span: str):
    """The share of the traced window in which the host was inside `span`
    and no device operation ran."""
    if not _traced(run):
        return None
    inside = _merge(_intervals(run, span))
    if not len(inside):
        return None
    idle = (inside[:, 1] - inside[:, 0]) - _overlap(
        inside, run.trace.busy_intervals())
    return 100.0 * float(idle.sum()) / 1e9 / run.trace.window_s


def graph_hit_pct(run):
    """Calls of a graphed program in the traced window that replayed a
    graph captured before: 100 x (calls - captures - eager runs) / calls,
    where calls are its `gndnet.graph.replay` and `gndnet.graph.eager`
    spans (a capture is followed by the replay of what it captured)."""
    if not _traced(run):
        return None
    names = [n for _, _, n in run.trace.host]
    replays, eager, captures = (names.count("gndnet.graph." + k)
                                for k in ("replay", "eager", "capture"))
    calls = replays + eager
    if not calls:
        return None
    return 100.0 * (calls - captures - eager) / calls
