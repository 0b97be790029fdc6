"""The benchmark's spans and its device trace.

`Trace` runs `torch.profiler` (CPU and CUDA activities, CUPTI on the card)
over the traced window of a `--trace 1` run: the last TRACE_SECONDS of the
measured window, or all of it when shorter, so that reading the trace
stays well inside a run's time limit.  `span(name)` marks a call into a
layer of the program (`perfbench.<layer>`) in that trace; outside the
traced window it costs nothing.  Reading the trace gives every device
operation (kernels, copies, fills; not the annotations the profiler mirrors
onto the device) and every host span, on one clock.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

TRACE_SECONDS = 3.0
BREAKDOWN_ENTRIES = 10
ATTRIBUTED_GAPS = 2000


def _annotation(e) -> bool:
    """Whether a device event is a host span the profiler mirrors onto the
    device (not an operation that ran there)."""
    is_user = getattr(e, "is_user_annotation", None)
    kind = getattr(e, "activity_type", None)
    return bool((is_user is not None and is_user())
                or (kind is not None and kind() == "gpu_user_annotation")
                or e.name().startswith("perfbench."))


class Trace:
    """The profiler over [start(), stop()] on the card; inert when off."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds = TRACE_SECONDS
        self.active = False
        self.prof = None
        self.t_start = self.t_stop = None
        self.device = []      # [(start_ns, end_ns, name)] device operations
        self.host = []        # [(start_ns, end_ns, name)] host events

    def _profile(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities)

    def warm(self, fn) -> None:
        """One short profiled call of fn(), so that the window's start
        finds the profiler's own set-up done."""
        if not self.enabled:
            return
        with self._profile():
            fn()

    def start(self) -> None:
        if not self.enabled or self.active or self.t_stop is not None:
            return
        self.prof = self._profile()
        self.prof.__enter__()
        self.active = True
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        """End the traced window (after the device has finished) and read
        its events."""
        if not self.active:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.active = False
        for e in self.prof.profiler.kineto_results.events():
            item = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type().name == "CPU":
                self.host.append(item)
            elif not _annotation(e):
                self.device.append(item)
        self.prof = None

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("perfbench." + name)

    @property
    def window_s(self) -> float | None:
        if self.t_stop is None:
            return None
        return self.t_stop - self.t_start

    def busy_intervals(self) -> np.ndarray:
        """(k, 2) merged [start, end) ns of device activity."""
        if not self.device:
            return np.zeros((0, 2), np.int64)
        iv = np.array([(s, e) for s, e, _ in self.device], np.int64)
        iv = iv[np.argsort(iv[:, 0], kind="stable")]
        ends = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > ends[:-1]
        starts = iv[new, 0]
        last = np.append(np.flatnonzero(new)[1:] - 1, len(iv) - 1)
        return np.stack([starts, ends[last]], 1)

    @property
    def busy_s(self) -> float | None:
        if self.t_stop is None:
            return None
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e9

    def device_ops(self) -> list:
        """[[name, seconds], ...]: device time by operation name, the
        largest first."""
        by = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> list:
        """[[host activity, seconds], ...]: the idle gaps between device
        operations, summed by the innermost host event running at each
        gap's midpoint (the ATTRIBUTED_GAPS longest gaps; the others under
        'shorter gaps'), the largest first."""
        iv = self.busy_intervals()
        if len(iv) < 2:
            return []
        gs, ge = iv[:-1, 1], iv[1:, 0]
        length = ge - gs
        order = np.argsort(-length, kind="stable")
        named = order[:ATTRIBUTED_GAPS]
        hs = np.array([h[0] for h in self.host] or [0], np.int64)
        he = np.array([h[1] for h in self.host] or [0], np.int64)
        by = {}
        for i in named:
            mid = (gs[i] + ge[i]) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            if self.host and len(cover):
                name = self.host[cover[np.argmin(he[cover] - hs[cover])]][2]
            else:
                name = "no host event"
            by[name] = by.get(name, 0) + int(length[i])
        rest = int(length[order[ATTRIBUTED_GAPS:]].sum())
        if rest:
            by["shorter gaps"] = rest
        top = sorted(by.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return [[name, ns / 1e9] for name, ns in top]

    def kernels(self) -> list:
        """[(name, seconds)] of every device kernel, in time order."""
        return [(name, (e - s) / 1e9) for s, e, name in self.device]
