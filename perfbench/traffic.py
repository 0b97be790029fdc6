"""The general generator: one driver per kind of loop, each read from a
cell's traffic file (`cells/<cell>.json`, key `driver`) and set by the
file's other keys.

- `open_loop`: `sensors` sensors each send a scan every `period_s`, at
  phases drawn once from `phase_seed` (the same set of arrivals for every
  run seed; the seed decides which sensor has which phase and which
  scenes it sends); one thread serves the scans in arrival order through
  the engine's `infer` and times each from its due time.
- `closed_pipelined`: one client keeps `depth` scans in flight through
  `infer_pipelined`.
- `closed_burst`: one client sends bursts of `burst` distinct scans
  through `infer_many`.
- `train_loader`: the graph train step at batch `batch`, handed a new
  host batch from a pool of `pool` labelled scans every step; its first
  `checked_steps` steps run in set-up and are held against the reference.

Every serving driver draws `pool` distinct scenes of exactly `points`
points (`scenes.py`, kind from the configuration's `scene`) and keeps the
answers to a seeded `sample` of them for the check.
"""

from __future__ import annotations

import collections
import json
import time

import numpy as np

from perfbench import reference, scenes, weights

MAP_PERCENTILES = (50, 75, 90, 99)
MAP_READINGS = tuple(f"map_p{q}" for q in MAP_PERCENTILES) + ("map_err",)
GIVE_UP_S = 60.0      # how long past the window's close a due scan may take
SPIN_S = 0.001        # the last stretch before a due time is spun, not slept


class Run:
    """What a driver measured: `window_s`, `units` completed in it, their
    host completion times `done`, per-unit or per-call host records in
    milliseconds (`records`), `attempted` and `failed`."""

    def __init__(self):
        self.window_s = None
        self.units = 0
        self.done = []
        self.records = collections.defaultdict(list)
        self.attempted = 0
        self.failed = 0


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.cell = ctx.cfg, ctx.cell
        self.rng = np.random.default_rng(ctx.seed)

    def weights(self) -> dict:
        return weights.make(self.cfg, self.ctx.seed, self.ctx.device)


class Serving(Driver):
    """Set-up and check common to the serving drivers."""

    def setup(self) -> None:
        ctx, cfg, cell = self.ctx, self.cfg, self.cell
        self.pool = [scenes.scene(cfg.scene, cfg, self.rng, cell["points"])
                     for _ in range(cell["pool"])]
        self.sample = sorted(int(i) for i in self.rng.choice(
            len(self.pool), size=min(cell["sample"], len(self.pool)),
            replace=False))
        self.answers = {}
        self.w = self.weights()
        infer = ctx.program.infer
        self.engine = infer.GroundInferenceEngine(
            ctx.program_cfg, dict(self.w), threshold=cell["threshold"],
            device=ctx.device)
        artifact = ctx.cache("aot", ctx.name + ".json")
        self.engine.aot_save(artifact, n=cell["points"])
        # the points a scan as the engine's kernels get them: its bucket
        with open(artifact) as f:
            self.padded = json.load(f)["meta"]["example_shape"][0]
        if cell.get("graph", True):
            self.engine.aot_load(artifact)
        self.warm()

    def scans(self) -> list:
        return self.pool

    def keep(self, i: int, answer) -> None:
        if i in self.sample:
            self.answers[i] = answer

    def release(self) -> None:
        self.engine = None

    def check(self) -> dict:
        """Each sampled scan against the reference, the worst scan's
        numbers.  The reference maps one scan at a time, whatever batch
        the program served it in.  map_p<q>: the q-th percentile of the
        map's gaps to the reference's map, over that map's largest
        magnitude; map_err: the largest gap,
        over the same; label_wrong: served labels that differ from the
        reference's labelling of the scan against the served map (exact),
        and every label of a sampled scan never answered; label_diff:
        labels that differ from the reference's labelling against its own
        map."""
        import torch

        cfg, cell, dev = self.cfg, self.cell, self.ctx.device
        thr = cell["threshold"]
        out = dict.fromkeys(MAP_READINGS, 0.0)
        out.update(label_wrong=0, label_diff=0)
        for i in self.sample:
            with torch.no_grad():
                elev, = reference.elevation(
                    cfg, self.w, torch.from_numpy(self.pool[i][None]).to(dev))
            self._compare(i, elev, thr, out)
        return out

    def _compare(self, i: int, elev, thr: float, out: dict) -> None:
        import torch

        cfg = self.cfg
        pts = torch.from_numpy(self.pool[i]).to(elev.device)
        got = self.answers.get(i)
        if got is not None:
            got_map = torch.from_numpy(np.asarray(got[0])).to(elev.device)
            got_lab = torch.from_numpy(np.asarray(got[1])).to(elev.device)
        if got is None or got_map.shape != elev.shape \
                or got_lab.shape != (len(pts),):
            out.update(dict.fromkeys(MAP_READINGS, float("inf")))
            out["label_wrong"] += len(pts)
            out["label_diff"] += len(pts)
            return
        with torch.no_grad():
            served, _ = reference.labels(cfg, pts, got_map, thr)
            own, _ = reference.labels(cfg, pts, elev, thr)
        gap = (got_map - elev).abs().double().flatten()
        scale = max(float(elev.abs().max()), 1e-30)
        q = torch.quantile(gap, torch.tensor(
            [p / 100 for p in MAP_PERCENTILES], dtype=gap.dtype,
            device=gap.device)) / scale
        for k, v in zip(MAP_READINGS, [*q.tolist(), float(gap.max()) / scale]):
            out[k] = max(out[k], v)
        out["label_wrong"] += int((got_lab != served).sum())
        out["label_diff"] += int((got_lab != own).sum())


class OpenLoop(Serving):
    def warm(self) -> None:
        for i in range(self.cell["warm"]):
            self.engine.infer(self.pool[i % len(self.pool)])

    def schedule(self, seconds: float) -> list:
        """[(due s from the window's start, pool id)] of every scan due in
        the window, in due order."""
        cell = self.cell
        s, period = cell["sensors"], cell["period_s"]
        phases = np.random.default_rng(cell["phase_seed"]).uniform(
            0.0, period, s)[self.rng.permutation(s)]
        first = self.rng.integers(0, len(self.pool), s)
        due = []
        for k in range(int(np.ceil(seconds / period)) + 1):
            for j in range(s):
                t = phases[j] + k * period
                if t < seconds:
                    due.append((t, int((first[j] + k) % len(self.pool))))
        due.sort()
        return due

    def window(self, seconds: float, trace) -> Run:
        run = Run()
        sched = self.schedule(seconds)
        run.attempted = len(sched)
        t0 = time.perf_counter()
        trace_at = t0 + max(0.0, seconds - trace.seconds)
        give_up = t0 + seconds + GIVE_UP_S
        last = t0
        for t_due, i in sched:
            due = t0 + t_due
            now = time.perf_counter()
            if now >= trace_at:
                trace.start()
            if now > give_up:
                break
            idle = now < due
            if idle:
                with trace.span("idle"):
                    if due - now > SPIN_S:
                        time.sleep(due - now - SPIN_S)
                    while time.perf_counter() < due:
                        pass
            start = time.perf_counter()
            with trace.span("engine.infer"):
                answer = self.engine.infer(self.pool[i])
            last = time.perf_counter()
            self.keep(i, answer)
            run.done.append(last)
            run.records["latency_ms"].append((last - due) * 1e3)
            run.records["queue_wait_ms"].append((start - due) * 1e3)
            run.records["engine_call_ms"].append((last - start) * 1e3)
            if idle:
                run.records["generator_lag_ms"].append((start - due) * 1e3)
        trace.stop()
        run.units = len(run.done)
        run.failed = run.attempted - run.units
        # a scan never answered waited at least until the run gave up
        run.records["latency_ms"] += [(give_up - t0 - t) * 1e3
                                      for t, _ in sched[run.units:]]
        run.window_s = max(seconds, last - t0)
        return run


class ClosedPipelined(Serving):
    def warm(self) -> None:
        n = self.cell["warm"]
        for _ in self.engine.infer_pipelined(
                (self.pool[i % len(self.pool)] for i in range(n)),
                self.cell["depth"]):
            pass

    def window(self, seconds: float, trace) -> Run:
        run, fed = Run(), collections.deque()
        order = self.rng.permutation(len(self.pool))
        t0 = time.perf_counter()
        t_end, trace_at = t0 + seconds, t0 + max(0.0, seconds - trace.seconds)

        def feed():
            k = 0
            while True:
                now = time.perf_counter()
                if now >= t_end:
                    return
                if now >= trace_at:
                    trace.start()
                i = int(order[k % len(order)])
                fed.append(i)
                k += 1
                yield self.pool[i]

        results = self.engine.infer_pipelined(feed(), self.cell["depth"])
        while True:
            with trace.span("engine.infer_pipelined"):
                answer = next(results, None)
            if answer is None:
                break
            run.done.append(time.perf_counter())
            self.keep(fed.popleft(), answer)
        trace.stop()
        run.units = run.attempted = len(run.done)
        run.window_s = run.done[-1] - t0
        return run


class ClosedBurst(Serving):
    def warm(self) -> None:
        b = self.cell["burst"]
        for k in range(self.cell["warm"]):
            self.engine.infer_many([self.pool[(k * b + j) % len(self.pool)]
                                    for j in range(b)])

    def window(self, seconds: float, trace) -> Run:
        run, b = Run(), self.cell["burst"]
        order = self.rng.permutation(len(self.pool))
        t0 = time.perf_counter()
        t_end, trace_at = t0 + seconds, t0 + max(0.0, seconds - trace.seconds)
        k = 0
        while time.perf_counter() < t_end:
            if time.perf_counter() >= trace_at:
                trace.start()
            ids = [int(order[(k + j) % len(order)]) for j in range(b)]
            k += b
            start = time.perf_counter()
            with trace.span("engine.infer_many"):
                answers = self.engine.infer_many([self.pool[i] for i in ids])
            done = time.perf_counter()
            run.records["burst_call_ms"].append((done - start) * 1e3)
            for i, answer in zip(ids, answers):
                self.keep(i, answer)
                run.done.append(done)
        trace.stop()
        run.units = run.attempted = len(run.done)
        run.window_s = run.done[-1] - t0
        return run


class TrainLoader(Driver):
    """The train step as a loader feeds it.  Set-up builds the state and
    the step, and drives them through `checked_steps` steps on distinct
    batches; the window takes the pool's next batches in turn."""

    def setup(self) -> None:
        import torch

        ctx, cfg, cell = self.ctx, self.cfg, self.cell
        b = cell["batch"]
        pts, lab = scenes.labelled_batch(cfg.scene, cfg, self.rng,
                                         cell["pool"], cell["points"])
        if cfg.shift_cloud:
            # the data set holds its scans in the model's frame, as the
            # engine lifts a served scan
            pts[..., 2] += np.float32(cfg.lidar_height)
            lab += np.float32(cfg.lidar_height)
        self.padded = cell["points"]      # the train step pads nothing
        self.batches = [(pts[i:i + b], lab[i:i + b])
                        for i in range(0, cell["pool"] - b + 1, b)]
        self.w = self.weights()
        train = ctx.program.train
        self.state = train.create_train_state(
            ctx.program_cfg, steps_per_epoch=len(self.batches),
            state_dict=dict(self.w), device=ctx.device)
        self.step = train.make_train_step(ctx.program_cfg)
        names = [n for n, _ in self.state.model.named_parameters()]
        losses = []
        for k in range(cell["checked_steps"]):
            self.state, loss = self.step(self.state, *self.batches[k])
            losses.append(loss)
            if k == 0:
                # the optimizer's first gradient is its momentum after one
                # step less the weight decay it adds
                wd = float(np.float32(ctx.program_cfg.weight_decay))
                self.first_grad = {
                    n: m.detach().double() - wd * self.w[n].double()
                    for n, m in zip(names, self.state.tx.momentum)}
        self.params = {n: p.detach().clone()
                       for n, p in self.state.model.named_parameters()}
        self.losses = [float(x) for x in losses]
        self.next = cell["checked_steps"]
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float, trace) -> Run:
        import torch

        run, b = Run(), self.cell["batch"]
        t0 = time.perf_counter()
        t_end, trace_at = t0 + seconds, t0 + max(0.0, seconds - trace.seconds)
        loss = None
        while time.perf_counter() < t_end:
            if time.perf_counter() >= trace_at:
                trace.start()
            batch = self.batches[self.next % len(self.batches)]
            self.next += 1
            with trace.span("train_step"):
                self.state, loss = self.step(self.state, *batch)
            run.done += [time.perf_counter()] * b
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        run.window_s = time.perf_counter() - t0
        trace.stop()
        run.units = run.attempted = len(run.done)
        run.records["last_loss"].append(float(loss))
        return run

    def scans(self) -> list:
        return [s for points, _ in self.batches for s in points]

    def release(self) -> None:
        self.state = self.step = None

    def check(self) -> dict:
        """loss_gap: the worst of the checked steps' loss gaps, over the
        reference's loss; grad_gap: the worst leaf's gap between the norms
        of the first gradients, over the larger of the reference leaf's
        norm and the median leaf's; change_gap: the same of the parameters'
        change over the checked steps, leaving out leaves whose reference
        gradient is under a thousandth of the median leaf's (round-off
        alone moves them)."""
        import torch

        cfg, dev = self.cfg, self.ctx.device
        batches = [(torch.from_numpy(p).to(dev), torch.from_numpy(t).to(dev))
                   for p, t in self.batches[:self.cell["checked_steps"]]]
        losses, grad, final = reference.sgd_steps(cfg, self.w, batches,
                                                  cfg.lr)
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                       for a, b in zip(self.losses, losses))

        def norm(x):
            return float(torch.linalg.vector_norm(x.double()))

        names = sorted(grad)
        g_ref = {n: norm(grad[n]) for n in names}
        g_med = float(np.median(list(g_ref.values())))
        moved = [n for n in names if g_ref[n] >= 1e-3 * g_med]
        d_ref = {n: norm(final[n].double() - self.w[n].double())
                 for n in moved}
        d_med = float(np.median(list(d_ref.values())))
        d_gap = {n: abs(norm(self.params[n].double() - self.w[n].double())
                        - d_ref[n]) / max(d_ref[n], d_med) for n in moved}
        g_gap = {n: abs(norm(self.first_grad[n]) - g_ref[n])
                 / max(g_ref[n], g_med) for n in names}
        return {"loss_gap": loss_gap, "grad_gap": max(g_gap.values()),
                "change_gap": max(d_gap.values()),
                "grad_gap_median": float(np.median(list(g_gap.values()))),
                "change_gap_median": float(np.median(list(d_gap.values()))),
                "first_loss_gap": abs(self.losses[0] - losses[0])
                / max(abs(losses[0]), 1e-30),
                "left_out": len(names) - len(moved)}


DRIVERS = {"open_loop": OpenLoop, "closed_pipelined": ClosedPipelined,
           "closed_burst": ClosedBurst, "train_loader": TrainLoader}
