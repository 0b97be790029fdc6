"""CUDA graphs of the port's device programs: the counterpart of `jax.jit`.

The JAX package compiles each of its steps (the train step, the eval step,
the batched forward, the evaluation's RMSE batch, the single-scan serving
program) into one XLA executable per input shape, which runs with no host
round trip inside it.  The port runs the same programs eagerly on the CPU
and, on the card, captures each as one CUDA graph per input shape:
`StepGraph` is one such graph, `GraphCache` the cache of a function's
graphs by the shapes and types of its tensor arguments.

A captured function must read nothing back to the host (no `.item()`,
`bool()` of a tensor, boolean-mask indexing, `nonzero`) and copy nothing
from the host (`torch.tensor(x, device='cuda')`; `torch.full` is a fill and
is captured).  Its kernels must not take a host-side argument that changes
from call to call: K8 and K9 take a host epoch a call
(`ops/affine_aux.py`), so no graph may reach them.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from gndnet_tpu_torch.utils.profiling import span

GRAPH_WARMUP = 3    # eager calls on a side stream before a capture


def _key(tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tensors)


class StepGraph:
    """One CUDA graph of `fn(*tensors)` for the shapes and types of
    `examples`.

    The examples are copied into static inputs, `fn` runs GRAPH_WARMUP
    times on them eagerly on a side stream (that loads every kernel and
    takes each one's first-launch set-up, cuBLAS and cuDNN workspaces and
    the wrappers' per-device state out of the capture), `reset()` runs
    when given (a program that changes state in place puts it back, so
    the warm-up leaves no trace), and then one call is captured, in
    `pool` when given.  A call copies its arguments into the static
    inputs (a stream-ordered copy), replays, and clones the outputs; a
    lock keeps the three together, and the next fill waits on the last
    copy-out's event, so two threads may call it.  Graphs that share a
    pool overwrite each other's temporaries: they are replayed one at a
    time on one stream, each output cloned before another replays, which
    this class does.  A capture that fails raises; nothing falls back to
    eager."""

    def __init__(self, fn: Callable, examples, pool=None,
                 reset: Callable | None = None):
        dev = examples[0].device
        with span("gndnet.graph.capture"):
            self.inputs = tuple(x.clone() for x in examples)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP):
                    fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            if reset is not None:
                reset()
            self.graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's CUDA work does not void the
            # capture
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn(*self.inputs)
        self.single = isinstance(out, torch.Tensor)
        self.outputs = (out,) if self.single else tuple(out)
        self.done = torch.cuda.Event()
        self.done.record()
        self.lock = threading.Lock()
        self.replays = 0

    def __call__(self, *args):
        with self.lock, span("gndnet.graph.replay"):
            stream = torch.cuda.current_stream(self.inputs[0].device)
            stream.wait_event(self.done)
            for dst, src in zip(self.inputs, args):
                dst.copy_(src, non_blocking=True)
            self.graph.replay()
            out = tuple(o.clone() for o in self.outputs)
            self.done.record(stream)
            self.replays += 1
        return out[0] if self.single else out


class GraphCache:
    """`fn(*tensors)` as one `StepGraph` per shapes and types of its
    arguments on the card (a new shape captures anew, as `jax.jit`
    retraces; the graphs share one memory pool), eagerly on the CPU.
    `keep`, where fn changes tensors in place (a train state): a callable
    giving them, which each capture snapshots and its warm-up puts back,
    so the first call computes from them as they were.  `replays` counts
    the replays; `eager_calls` the calls of `fn` outside a replay:
    eagerly, in a warm-up or recorded by a capture (so many times a
    kernel wrapper counts a launch)."""

    def __init__(self, fn: Callable, keep: Callable | None = None):
        self.fn, self.keep = fn, keep
        self.graphs: dict = {}
        self.pool = None
        self.lock = threading.Lock()
        self.done = None        # the last call's copy-out, on its stream
        self.replays = 0
        self.eager_calls = 0

    def _reset(self) -> Callable | None:
        if self.keep is None:
            return None
        live = self.keep()
        saved = [t.detach().clone() for t in live]

        def reset() -> None:
            with torch.no_grad():
                for t, s in zip(live, saved):
                    t.copy_(s)
        return reset

    def __call__(self, *tensors):
        if tensors[0].device.type != "cuda":
            self.eager_calls += 1
            with span("gndnet.graph.eager"):
                return self.fn(*tensors)
        with self.lock:
            key = _key(tensors)
            graph = self.graphs.get(key)
            if graph is None:
                if self.pool is None:
                    self.pool = torch.cuda.graph_pool_handle()
                self.eager_calls += GRAPH_WARMUP + 1   # warm-up, capture
                graph = self.graphs[key] = StepGraph(
                    self.fn, tensors, self.pool, reset=self._reset())
            stream = torch.cuda.current_stream(tensors[0].device)
            if self.done is None:
                self.done = torch.cuda.Event()
            else:
                stream.wait_event(self.done)
            out = graph(*tensors)
            self.done.record(stream)
            self.replays += 1
            return out
