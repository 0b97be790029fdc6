"""Multi-process SPMD utilities: one process per rank over
`torch.distributed`.

Counterpart of `gndnet_tpu.parallel.multihost`.  Every process runs the
same program: `initialize()` first, then one global (dp, sp) mesh
(`global_mesh`), then its local batch shard.  Collectives ride NCCL where
every rank has a card of its own, gloo otherwise (`choose_backend`, the one
place the backend is chosen).  Parameters and optimizer state are
replicated: identical on every rank (same seed, same restore), which
`replicate_global` checks.

`spawn` starts `world` local rank processes of one job (a function
`module:name`) with a `file://` rendezvous, and collects what each rank
returns: the localhost self-test of `scripts/launch_multihost.py`, the CPU
tests and the card smoke test run their ranks through it.  A rank process
runs `python -m gndnet_tpu_torch.parallel.multihost <spec> <rank>`.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from gndnet_tpu_torch.parallel import collectives as cc

MESH_DIMS = ("dp", "sp")


def choose_backend(device, ranks_on_host: int) -> str:
    """NCCL when the ranks run on cards (`device` 'cuda', 'cuda:1', or None:
    the card) and this host has a card for each of them; gloo otherwise
    (CPU ranks, or several ranks sharing one card, which NCCL refuses)."""
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if on_card and torch.cuda.device_count() >= ranks_on_host:
        return "nccl"
    return "gloo"


def local_device(device=None) -> torch.device:
    """This rank's device: `device` when it names one ('cpu', 'cuda:1');
    for 'cuda' (or None) the card `LOCAL_RANK` (else the rank) modulo the
    cards on this host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for CPU ranks")
    local = int(os.environ.get("LOCAL_RANK",
                               dist.get_rank() if dist.is_initialized()
                               else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, backend: str | None = None) -> None:
    """`torch.distributed.init_process_group` with explicit or
    environment-derived topology.

    With no arguments the topology comes from the environment (`env://`:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as `torchrun` sets them).
    `coordinator` is 'host:port' of rank 0 (TCP) or a full init URL
    ('file:///path', 'tcp://host:port').  `local_device_ids` names this
    process's card; `backend` defaults to `choose_backend` for the cards
    (LOCAL_WORLD_SIZE ranks on this host, else the world)."""
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", 1)))
    if local_device_ids is not None:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    if backend is None:
        on_card = torch.cuda.is_available()
        backend = choose_backend(
            "cuda" if on_card else "cpu",
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend, init_method=init, **kw)


def global_mesh(dp: int, sp: int = 1):
    """A (dp, sp) `DeviceMesh` with dims ("dp", "sp") over ALL ranks of the
    default process group, rank = dp_index * sp + sp_index (a dp row's sp
    ranks are neighbours, so halo exchanges stay within a host wherever
    the launch keeps them there).  Raises unless dp * sp is the world
    size."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a dp={dp} x sp={sp} mesh needs a torch.distributed process "
            f"group of {dp * sp} ranks: launch one process per rank "
            "(torchrun, or gndnet_tpu_torch.parallel.multihost.spawn) and "
            "call multihost.initialize() first")
    n = dist.get_world_size()
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x{sp} must cover all {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, sp), mesh_dim_names=MESH_DIMS)


def axis(mesh, name: str):
    """(process group, size, this rank's index) of mesh dim `name`."""
    return (mesh.get_group(name), mesh.size(MESH_DIMS.index(name)),
            mesh.get_local_rank(name))


def _as_tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def local_batch_to_global(mesh, batch, device=None):
    """The dp-sharded global batch from each rank's LOCAL arrays: each rank
    keeps its own shard, on its own device (a tuple / list of arrays or
    tensors, returned as a tuple of tensors)."""
    del mesh
    dev = local_device(device)
    return tuple(_as_tensor(x, dev) for x in batch)


def state_tensors(tree) -> list:
    """The tensors of `tree`, in a fixed order: a `train.TrainState` (the
    model's state dict, then the momentum buffers in parameter order),
    an `nn.Module` (its state dict), or nested dicts / lists / tuples of
    tensors.  They share storage with the tree (in-place targets)."""
    if hasattr(tree, "model") and hasattr(tree, "tx"):
        return state_tensors(tree.model) + list(tree.tx.momentum)
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in state_tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in state_tensors(x)]
    if isinstance(tree, torch.Tensor):
        return [tree]
    return []


def replicate_global(mesh, tree, device=None):
    """Replicate host-identical values (model, optimizer state) over the
    mesh: rank 0's values are broadcast to every rank, in place, and the
    call raises where a rank held other values before.  Values must be
    identical on every rank (same seed, same restore): the SPMD invariant.
    A tree of arrays is first placed on this rank's device (a new tree)."""
    del mesh
    if not (hasattr(tree, "model") or isinstance(tree, torch.nn.Module)):
        dev = local_device(device)
        tree = _map(tree, lambda x: _as_tensor(x, dev).clone())
    leaves = state_tensors(tree)
    differs = 0
    for t in leaves:
        before = t.detach().clone()
        cc.broadcast_(t, 0)
        differs += int(not torch.equal(before, t))
    flag = cc.all_reduce(torch.tensor(
        [differs], device=leaves[0].device if leaves else "cpu"), None,
        dist.ReduceOp.MAX)
    if int(flag):
        raise ValueError(
            f"replicate_global: {int(flag)} tensors held other values than "
            "rank 0's on some rank (every rank must build the same state: "
            "same seed, same restore)")
    return tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def process_slice(n_frames: int, batch_size: int) -> slice:
    """This process's contiguous frame range for a host-split dataset:
    process i of k feeds frames [i*n/k, (i+1)*n/k) and a per-process
    batch of batch_size // k."""
    del batch_size
    k = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = n_frames // k
    return slice(i * per, (i + 1) * per if i < k - 1 else n_frames)


# ---------------------------------------------------------------------------
# local rank processes
# ---------------------------------------------------------------------------

def spawn(job: str, world: int, *, kwargs: dict | None = None,
          device: str | None = None, workdir: str | None = None,
          timeout: float = 600.0) -> list:
    """Run `job` ('module:function') in `world` local rank processes and
    return each rank's result, in rank order.

    Every rank calls `initialize()` through a `file://` rendezvous under
    `workdir` (a new temporary directory by default), runs on one
    intra-op thread (the ranks share the host's cores), then
    `function(rank=r, world=world,
    device=<this rank's device>, **kwargs)`; what that returns (tensors on
    the host, numbers, dicts of them) comes back through a file.
    `device` None or 'cuda' puts rank r on card r modulo the cards (and
    raises where there is no card); 'cpu' runs CPU ranks.  The backend is
    `choose_backend`'s.  Raises, with the failing ranks' output, if any
    rank fails or the job outlasts `timeout` seconds; every rank process is
    ended before this returns."""
    device = "cuda" if device is None else str(device)
    local_device(device)    # raises here where there is no card
    backend = choose_backend(device, world)
    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="gndnet_ranks_") if own else workdir
    os.makedirs(workdir, exist_ok=True)
    spec = os.path.join(workdir, "job.pt")
    torch.save({"job": job, "world": world, "kwargs": kwargs or {},
                "device": device, "backend": backend,
                "init": "file://" + os.path.join(workdir, "rendezvous")},
               spec)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gndnet_tpu_torch.parallel.multihost", spec,
         str(r)], env=env, stdout=log, stderr=subprocess.STDOUT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        out = []
        for r, log in enumerate(logs):
            log.seek(0)
            out.append(f"----- rank {r} (exit {codes[r]}) -----\n"
                       + log.read()[-4000:])
        for log in logs:
            log.close()
        raise RuntimeError(f"{job} failed in {world} ranks:\n"
                           + "\n".join(out))
    for log in logs:
        log.close()
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world)]


def _run_rank(spec_path: str, rank: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(1)
    world = spec["world"]
    os.environ.setdefault("LOCAL_RANK", str(rank))
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(world))
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    initialize(spec["init"], world, rank, backend=spec["backend"])
    try:
        module, name = spec["job"].split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(rank=rank, world=world,
                    device=str(local_device(spec["device"])),
                    **spec["kwargs"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(os.path.dirname(spec_path),
                                    f"result{rank}.pt"))


if __name__ == "__main__":
    _run_rank(sys.argv[1], int(sys.argv[2]))
