"""Collectives over `torch.distributed` process groups, with gradients.

The JAX package writes its multi-device code with `shard_map` and the
collectives `psum`, `pmean`, `all_gather` and `ppermute`, whose transposes
JAX derives.  Here they are explicit:

* `psum(x, group)` sums over the ranks of `group`; its backward sums the
  cotangents too (each rank's loss reaches every rank's input through the
  sum, as in a sync-BN's statistics).
* `all_gather(x, group, dim)` concatenates every rank's `x` along `dim`;
  its backward sums the cotangents over the group and keeps this rank's
  slice (JAX's transpose of a tiled all_gather, a psum_scatter).
* `batch_moments` is the sync-BN statistics: sums AND counts are summed
  over the group, so ranks with unequal row counts still get the
  statistics of the concatenated batch.

A gloo group exchanges host tensors: a CUDA tensor is staged through the
host around each gloo call (`host_staged`), chosen by the group's backend.
NCCL takes device tensors.  A group of one rank (or None) makes every
collective the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def host_staged(group, t: torch.Tensor) -> bool:
    """Whether `t` goes through a host copy for a collective over `group`:
    CUDA tensors on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: `t` reduced over `group` (no gradient)."""
    if host_staged(group, t):
        out = t.detach().cpu()
        dist.all_reduce(out, op=op, group=group)
        return out.to(t.device)
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def gather_list(t: torch.Tensor, group) -> list:
    """Every rank's `t` (equal shapes), in group-rank order (no gradient)."""
    staged = host_staged(group, t)
    src = (t.detach().cpu() if staged else t.detach()).contiguous()
    parts = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(parts, src, group=group)
    return [p.to(t.device) for p in parts] if staged else parts


def broadcast_(t: torch.Tensor, src: int, group=None) -> None:
    """Overwrite `t` in place with global rank `src`'s value."""
    if host_staged(group, t):
        host = t.detach().cpu()
        dist.broadcast(host, src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src, group=group)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks of `group`, differentiable (backward: psum)."""
    return x if size(group) == 1 else _PSum.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.width = group, dim, x.shape[dim]
        return torch.cat(gather_list(x, group), dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce(g, ctx.group)
        return (total.narrow(ctx.dim, rank(ctx.group) * ctx.width,
                             ctx.width), None, None)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in group-rank order,
    differentiable (backward: the summed cotangent's slice of this
    rank)."""
    return x if size(group) == 1 else _AllGather.apply(x, group, dim)


def pmean_grads_(params, group) -> None:
    """Replace every `.grad` of `params` by its mean over `group`: one
    flattened all-reduce (the ranks run one program, so the same
    parameters have gradients on every rank)."""
    n = size(group)
    params = [p for p in params if p.grad is not None]
    if n == 1 or not params:
        return
    flat = all_reduce(torch.cat([p.grad.reshape(-1) for p in params]),
                      group) / n
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p.grad)
        offset += p.numel()


def batch_moments(x: torch.Tensor, dims: tuple, group,
                  keep: torch.Tensor | None = None):
    """Per-channel (mean, biased variance) of `x` over `dims` and over the
    ranks of `group`, differentiable: two passes, each a psum of the
    per-channel sums and of the row counts.  `keep` (broadcastable to x)
    marks the rows that count; the others must already be zero in x."""
    shape = [1] * x.dim()
    channel = [d for d in range(x.dim()) if d not in dims][0]
    shape[channel] = -1
    if keep is None:
        n = torch.tensor(float(x.numel() // x.shape[channel]),
                         device=x.device)
    else:
        keep = keep.to(x.dtype)
        n = (keep.expand_as(x).sum() / x.shape[channel]).detach()
    n = psum(n, group)
    mean = psum(x.sum(dim=dims), group) / n
    d = x - mean.view(shape)
    sq = d * d if keep is None else d * d * keep
    var = psum(sq.sum(dim=dims), group) / n
    return mean, var
