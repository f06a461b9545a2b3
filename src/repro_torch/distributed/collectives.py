"""Collectives of the model-sharding path, with exact gradients.

The reference writes its sharded model with GSPMD annotations
(``ctx.shard``, ``shard_residual``) and ``shard_map``; XLA inserts the
collectives and differentiates them.  Here each rank is a process that holds
its shards (``sharding.specs.shard_params``) and the model code calls these
functions where the layout changes.  The ``torch.autograd.Function``\\ s are
Megatron's conjugate pairs:

* ``to_model``      -- identity forward, all-reduce backward: a replicated
  tensor entering work that each model rank does a part of;
* ``reduce_model``  -- all-reduce forward, identity backward: partial sums
  leaving such work (``reduce_batch`` likewise over the batch axes);
* ``gather_model(partial=True)`` -- all-gather forward, reduce-scatter
  backward (the sequence-parallel residual entering a column-parallel
  product); ``scatter_model`` is its reverse;
* ``gather_model(partial=False)`` -- all-gather into a tensor every rank
  uses whole: the backward keeps this rank's share; ``split_model`` (keep a
  share, all-gather backward) is its reverse;
* ``all_to_all_model`` -- the a2a MoE exchange, its own transpose.

``enter``/``leave``/``rows_weight`` pick among them by the residual's
layout (``ShardCtx.residual_split``).  Every collective is a no-op on an
axis of one rank.

The transport is gloo (NCCL refuses two ranks on one card), which exchanges
host tensors: each exchange stages a device tensor through the host in one
planned read (``_stage``), an ``analysis.allowed`` scope tagged
``mesh-reduce``, ``mesh-gather`` or ``mesh-a2a`` (the expert-parallel
engine, which shares this transport, passes its ``ep-a2a-*`` tags and its
``EngineStats``), and goes back up by one asynchronous copy.  Sums run in
f32 whatever the tensor's dtype.  ``STATS`` counts the exchanges of both
callers, the bytes each rank sends and their host wall.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.analysis.registry import register_collective

STATS = {"calls": 0, "bytes": 0, "host_s": 0.0}


def reset_stats() -> None:
    STATS.update(calls=0, bytes=0, host_s=0.0)


@hot_path
def _stage(t: torch.Tensor, tag: str, dtype: Optional[torch.dtype] = None,
           stats=None) -> torch.Tensor:
    """``t`` (as ``dtype``) on the host: one planned read, an
    ``allowed(tag)`` scope, counted in ``stats.planned_reads`` when given
    (the expert-parallel engine's).  A host tensor is copied: the
    exchanges write their buffers in place."""
    t = (t if dtype is None else t.to(dtype)).contiguous()
    with sanitizer.allowed(tag):
        host = t.clone() if t.device.type == "cpu" else t.cpu()  # lint: allow[MG101] the planned staging read of a gloo exchange
    if stats is not None:
        stats.planned_reads += 1
    return host


def _unstage(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An exchanged host buffer back on ``like``'s device and dtype, by one
    asynchronous copy."""
    return host.to(like.device, dtype=like.dtype, non_blocking=True)


def _account(t0: float, nbytes: int) -> None:
    STATS["calls"] += 1
    STATS["bytes"] += nbytes
    STATS["host_s"] += time.perf_counter() - t0


def _size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


@register_collective("mesh.all_reduce")
def _all_reduce(t: torch.Tensor, group, op: str = "sum", tag: str = "mesh-reduce",
                stats=None) -> torch.Tensor:
    """The sum (or max) of ``t`` over ``group``, in f32, back in ``t``'s
    dtype and device."""
    import torch.distributed as dist

    if group is None:
        return t
    t0 = time.perf_counter()
    host = _stage(t, tag, torch.float32, stats)
    dist.all_reduce(host, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                    group=group)
    _account(t0, host.numel() * host.element_size())
    return _unstage(host, t)


@register_collective("mesh.all_gather")
def _all_gather(t: torch.Tensor, group, dim: int, tag: str = "mesh-gather",
                stats=None) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist

    if group is None:
        return t
    t0 = time.perf_counter()
    host = _stage(t, tag, stats=stats)
    parts = [torch.empty_like(host) for _ in range(_size(group))]
    dist.all_gather(parts, host, group=group)
    _account(t0, host.numel() * host.element_size())
    return _unstage(torch.cat(parts, dim=dim), t)


@register_collective("mesh.all_to_all")
def _post_all_to_all(t: torch.Tensor, group, tag: str = "mesh-a2a", stats=None):
    """Stage ``t`` (dim 0 has one row per rank) and post its exchange: row j
    goes to rank j.  Returns (host receive buffer, work); row j of the
    buffer, once ``wait(work)`` returns, came from rank j."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    host = _stage(t, tag, stats=stats)
    recv = torch.empty_like(host)
    work = dist.all_to_all_single(recv, host, group=group, async_op=True)
    _account(t0, host.numel() * host.element_size())
    return recv, work


def wait(work) -> None:
    """Wait for a posted exchange, its host wall counted in ``STATS``."""
    t0 = time.perf_counter()
    work.wait()
    STATS["host_s"] += time.perf_counter() - t0


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``_post_all_to_all``, waited for, back on ``t``'s device."""
    if group is None:
        return t
    recv, work = _post_all_to_all(t, group)
    wait(work)
    return _unstage(recv, t)


def _share(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous share of ``t`` along ``dim``."""
    import torch.distributed as dist

    if group is None:
        return t
    n = t.shape[dim] // _size(group)
    return t.narrow(dim, dist.get_rank(group) * n, n)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's share of the sum over ``group`` (gloo has no
    reduce-scatter: an all-reduce, then the share)."""
    return _share(_all_reduce(t, group), group, dim).contiguous()


# ---------------------------------------------------------------------------
# Conjugate pairs
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, partial):
        ctx.group, ctx.dim, ctx.partial = group, dim, partial
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return _share(g, ctx.group, ctx.dim).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _share(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), ctx.group), None


def to_model(ctx, x: torch.Tensor) -> torch.Tensor:
    """Identity forward, all-reduce over the model axis backward."""
    g = ctx.model_group
    return x if g is None else _CopyTo.apply(x, g)


def reduce_model(ctx, x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over the model axis forward, identity backward."""
    g = ctx.model_group
    return x if g is None else _ReduceFrom.apply(x, g)


def reduce_batch(ctx, x: torch.Tensor) -> torch.Tensor:
    """All-reduce (sum) over the batch axes forward, identity backward."""
    g = ctx.batch_group
    return x if g is None else _ReduceFrom.apply(x, g)


def gather_model(ctx, x: torch.Tensor, dim: int, partial: bool) -> torch.Tensor:
    """All-gather over the model axis along ``dim``.  ``partial``: each rank
    uses the result for its own part of the work (reduce-scatter backward);
    else every rank uses it whole (the backward keeps this rank's share)."""
    g = ctx.model_group
    return x if g is None else _Gather.apply(x.contiguous(), g, dim, partial)


def scatter_model(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Reduce-scatter over the model axis along ``dim``, all-gather backward."""
    g = ctx.model_group
    return x if g is None else _ReduceScatter.apply(x, g, dim)


def split_model(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's share of replicated ``x`` along ``dim``, all-gather
    backward."""
    g = ctx.model_group
    return x if g is None else _Split.apply(x, g, dim)


def all_to_all_model(ctx, x: torch.Tensor) -> torch.Tensor:
    """The a2a exchange over the model axis (row j to rank j)."""
    g = ctx.model_group
    return x if g is None else _AllToAll.apply(x.contiguous(), g)


# ---------------------------------------------------------------------------
# Without gradients
# ---------------------------------------------------------------------------
def max_model(ctx, x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the model axis (no gradient)."""
    return _all_reduce(x.detach(), ctx.model_group, op="max")


def all_gather_value(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over the model axis, no gradient."""
    return _all_gather(x.detach(), ctx.model_group, dim)


def all_reduce_value(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, no gradient (gradients over the batch axes)."""
    return _all_reduce(x.detach(), group)


def all_gather_batch(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    """All-gather over the batch axes, no gradient (ZeRO-1's updated
    slices)."""
    return _all_gather(x.detach(), ctx.batch_group, dim)


def batch_share(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's share of ``x`` over the batch axes along ``dim``."""
    return _share(x, ctx.batch_group, dim)


# ---------------------------------------------------------------------------
# The residual stream's layout
# ---------------------------------------------------------------------------
def enter(ctx, h: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The residual (B, S or S/m, ...) as the whole sequence, for work each
    model rank does a part of (heads, columns, experts, vocabulary)."""
    if ctx.residual_split:
        return gather_model(ctx, h, dim, partial=True)
    return to_model(ctx, h)


def leave(ctx, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Partial sums over the model axis (B, S, ...) back in the residual's
    layout: reduce-scattered by sequence, or all-reduced."""
    if ctx.residual_split:
        return scatter_model(ctx, y, dim)
    return reduce_model(ctx, y)


def rows_weight(ctx, w: torch.Tensor) -> torch.Tensor:
    """A replicated weight applied to the residual's own rows: with a
    sequence split each rank's rows give a part of its gradient."""
    return to_model(ctx, w) if ctx.residual_split else w


def whole_sequence(ctx, h: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The residual as the whole sequence for work every model rank does
    whole (a recurrence no rank can split)."""
    return gather_model(ctx, h, dim, partial=False) if ctx.residual_split else h


def residual_rows(ctx, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The whole sequence ``y``, computed alike on every rank, in the
    residual's layout."""
    return split_model(ctx, y, dim) if ctx.residual_split else y
