"""Expert-parallel MoE decode stage over a ``torch.distributed`` group.

The single-device engine runs the MoE stage as one grouped dispatch
(``models.moe.grouped_dispatch``): norm2, route, the capacity-bucketed
``(E, C, D)`` gather, the grouped FFN (K1 + K2 on the card) and the
gate-weighted combine.  This module is the same stage for an engine whose
``ShardCtx`` names a group of n ranks.  Every rank is a process that runs
the whole ``Server`` on the same requests and holds every weight, as the
reference's home device does; only this stage is collective.

* ``moe_dispatch='a2a'`` (``_ep_a2a_expert_module``): every rank routes the
  whole batch (the single-device router product; the histogram ``load``
  needs no exchange), rank r takes tokens ``[r*T/n, (r+1)*T/n)`` and sends
  every routed copy to the rank that owns
  its expert (experts ``[r*E/n, (r+1)*E/n)`` live on rank r) by
  ``all_to_all_single``, activations and expert ids in one exchange.  The
  owner buckets its arrivals into an ``(E/n, cap_l, D)`` buffer, runs the
  same ``ops.grouped_expert_ffn`` on its slice of the expert stacks (views,
  no copy) and a second exchange brings the rows home, where the gate
  product and the sum over the k copies run in ``grouped_dispatch``'s
  order.  An ``all_gather`` then gives every rank the whole batch's output
  and every rank's kept count (it takes the place of the reference's
  ``device_put`` home and its ``psum`` of ``kept``).
  The batch splits into ``chunks`` pipeline chunks: chunk k+1's dispatch is
  posted before chunk k's FFN runs, unless ``serial``, which waits for each
  exchange before posting the next.  The data do not depend on the
  schedule, so serial and pipelined outputs are bitwise equal.

  When capacity admits every routed copy, every copy's FFN row, gate
  product and add order are those of ``grouped_dispatch``, so the stage is
  bit-identical to it.  Under capacity pressure the drop sets differ (slots
  are assigned per chunk at the owner); ``kept``, ``dropped`` and ``load``
  keep their meaning.

* ``moe_dispatch='psum'`` (``_ep_psum_expert_module``): every rank routes
  the whole batch with the single-device slots (the drop decisions of
  ``grouped_dispatch``), fills only its own experts' rows, and the partial
  outputs are summed by ``all_reduce``.  The sum over ranks reassociates a
  token's k copies: allclose to the single-device stage, not bitwise.

The transport is gloo, which exchanges host tensors.  Each exchange stages
its device buffer through the host in one planned read (an ``allowed``
scope tagged ``ep-a2a-batch`` on the way out, ``ep-a2a-combine`` for the
return and the gather, counted in ``EngineStats.planned_reads``) and goes
back up by one asynchronous copy.  An a2a stage of c chunks makes 2c + 1
such reads, a psum stage one.  Every collective lives in a function marked
``@register_collective`` (lint rule MG107).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.analysis.registry import register_collective
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import rms_norm
from repro_torch.sharding.specs import ShardCtx


# ---------------------------------------------------------------------------
# Static helpers (no device code)
# ---------------------------------------------------------------------------
def pipeline_chunks(t_local: int, requested: int) -> int:
    """Largest chunk count <= ``requested`` that divides the per-rank token
    count: chunked dispatch needs equal chunk shapes."""
    c = max(1, min(int(requested), max(1, t_local)))
    while t_local % c:
        c -= 1
    return c


def a2a_bytes_per_stage(cfg: ModelConfig, T: int, n_model: int,
                        itemsize: int = 4) -> int:
    """Bytes one a2a MoE stage exchanges for a T-token batch: every routed
    copy crosses twice (dispatch and return) at D activation elements, plus
    one int32 expert id on dispatch.  Independent of the chunk count
    (chunking re-times the traffic, not its volume); counts whole buffers,
    each rank's share to itself included, so that mesh shapes compare."""
    if n_model <= 1:
        return 0
    copies = T * cfg.experts_per_token
    return copies * n_model * (2 * cfg.d_model * itemsize + 4)


def validate_ep_shard(cfg: ModelConfig, sctx: ShardCtx) -> int:
    """The expert-parallel engine's construction contract; returns the
    group's size.  Raises ``ValueError`` for what the collective stage does
    not support, at construction rather than mid-decode."""
    if sctx is None:
        return 1                     # no group: the single-device contract
    if sctx.group is None:
        raise ValueError(
            "expert-parallel engine needs a ShardCtx with a process group; "
            "for single-device serving pass sctx=None")
    n = sctx.model_size
    if sctx.moe_dispatch not in ("a2a", "psum"):
        raise ValueError(
            f"moe_dispatch={sctx.moe_dispatch!r} is not a collective decode "
            "path: 'grouped' is the single-device capacity path (pass "
            "sctx=None); use 'a2a' or 'psum' on a group")
    if cfg.num_experts % n:
        raise ValueError(
            f"num_experts={cfg.num_experts} is not divisible by the group "
            f"size {n}: expert-parallel dispatch shards whole expert stacks only")
    return n


# ---------------------------------------------------------------------------
# Host staging and the exchanges
# ---------------------------------------------------------------------------
def _as_bytes(*ts: torch.Tensor) -> torch.Tensor:
    """``ts`` (each with the same first dimension m) side by side as one
    (m, bytes) uint8 tensor, on their device."""
    m = ts[0].shape[0]
    return torch.cat([t.reshape(m, -1).contiguous().view(torch.uint8) for t in ts], dim=1)


def _from_bytes(b: torch.Tensor, specs: Sequence[Tuple[torch.dtype, Tuple[int, ...]]]
                ) -> List[torch.Tensor]:
    """Split (m, bytes) ``b`` back into tensors of (dtype, per-row shape)."""
    out, c = [], 0
    m = b.shape[0]
    for dtype, shape in specs:
        width = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        out.append(b[:, c:c + width].contiguous().view(dtype).reshape((m,) + tuple(shape)))
        c += width
    return out


@hot_path
def _to_host(t: torch.Tensor, tag: str, stats) -> torch.Tensor:
    """``t`` on the host: one planned read, an ``allowed(tag)`` scope counted
    in ``stats.planned_reads`` (on the CPU, the tensor itself)."""
    with sanitizer.allowed(tag):
        host = t.cpu()  # lint: allow[MG101] the stage's planned staging read for the gloo exchange
    stats.planned_reads += 1
    return host


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """An exchanged host buffer back on ``device``, without a host wait."""
    return t.to(device, non_blocking=True)  # lint: allow[MG105] the exchanged rows back up, one asynchronous copy an exchange


@register_collective("distributed.a2a")
def _post_a2a(send: torch.Tensor, group):
    """Post one ``all_to_all_single`` of host rows ``send`` (n, bytes): row j
    goes to rank j.  Returns (receive buffer, work)."""
    import torch.distributed as dist

    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=True)
    return recv, work


@register_collective("distributed.all_gather")
def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """Every rank's (1, bytes) host row ``t``, stacked in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=0)


@register_collective("distributed.all_reduce")
def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ranks of host tensor ``t``, in place."""
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


@register_collective("distributed.clock")
def broadcast_clock(sctx: ShardCtx, now: float) -> float:
    """Rank 0's reading ``now`` of the server's virtual clock, on every rank
    (one broadcast of one host double), so that every rank makes the same
    admission decisions."""
    import torch.distributed as dist

    t = torch.tensor([now], dtype=torch.float64)
    sanitizer.count("ep-clock")
    dist.broadcast(t, src=dist.get_global_rank(sctx.group, 0), group=sctx.group)
    return float(t[0])


# ---------------------------------------------------------------------------
# a2a path: token-sharded, capacity-bucketed, pipeline-chunked
# ---------------------------------------------------------------------------
@register_collective("distributed.ep_a2a_expert")
@hot_path
def _ep_a2a_expert_module(cfg: ModelConfig, sctx: ShardCtx, chunks: int, capacity: int,
                          serial: bool, norm2_w, router_w, wg, wu, wd, x, stats):
    """The whole a2a MoE stage of one layer; returns ``(y, kept, dropped,
    load)`` as ``grouped_dispatch``, on every rank.

    ``x`` is the (T, D) decode batch, the same on every rank, T divisible
    by the group size n (the caller's contract).  ``wg``, ``wu``, ``wd`` are
    this rank's (E/n, ...) expert slices; ``capacity`` is the per-expert
    capacity of the single-device stage."""
    group, n, r = sctx.group, sctx.model_size, sctx.rank
    E, k = cfg.num_experts, cfg.experts_per_token
    e_loc = E // n
    T, D = x.shape
    dev, dt = x.device, x.dtype
    T_r = T // n
    # every rank holds the whole batch: it norms and routes all of it (a
    # row's routing is the same in any batch, models.moe.router_logits), so
    # the routed histogram needs no exchange, and keeps its own rows
    h = rms_norm(x, norm2_w, cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, router_w, h)
    load = torch.zeros((E,), dtype=torch.int32, device=dev)
    load.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1), dtype=torch.int32))
    h, gates, idx = (t[r * T_r:(r + 1) * T_r] for t in (h, gates, idx))
    t_c = T_r // chunks
    cap_s = t_c * k                   # a destination's page: no send drops
    cap_l = max(1, min(capacity, n * cap_s))
    tok = torch.arange(cap_s, device=dev) // k
    meta = [(dt, (cap_s, D)), (torch.int32, (cap_s,))]

    def dispatch(c: int):
        """Chunk c's routed copies, paged by owner, sent on their way."""
        ic = idx[c * t_c:(c + 1) * t_c].reshape(-1)
        dst = ic // e_loc
        slot = moe_mod._arrival_slots(dst, n)
        send = torch.zeros((n, cap_s, D), dtype=dt, device=dev)
        send.index_put_((dst, slot), h[c * t_c:(c + 1) * t_c][tok], accumulate=True)
        ids = torch.zeros((n, cap_s), dtype=torch.int32, device=dev)
        ids.index_put_((dst, slot), (ic % e_loc + 1).to(torch.int32), accumulate=True)
        return dst, slot, _post_a2a(_to_host(_as_bytes(send, ids), "ep-a2a-batch", stats),
                                    group)

    posted = [dispatch(0)]
    ys = []
    kept = torch.zeros((1,), dtype=torch.int32, device=dev)
    for c in range(chunks):
        if not serial and c + 1 < chunks:
            posted.append(dispatch(c + 1))        # before chunk c's FFN
        dst, slot, (recv, work) = posted[c]
        work.wait()
        hr, le = _from_bytes(_to_device(recv, dev), meta)
        hr, le = hr.reshape(n * cap_s, D), le.reshape(-1).long()
        # the owner's buckets: arrivals in (source rank, source slot) order
        valid = le > 0
        le0 = torch.clamp(le - 1, min=0)
        slot2 = moe_mod._arrival_slots(le0, e_loc, mask=valid)
        keep = valid & (slot2 < cap_l)
        slot2_c = torch.clamp(slot2, max=cap_l - 1)
        buf = torch.zeros((e_loc, cap_l, D), dtype=dt, device=dev)
        buf.index_put_((le0, slot2_c), hr * keep[:, None].to(dt), accumulate=True)
        counts = torch.zeros((e_loc,), dtype=torch.int32, device=dev)
        counts.scatter_add_(0, le0, valid.to(torch.int32))
        out = ops.grouped_expert_ffn(buf, wg, wu, wd, torch.clamp(counts, max=cap_l))
        back = (out[le0, slot2_c] * keep[:, None].to(out.dtype)).reshape(n, cap_s, D)
        ret, rwork = _post_a2a(_to_host(_as_bytes(back), "ep-a2a-combine", stats), group)
        rwork.wait()
        (ret,) = _from_bytes(_to_device(ret, dev), meta[:1])
        # home: grouped_dispatch's gate product and sum over the k copies
        gc = gates[c * t_c:(c + 1) * t_c].reshape(-1)
        got = ret[dst, slot] * gc[:, None].to(ret.dtype)
        got = got.to(dt).reshape(t_c, k, D)
        y = got[:, 0]
        for j in range(1, k):
            y = y + got[:, j]
        ys.append(y)
        kept += keep.to(torch.int32).sum(dtype=torch.int32)
        if serial and c + 1 < chunks:
            posted.append(dispatch(c + 1))        # after chunk c's exchanges
    # every rank's rows and kept counts: one gather in place of the
    # reference's device_put home and psum
    mine = _as_bytes(torch.cat(ys).reshape(1, -1), kept.reshape(1, -1))
    allb = _all_gather(_to_host(mine, "ep-a2a-combine", stats), group, n)
    y_all, kept_r = _from_bytes(_to_device(allb, dev), [(dt, (T_r, D)), (torch.int32, (1,))])
    kept_all = kept_r.sum(dtype=torch.int32)
    return y_all.reshape(T, D), kept_all, T * k - kept_all, load


# ---------------------------------------------------------------------------
# psum path: token-replicated, single-device slotting, partial-sum combine
# ---------------------------------------------------------------------------
@register_collective("distributed.ep_psum_expert")
@hot_path
def _ep_psum_expert_module(cfg: ModelConfig, sctx: ShardCtx, capacity: int,
                           norm2_w, router_w, wg, wu, wd, x, stats):
    """Replicated-token expert parallelism: the whole batch's routing and
    the single-device slots on every rank (the drop decisions of
    ``grouped_dispatch``), this rank's experts' share of the FFN, and the
    partial outputs (with the kept count) summed in f32 by one
    ``all_reduce``."""
    n, r = sctx.model_size, sctx.rank
    E, k = cfg.num_experts, cfg.experts_per_token
    e_loc = E // n
    T, D = x.shape
    dev, dt = x.device, x.dtype
    h = rms_norm(x, norm2_w, cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, router_w, h)
    fi, fg = idx.reshape(-1), gates.reshape(-1)
    tok = torch.arange(T * k, device=dev) // k
    slot = moe_mod._arrival_slots(fi, E)
    keep = slot < capacity
    slot_c = torch.clamp(slot, max=capacity - 1)
    fill = keep & ((fi // e_loc) == r)
    le = fi % e_loc
    buf = torch.zeros((e_loc, capacity, D), dtype=dt, device=dev)
    buf.index_put_((le, slot_c), h[tok] * fill[:, None].to(dt), accumulate=True)
    load = torch.zeros((E,), dtype=torch.int32, device=dev)
    load.scatter_add_(0, fi, torch.ones_like(fi, dtype=torch.int32))
    counts = torch.clamp(load[r * e_loc:(r + 1) * e_loc], max=capacity)
    out = ops.grouped_expert_ffn(buf, wg, wu, wd, counts)
    back = out[le, slot_c] * (fill[:, None] * fg[:, None]).to(out.dtype)
    back = back.to(dt).reshape(T, k, D)
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
    part = torch.cat([y.float().reshape(-1), fill.sum(dtype=torch.int32).float().reshape(1)])
    total = _to_device(_all_reduce(_to_host(part, "ep-a2a-combine", stats), sctx.group), dev)
    kept = total[-1].to(torch.int32)
    return total[:-1].reshape(T, D).to(dt), kept, T * k - kept, load


# ---------------------------------------------------------------------------
# Engine facade and the engine-facing stage
# ---------------------------------------------------------------------------
class ExpertParallelEngine:
    """``ExpertParallelEngine(cfg, params, plan, sctx, ...)`` is a
    ``ModuleBatchingEngine`` whose MoE decode stage is the collective one; the
    same engine is reachable by passing ``sctx=`` to ``ModuleBatchingEngine``
    (or ``ServeConfig(sctx=...)`` for serving)."""

    def __new__(cls, cfg, params, plan, sctx: ShardCtx, *,
                ep_chunks: int = 1, ep_serial: bool = False, **kwargs):
        from repro_torch.core.engine import ModuleBatchingEngine

        if sctx is None or sctx.group is None:
            raise ValueError(
                "ExpertParallelEngine needs a ShardCtx with a process group; "
                "use ModuleBatchingEngine for single-device")
        return ModuleBatchingEngine(cfg, params, plan, sctx=sctx, ep_chunks=ep_chunks,
                                    ep_serial=ep_serial, **kwargs)


@hot_path
def ep_expert_stage(engine, li: int, p, x):
    """One MoE layer's decode stage on an expert-parallel engine; returns
    ``(y, kept, dropped, load, a2a_bytes)``.

    ``a2a`` needs the batch divisible by the group size; otherwise, and on a
    one-rank group, the stage is the single-device grouped dispatch (which
    the a2a stage equals bit for bit when nothing drops), visible only in
    the byte count.  ``psum`` has no divisibility constraint."""
    cfg, sctx = engine.cfg, engine.sctx
    n, T = sctx.model_size, x.shape[0]
    cap = engine._expert_capacity(T)
    moe = p["moe"]
    if n > 1 and (sctx.moe_dispatch == "psum" or T % n == 0):
        lo, hi = sctx.rank * (cfg.num_experts // n), (sctx.rank + 1) * (cfg.num_experts // n)
        ws = (moe["experts_w_gate"][lo:hi], moe["experts_w_up"][lo:hi],
              moe["experts_w_down"][lo:hi])
        if sctx.moe_dispatch == "psum":
            out = _ep_psum_expert_module(cfg, sctx, cap, p["norm2"], moe["router"], *ws, x,
                                         engine.stats)
            return (*out, 0)
        chunks = pipeline_chunks(T // n, engine.ep_chunks)
        out = _ep_a2a_expert_module(cfg, sctx, chunks, cap, engine.ep_serial, p["norm2"],
                                    moe["router"], *ws, x, engine.stats)
        return (*out, a2a_bytes_per_stage(cfg, T, n, itemsize=x.element_size()))
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, moe["router"], h)
    y, kept, dropped, load = moe_mod.grouped_dispatch(
        cfg, h, gates, idx, moe["experts_w_gate"], moe["experts_w_up"],
        moe["experts_w_down"], cap)
    return y, kept, dropped, load, 0
