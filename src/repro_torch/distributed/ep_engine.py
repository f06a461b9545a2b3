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

The transport is gloo, which exchanges host tensors, through the
model-sharding path's own (``distributed.collectives``: ``_stage``,
``_post_all_to_all``, ``_all_gather``, ``_all_reduce``, counted in its
``STATS`` too).  Each exchange stages its device buffer through the host
in one planned read (an ``allowed`` scope tagged ``ep-a2a-batch`` on the
way out, ``ep-a2a-combine`` for the return and the gather, counted in
``EngineStats.planned_reads``) and goes back up by one asynchronous copy.
An a2a stage of c chunks makes 2c + 1 such reads, a psum stage one.  The
bucketing and combine are ``models.moe``'s (``_a2a_pages``,
``_a2a_buckets``, ``_a2a_rows``, ``_a2a_home``; the psum stage is
``_dispatch_combine``), which the model path's ``moe_apply_a2a`` and
``moe_apply_sharded`` run too.  Every collective lives in a function
marked ``@register_collective`` (lint rule MG107).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.analysis.registry import register_collective
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
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
# Byte packing (the exchanges themselves are ``distributed.collectives``')
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
    meta = [(dt, (cap_s, D)), (torch.int32, (cap_s,))]

    def dispatch(c: int):
        """Chunk c's routed copies, paged by owner, sent on their way."""
        rows = slice(c * t_c, (c + 1) * t_c)
        send, ids, where = moe_mod._a2a_pages(h[rows], idx[rows], e_loc, n, cap_s)
        b = _as_bytes(send, ids)
        return where, b, C._post_all_to_all(b, group, "ep-a2a-batch", stats)

    posted = [dispatch(0)]
    ys = []
    kept = torch.zeros((1,), dtype=torch.int32, device=dev)
    for c in range(chunks):
        if not serial and c + 1 < chunks:
            posted.append(dispatch(c + 1))        # before chunk c's FFN
        where, b, (recv, work) = posted[c]
        C.wait(work)
        hr, le = _from_bytes(C._unstage(recv, b), meta)
        # the owner's buckets: arrivals in (source rank, source slot) order
        buf, counts, at = moe_mod._a2a_buckets(hr.reshape(n * cap_s, D), le.reshape(-1),
                                               e_loc, cap_l)
        out = moe_mod._expert_rows(buf, wg, wu, wd, counts, differentiable=False)
        back = _as_bytes(moe_mod._a2a_rows(out, at).reshape(n, cap_s, D))
        ret, rwork = C._post_all_to_all(back, group, "ep-a2a-combine", stats)
        C.wait(rwork)
        (ret,) = _from_bytes(C._unstage(ret, back), meta[:1])
        # home: grouped_dispatch's gate product and sum over the k copies
        ys.append(moe_mod._a2a_home(ret, where, gates[c * t_c:(c + 1) * t_c], t_c, k, dt))
        kept += at[2].to(torch.int32).sum(dtype=torch.int32)
        if serial and c + 1 < chunks:
            posted.append(dispatch(c + 1))        # after chunk c's exchanges
    # every rank's rows and kept counts: one gather in place of the
    # reference's device_put home and psum
    mine = _as_bytes(torch.cat(ys).reshape(1, -1), kept.reshape(1, -1))
    allb = C._all_gather(mine, group, 0, "ep-a2a-combine", stats)
    y_all, kept_r = _from_bytes(allb, [(dt, (T_r, D)), (torch.int32, (1,))])
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
    E = cfg.num_experts
    e_loc = E // n
    T, D = x.shape
    h = rms_norm(x, norm2_w, cfg.norm_eps)
    gates, idx, _ = moe_mod.route(cfg, router_w, h)
    load = torch.zeros((E,), dtype=torch.int32, device=x.device)
    load.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1), dtype=torch.int32))
    # a copy's slot among its expert's copies is the single-device one
    y, kept = moe_mod._dispatch_combine(cfg, h, gates, idx, wg, wu, wd, r * e_loc, capacity,
                                        differentiable=False)
    part = torch.cat([y.float().reshape(-1), kept.float().reshape(1)])
    total = C._all_reduce(part, sctx.group, tag="ep-a2a-combine", stats=stats)
    kept = total[-1].to(torch.int32)
    return total[:-1].reshape(T, D).to(x.dtype), kept, T * cfg.experts_per_token - kept, load


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
