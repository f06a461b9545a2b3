"""Sparse MoE layer: top-k router, grouped capacity dispatch, dense oracle.

* ``grouped_dispatch`` / ``moe_apply_grouped`` -- the engine's expert
  module: routed token copies gathered into an (E, C, D) capacity buffer,
  ONE grouped FFN (``kernels.ops.grouped_expert_ffn``: the hand-written
  K1 + K2 kernels on the card), combined back weighted by their gates.
* ``predict_experts`` -- the next MoE layer's likely experts, from its
  router on the current hidden state (what predictive weight streaming
  prefetches);
* ``moe_apply_local`` -- exact dense-combine reference (every expert on
  every token), the oracle of the grouped path;
* ``moe_apply`` on a mesh -- ``moe_apply_sharded`` (psum: each rank's
  experts' share, ``_dispatch_combine``) and ``moe_apply_a2a`` (the token
  exchange, bucketed by ``_a2a_pages`` / ``_a2a_buckets`` / ``_a2a_rows``
  / ``_a2a_home``); the expert-parallel engine's decode stage runs the
  same bodies.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_moe_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = torch_dtype(cfg.dtype)
    return {
        "router": dense_init((d, e), gen, dtype=torch.float32),
        "experts_w_gate": dense_init((e, d, f), gen, in_dim=d, dtype=dt),
        "experts_w_up": dense_init((e, d, f), gen, in_dim=d, dtype=dt),
        "experts_w_down": dense_init((e, f, d), gen, in_dim=f, dtype=dt),
    }


# Rows of one router product.  cuBLAS picks its f32 algorithm by the shape of
# the product, so the logits of a token routed among n rows depend on n in
# their last bits (and a near tie can flip): a replica's or an expert rank's
# batch would route otherwise than one server's wave.  Products of a fixed
# ROUTER_ROWS rows, the last zero-padded, route a token alike in any batch
# (what that costs on an H100: tools/router_invariance.py, PERF.md).
ROUTER_ROWS = 1024


def router_logits(router_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (..., D) @ ``router_w`` (D, E) in f32, in products of
    ``ROUTER_ROWS`` rows: a row's logits do not depend on the rows beside
    it.  Served: the rows go to f32 in one copy into a buffer of whole
    blocks (the padding rows zeroed), and each block's product is written
    in place.  When autograd records (grad mode on, an input requiring
    grad), which refuses ``out=``, the same block products are
    concatenated instead: the same values bit for bit."""
    lead, D = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, D)
    n = rows.shape[0]
    total = n + (-n) % ROUTER_ROWS
    E = router_w.shape[1]
    if torch.is_grad_enabled() and (x.requires_grad or router_w.requires_grad):
        xf = torch.cat([rows.float(), rows.new_zeros((total - n, D), dtype=torch.float32)])
        logits = torch.cat([torch.mm(xf[i:i + ROUTER_ROWS], router_w)
                            for i in range(0, total, ROUTER_ROWS)])
        return logits[:n].reshape(lead + (E,))
    xf = torch.empty((total, D), dtype=torch.float32, device=x.device)
    xf[:n].copy_(rows)
    xf[n:].zero_()
    logits = torch.empty((total, E), dtype=torch.float32, device=x.device)
    for i in range(0, total, ROUTER_ROWS):
        torch.mm(xf[i:i + ROUTER_ROWS], router_w, out=logits[i:i + ROUTER_ROWS])
    return logits[:n].reshape(lead + (E,))


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """Top-k routing.  x: (..., D).  Returns (gates, idx, probs).

    Ties go to the lower expert index (``jax.lax.top_k``'s order): a stable
    descending sort keeps equal probabilities in index order.  A token's
    routing does not depend on the batch it comes in (``router_logits``)."""
    logits = router_logits(router_w, x)                     # (..., E)
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = srt[..., :k], order[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, probs


def load_balance_loss(cfg: ModelConfig, probs: torch.Tensor, idx: torch.Tensor):
    """Switch-style auxiliary load-balancing loss."""
    e = cfg.num_experts
    me = probs.reshape(-1, e).mean(dim=0)
    counts = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1), dtype=torch.float32))
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum(me * frac)


def expert_ffn(wg, wu, wd, h):
    """Dense grouped expert FFN (plain products).  h: (E, C, D) -> (E, C, D)."""
    g = torch.einsum("ecd,edf->ecf", h, wg)
    u = torch.einsum("ecd,edf->ecf", h, wu)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd)


# ---------------------------------------------------------------------------
# Grouped dispatch: capacity-bucketed gather -> one launch -> combine
# ---------------------------------------------------------------------------
def _arrival_slots(ids: torch.Tensor, n_buckets: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot of each routed copy within its bucket, in arrival order.

    Same result as the reference's cumsum over a (T*k, E) one-hot, from a
    stable sort instead: a copy's slot is the number of copies of its
    bucket before it, and a stable sort keeps them in arrival order.  O(T*k
    log) work where the one-hot scan is O(T*k*E) (it was the top prefill
    kernel).  Entries with ``mask`` False take no slot (the copies after
    them do not count them); their own slot is, as in the reference, the
    number of unmasked copies of their bucket before them."""
    order = torch.argsort(ids, stable=True)
    take = (torch.ones_like(ids) if mask is None
            else mask.reshape(-1).to(ids.dtype))
    counts = torch.zeros((n_buckets,), dtype=ids.dtype, device=ids.device)
    counts.scatter_add_(0, ids, take)
    starts = torch.cumsum(counts, dim=0) - counts
    ts = take[order]
    ranks = torch.cumsum(ts, dim=0) - ts - starts[ids[order]]
    slot = torch.empty_like(ranks)
    slot[order] = ranks
    return slot


def grouped_dispatch(
    cfg: ModelConfig,
    xt: torch.Tensor,       # (T, D) tokens
    gates: torch.Tensor,    # (T, k)
    idx: torch.Tensor,      # (T, k) expert ids
    wg, wu, wd,             # (E, ., .) expert weights
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The engine's expert module (paper §4.2), fully on device.

    Routed copies beyond ``capacity`` per expert are dropped (zero
    contribution).  Returns ``(y, kept, dropped, load)``: device int32
    scalars and ``load``, the (E,) routed-copy histogram counted before
    capacity drops.  No host sync happens here.  The combine sums each
    token's k copies in a fixed order (no float atomics)."""
    T, D = xt.shape
    E = cfg.num_experts
    k = cfg.experts_per_token
    dev = xt.device
    flat_idx = idx.reshape(-1)                              # (T*k,)
    flat_gate = gates.reshape(-1)
    slot = _arrival_slots(flat_idx, E)
    keep = slot < capacity
    slot_c = torch.clamp(slot, max=capacity - 1).long()
    tok = torch.arange(T * k, device=dev) // k
    buf = torch.zeros((E, capacity, D), dtype=xt.dtype, device=dev)
    # each kept copy owns its (expert, slot); dropped copies add zeros, so
    # the accumulation is exact whatever order it runs in
    buf.index_put_((flat_idx, slot_c), xt[tok] * keep[:, None].to(xt.dtype),
                   accumulate=True)
    load = torch.zeros((E,), dtype=torch.int32, device=dev)
    load.scatter_add_(0, flat_idx, torch.ones_like(flat_idx, dtype=torch.int32))
    counts = torch.clamp(load, max=capacity).to(torch.int32)
    out = ops.grouped_expert_ffn(buf, wg, wu, wd, counts)
    back = out[flat_idx, slot_c]                            # (T*k, D)
    back = back * (keep[:, None] * flat_gate[:, None]).to(back.dtype)
    y = _combine(back.to(xt.dtype), T, k)
    kept = keep.to(torch.int32).sum(dtype=torch.int32)
    return y, kept, T * k - kept, load


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    per = T * cfg.experts_per_token / max(cfg.num_experts, 1)
    c = int(per * cfg.capacity_factor) + 1
    return max(8, -(-c // 8) * 8)                           # round up to 8


def moe_apply_grouped(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    capacity: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped-dispatch MoE forward over (B, S, D); ``capacity`` defaults
    to ``moe_capacity`` (capacity-factor headroom over the balanced load)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    gates, idx, probs = route(cfg, p["router"], xt)
    cap = capacity if capacity is not None else moe_capacity(cfg, xt.shape[0])
    y, _, _, _ = grouped_dispatch(
        cfg, xt, gates, idx,
        p["experts_w_gate"], p["experts_w_up"], p["experts_w_down"], cap,
    )
    return y.reshape(B, S, D).to(x.dtype), load_balance_loss(cfg, probs, idx)


def predict_experts(cfg: ModelConfig, next_router_w: torch.Tensor, x: torch.Tensor,
                    khat: int) -> torch.Tensor:
    """Predict the next MoE layer's experts from the current hidden state:
    (khat,) int32 ids, on the device.

    Layer *l*'s post-mixer state through layer *l+1*'s router is a close
    proxy for *l+1*'s routing, because the residual stream changes slowly
    between adjacent layers.  The softmax probabilities (f32) are summed
    over tokens and the khat experts with the largest expected load are
    returned, ties to the lower id (``jax.lax.top_k``'s order).  The
    prediction only decides what to prefetch; the engine fetches any
    expert it missed on demand."""
    logits = x.float() @ next_router_w                      # (..., E)
    probs = torch.softmax(logits, dim=-1)
    scores = probs.reshape(-1, cfg.num_experts).sum(dim=0)
    _, order = torch.sort(scores, descending=True, stable=True)
    return order[:min(khat, cfg.num_experts)].to(torch.int32)


# ---------------------------------------------------------------------------
# Exact local reference
# ---------------------------------------------------------------------------
def moe_apply_local(
    cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense-combine MoE: exact, O(E * T * D * F) compute.  x: (B, S, D)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    gates, idx, probs = route(cfg, p["router"], xt)
    y = _dense_share(cfg, xt, gates, idx, p["experts_w_gate"], p["experts_w_up"],
                     p["experts_w_down"], 0)
    aux = load_balance_loss(cfg, probs, idx)
    return y.reshape(B, S, D).to(x.dtype), aux


# ---------------------------------------------------------------------------
# On a mesh (the model-sharding path)
# ---------------------------------------------------------------------------
def _expert_rows(buf: torch.Tensor, wg, wu, wd, counts: torch.Tensor,
                 differentiable: bool) -> torch.Tensor:
    """The FFN of a capacity buffer: the plain products under autograd
    (``differentiable``), else ``ops.grouped_expert_ffn`` (K1 + K2 on the
    card), which zeroes the rows past each expert's ``counts``."""
    if differentiable:
        return expert_ffn(wg, wu, wd, buf)
    return ops.grouped_expert_ffn(buf.contiguous(), wg, wu, wd, counts)


def _combine(back: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each token's k gate-weighted copies (T * k, D), summed in copy order."""
    back = back.reshape(T, k, -1)
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
    return y


def _dispatch_combine(cfg: ModelConfig, xt: torch.Tensor, gates: torch.Tensor,
                      idx: torch.Tensor, wg, wu, wd, e_lo: int, capacity: int,
                      differentiable: bool) -> torch.Tensor:
    """One rank's share of the capacity dispatch: the routed copies of
    ``xt`` (T, D) whose experts are this rank's (global ids ``[e_lo, e_lo +
    E_loc)``; an id of -1 is nobody's) go into an (E_loc, capacity, D)
    buffer in arrival order, copies past ``capacity`` dropped; the FFN
    (``_expert_rows``) and the gate-weighted combine follow.  Returns the
    (T, D) partial output (zero for other ranks' copies) and the count of
    copies kept.  The expert-parallel engine's psum stage is this with
    ``differentiable=False``."""
    T, D = xt.shape
    k = cfg.experts_per_token
    e_loc_n = wg.shape[0]
    flat_idx = idx.reshape(-1)
    local_e = flat_idx - e_lo
    mine = (local_e >= 0) & (local_e < e_loc_n)
    local_c = local_e.clamp(0, e_loc_n - 1)
    slot = _arrival_slots(local_c, e_loc_n, mask=mine)
    keep = mine & (slot < capacity)
    slot_c = slot.clamp(max=capacity - 1)
    tok = torch.arange(T * k, device=xt.device) // k
    buf = torch.zeros((e_loc_n, capacity, D), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((local_c, slot_c), xt[tok] * keep[:, None].to(xt.dtype),
                        accumulate=True)
    counts = torch.zeros((e_loc_n,), dtype=torch.int32, device=xt.device)
    counts.scatter_add_(0, local_c, keep.to(torch.int32))
    out = _expert_rows(buf, wg, wu, wd, counts, differentiable)
    back = out[local_c, slot_c] * (keep[:, None] * gates.reshape(-1)[:, None]).to(out.dtype)
    return _combine(back.to(xt.dtype), T, k), keep.to(torch.int32).sum(dtype=torch.int32)


def _dense_share(cfg: ModelConfig, xt: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
                 wg, wu, wd, e_lo: int) -> torch.Tensor:
    """``moe_apply_local``'s dense combine over the experts this rank holds
    (ids ``[e_lo, e_lo + E_loc)``, or every expert with a share of its
    hidden dim): the (T, D) partial output."""
    e_loc_n = wg.shape[0]
    h = xt[None].expand((e_loc_n,) + xt.shape)
    y_all = expert_ffn(wg, wu, wd, h)                                 # (E_loc, T, D)
    onehot = F.one_hot(idx, cfg.num_experts).to(torch.float32)
    weight = torch.einsum("tk,tke->te", gates, onehot)[:, e_lo:e_lo + e_loc_n]
    return torch.einsum("te,etd->td", weight.to(y_all.dtype), y_all)


def _balance(cfg: ModelConfig, ctx, probs: torch.Tensor, idx: torch.Tensor,
             over_model: bool, over_batch: bool) -> torch.Tensor:
    """``load_balance_loss`` over this rank's rows and, summed first, those
    of the other ranks of the model axis (``over_model``) and the batch
    axes (``over_batch``)."""
    from repro_torch.distributed import collectives as C

    e = cfg.num_experts
    p2 = probs.reshape(-1, e)
    psum = p2.sum(dim=0)
    counts = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1),
                                                            dtype=torch.float32))
    n = p2.shape[0]
    if over_model and ctx.model_group is not None:
        psum = C.reduce_model(ctx, psum)
        counts = C.all_reduce_value(counts, ctx.model_group)
        n *= ctx.model_size
    if over_batch and ctx.batch_group is not None:
        psum = C.reduce_batch(ctx, psum)
        counts = C.all_reduce_value(counts, ctx.batch_group)
        n *= ctx.batch_size
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    return e * torch.sum((psum / n) * frac)


def _tokens_for_work(ctx, x: torch.Tensor, gates, idx, k: int):
    """The residual's rows (B, S or S/m, D) and their routing as every token
    of this rank's batch rows, for work each model rank does a part of."""
    from repro_torch.distributed import collectives as C

    B, Sr, D = x.shape
    h = C.enter(ctx, x)
    g = C.enter(ctx, gates.reshape(B, Sr, k))
    i = (C.all_gather_value(ctx, idx.reshape(B, Sr, k), 1) if ctx.residual_split
         else idx.reshape(B, Sr, k))
    return h.reshape(-1, D), g.reshape(-1, k), i.reshape(-1, k)


def moe_apply_sharded(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, ctx,
                      small_batch_threshold: int = 4096, differentiable: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism over the model axis (the reference's ``psum``
    path); ``x`` is the residual's layout, normed.

    Each rank routes its own rows (the router is replicated and a token's
    routing does not depend on the rows beside it), then works on every
    token of its batch rows: with E >= m ranks it buckets the copies of its
    E/m experts into a capacity buffer (``_dispatch_combine``); with E < m
    each expert's m/E replicas split the copies by token; the partial
    outputs are summed over the model axis.  The load-balance loss is each
    batch shard's, averaged over the batch axes.

    An expert count and model axis neither of which divides the other, and
    batches of at most ``small_batch_threshold`` routed copies (global
    B * S * k), take the dense combine instead (``moe_apply_local``'s math
    on the experts or hidden-dim share each rank holds), whose loss is over
    every token, as the reference's GSPMD-sharded local path."""
    from repro_torch.distributed import collectives as C
    from repro_torch.sharding.specs import placement

    m, r = ctx.model_size, ctx.model_rank
    E, k = cfg.num_experts, cfg.experts_per_token
    B, Sr, D = x.shape
    split = ctx.residual_split
    S = Sr * (m if split else 1)
    gates, idx, probs = route(cfg, C.rows_weight(ctx, p["router"]), x.reshape(-1, D))
    ws = (p["experts_w_gate"], p["experts_w_up"], p["experts_w_down"])
    irregular = E % m != 0 and m % E != 0
    if irregular or B * ctx.batch_size * S * k <= small_batch_threshold:
        where = placement(cfg, m, "layers/*/moe/experts_w_gate")
        if where is None:                # every expert whole: the rows' own work
            y = _dense_share(cfg, x.reshape(-1, D), gates, idx,
                             *(C.rows_weight(ctx, w) for w in ws), 0)
            y = y.reshape(B, Sr, D)
        else:
            h, g, i = _tokens_for_work(ctx, x, gates, idx, k)
            e_lo = r * (E // m) if where[0] == 0 else 0
            y = C.leave(ctx, _dense_share(cfg, h, g, i, *ws, e_lo).reshape(B, S, D))
        aux = _balance(cfg, ctx, probs, idx, over_model=split, over_batch=True)
        return y.to(x.dtype), aux
    h, g, i = _tokens_for_work(ctx, x, gates, idx, k)
    cap = moe_capacity(cfg, h.shape[0])
    if E % m == 0:
        y, _ = _dispatch_combine(cfg, h, g, i, *ws, r * (E // m), cap, differentiable)
    else:
        # E < m: each expert on m/E ranks, the replicas splitting its copies
        n_rep, mine = m // E, r % E
        tok = torch.arange(h.shape[0] * k, device=h.device).reshape(-1, k) // k
        share = (tok % n_rep) == r // E
        g = torch.where(share, g, torch.zeros_like(g))
        i = torch.where(share, i, torch.full_like(i, -1))
        if placement(cfg, m, "layers/*/moe/experts_w_gate") is None:
            whole = [C.to_model(ctx, w) for w in ws]
        else:                            # hidden dim split: gather it
            whole = [C.gather_model(ctx, w, 1 if n == 2 else 2, partial=True)
                     for n, w in enumerate(ws)]
        y, _ = _dispatch_combine(cfg, h, g, i, *(w[mine:mine + 1] for w in whole), mine,
                                 max(8, -(-cap // n_rep)), differentiable)
    y = C.leave(ctx, y.reshape(B, S, D))
    aux = _balance(cfg, ctx, probs, idx, over_model=split, over_batch=False)
    aux = C.reduce_batch(ctx, aux) / ctx.batch_size
    return y.to(x.dtype), aux


def _a2a_pages(xt: torch.Tensor, idx: torch.Tensor, e_loc: int, n: int, cap: int):
    """The routed copies of ``xt`` (T, D) paged by the rank owning their
    expert (experts ``[j * e_loc, (j + 1) * e_loc)`` on rank j), in arrival
    order, for an all-to-all: (n, cap, D) rows and (n, cap) int32 local
    expert ids + 1 (0: an empty slot); copies past ``cap`` a rank are
    dropped.  Also returns ``(dst, slot, keep)`` per copy, which brings the
    rows home (``_a2a_home``)."""
    T, D = xt.shape
    k = idx.shape[-1]
    flat = idx.reshape(-1)
    dst = flat // e_loc
    slot = _arrival_slots(dst, n)
    keep = slot < cap
    slot = slot.clamp(max=cap - 1)
    tok = torch.arange(T * k, device=xt.device) // k
    send = torch.zeros((n, cap, D), dtype=xt.dtype, device=xt.device).index_put(
        (dst, slot), xt[tok] * keep[:, None].to(xt.dtype), accumulate=True)
    ids = torch.zeros((n, cap), dtype=torch.int32, device=xt.device)
    ids.index_put_((dst, slot), torch.where(keep, flat % e_loc + 1, 0).to(torch.int32),
                   accumulate=True)
    return send, ids, (dst, slot, keep)


def _a2a_buckets(h: torch.Tensor, le: torch.Tensor, e_loc: int, cap: int):
    """An owner's arrivals (rows ``h`` (N, D), ids ``le`` as ``_a2a_pages``
    sent them) bucketed by local expert in arrival order into an (e_loc,
    cap, D) buffer, copies past ``cap`` dropped.  Returns the buffer, the
    kept count per expert and ``(expert, slot, keep)`` per arrival."""
    le = le.long()
    valid = le > 0
    le0 = (le - 1).clamp(min=0)
    slot = _arrival_slots(le0, e_loc, mask=valid)
    keep = valid & (slot < cap)
    slot = slot.clamp(max=cap - 1)
    buf = torch.zeros((e_loc, cap, h.shape[-1]), dtype=h.dtype, device=h.device).index_put(
        (le0, slot), h * keep[:, None].to(h.dtype), accumulate=True)
    counts = torch.zeros((e_loc,), dtype=torch.int32, device=h.device)
    counts.scatter_add_(0, le0, keep.to(torch.int32))
    return buf, counts, (le0, slot, keep)


def _a2a_rows(out: torch.Tensor, at) -> torch.Tensor:
    """Each arrival's FFN row from the owner's (e_loc, cap, D) ``out``
    (zero where dropped or empty), in arrival order: the return exchange."""
    le0, slot, keep = at
    return out[le0, slot] * keep[:, None].to(out.dtype)


def _a2a_home(ret: torch.Tensor, where, gates: torch.Tensor, T: int, k: int,
              dtype: torch.dtype) -> torch.Tensor:
    """The returned (n, cap, D) rows at home: each copy's row by its
    ``(dst, slot, keep)`` (``_a2a_pages``), weighted by its gate, the k
    copies of a token summed in copy order (``grouped_dispatch``'s)."""
    dst, slot, keep = where
    got = ret[dst, slot] * (keep[:, None] * gates.reshape(-1)[:, None]).to(ret.dtype)
    return _combine(got.to(dtype), T, k)


def moe_apply_a2a(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, ctx,
                  differentiable: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert parallelism with an all-to-all token exchange (the reference's
    ``a2a`` path): the tokens split over the model axis too, each rank
    routes its own T/m and ships each routed copy once to the rank owning
    its expert, which buckets its arrivals, runs the FFN and ships the rows
    back.  The load-balance loss is each rank's, averaged over the model and
    batch axes.  Needs E % m == 0, global B * S % m == 0 and, unlike the
    reference (which then routes every token on every rank), a sequence the
    model axis divides; otherwise ``moe_apply_sharded``."""
    from repro_torch.distributed import collectives as C

    m = ctx.model_size
    E, k = cfg.num_experts, cfg.experts_per_token
    B, Sr, D = x.shape
    split = ctx.residual_split
    S = Sr * (m if split else 1)
    if m == 1 or E % m or (B * ctx.batch_size * S) % m or S % m:
        return moe_apply_sharded(cfg, p, x, ctx, differentiable=differentiable)
    xr = x if split else C.split_model(ctx, x, 1)
    xt = xr.reshape(-1, D)
    T_r = xt.shape[0]
    gates, idx, probs = route(cfg, C.to_model(ctx, p["router"]), xt)
    e_loc_n = E // m
    cap = max(8, -(-int(T_r * k * cfg.capacity_factor) // m // 8) * 8)
    send, ids, where = _a2a_pages(xt, idx, e_loc_n, m, cap)
    recv = C.all_to_all_model(ctx, send)
    with torch.no_grad():
        le = C.all_to_all_model(ctx, ids).reshape(-1)
    cap2 = max(8, -(-m * cap // e_loc_n // 8) * 8)
    buf, counts, at = _a2a_buckets(recv.reshape(-1, D), le, e_loc_n, cap2)
    out = _expert_rows(buf, p["experts_w_gate"], p["experts_w_up"], p["experts_w_down"],
                       counts, differentiable)
    ret = C.all_to_all_model(ctx, _a2a_rows(out, at).to(xt.dtype).reshape(m, cap, D))
    y = _a2a_home(ret, where, gates, T_r, k, xt.dtype).reshape(xr.shape)
    if not split:
        y = C.gather_model(ctx, y, 1, partial=False)
    aux = C.reduce_model(ctx, load_balance_loss(cfg, probs, idx)) / m
    aux = C.reduce_batch(ctx, aux) / ctx.batch_size
    return y.to(x.dtype), aux


def moe_apply(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor, ctx=None,
              differentiable: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer under ``ctx``: on a mesh its ``moe_dispatch`` (``"a2a"``
    or the default ``"psum"``); without one the dense-combine reference.
    ``"grouped"`` is the single-device capacity path and refused on a
    mesh."""
    if ctx is None or not ctx.on_mesh:
        return moe_apply_local(cfg, p, x)
    if ctx.moe_dispatch == "grouped":
        raise ValueError("moe_dispatch='grouped' is the single-device capacity path; "
                         "use 'psum' or 'a2a' on a mesh")
    if ctx.moe_dispatch == "a2a":
        return moe_apply_a2a(cfg, p, x, ctx, differentiable)
    return moe_apply_sharded(cfg, p, x, ctx, differentiable=differentiable)
