"""Sparse MoE layer: top-k router, grouped capacity dispatch, dense oracle.

* ``grouped_dispatch`` / ``moe_apply_grouped`` -- the engine's expert
  module: routed token copies gathered into an (E, C, D) capacity buffer,
  ONE grouped FFN (``kernels.ops.grouped_expert_ffn``: the hand-written
  K1 + K2 kernels on the card), combined back weighted by their gates.
* ``predict_experts`` -- the next MoE layer's likely experts, from its
  router on the current hidden state (what predictive weight streaming
  prefetches);
* ``moe_apply_local`` -- exact dense-combine reference (every expert on
  every token), the oracle of the grouped path.
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
    back = back.to(xt.dtype).reshape(T, k, D)
    y = back[:, 0]
    for j in range(1, k):
        y = y + back[:, j]
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
    h = xt[None].expand((cfg.num_experts,) + xt.shape)
    y_all = expert_ffn(
        p["experts_w_gate"], p["experts_w_up"], p["experts_w_down"], h
    )                                                       # (E, T, D)
    onehot = F.one_hot(idx, cfg.num_experts).to(torch.float32)
    weight = torch.einsum("tk,tke->te", gates, onehot)      # (T, E)
    y = torch.einsum("te,etd->td", weight.to(y_all.dtype), y_all)
    aux = load_balance_loss(cfg, probs, idx)
    return y.reshape(B, S, D).to(x.dtype), aux
