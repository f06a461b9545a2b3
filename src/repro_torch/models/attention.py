"""Attention: GQA with RoPE; full-sequence (prefill, training) and decode
paths.

* ``full_attention`` -- every prefill: causal GQA attention with an optional
  sliding window and per-row ``lengths`` of a right-padded batch; its
  mechanism is the hand-written flash-attention kernel
  (``kernels.ops.flash_attention``), whose plain version runs on the CPU.
  With ``differentiable=True`` (training) it is the reference's dispatch
  over three plain-PyTorch versions instead, which autograd differentiates:
  ``naive_attention`` (materialized scores, S <= 1024),
  ``blocked_attention`` (online softmax over KV blocks) and
  ``swa_attention`` (a sliding window past the window, computing only the
  window).  No kernel has a backward.
* ``attn_decode``    -- one new token per sequence against a preallocated
  (possibly circular) cache, written in place; its mechanism is the
  hand-written decode-attention kernel (``kernels.ops.decode_attention``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def init_attn_params(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg.dtype)
    p = {
        "wq": dense_init((d, h * hd), gen, dtype=dt),
        "wk": dense_init((d, kv * hd), gen, dtype=dt),
        "wv": dense_init((d, kv * hd), gen, dtype=dt),
        "wo": dense_init((h * hd, d), gen, in_dim=h * hd, dtype=dt),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["wq_bias"] = torch.zeros((h * hd,), dtype=dt, device=dev)
        p["wk_bias"] = torch.zeros((kv * hd,), dtype=dt, device=dev)
        p["wv_bias"] = torch.zeros((kv * hd,), dtype=dt, device=dev)
    return p


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """q (B, S, heads, hd), k and v (B, S, KV heads, hd); the head counts are
    the weights' (on a mesh, this rank's)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["wq_bias"]
        k = k + p["wk_bias"]
        v = v + p["wv_bias"]
    hd = cfg.head_dim
    q = q.reshape(B, S, p["wq"].shape[-1] // hd, hd)
    k = k.reshape(B, S, p["wk"].shape[-1] // hd, hd)
    v = v.reshape(B, S, p["wv"].shape[-1] // hd, hd)
    return q, k, v


# ---------------------------------------------------------------------------
# Differentiable attention math (q (B, Sq, H, D); k, v (B, Sk, K, D))
# ---------------------------------------------------------------------------
def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, K, G, D), k: (B, Sk, K, D) -> (B, K, G, Sq, Sk) in f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def naive_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, q_offset: int = 0, kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Materialized-scores attention.  ``kv_mask`` (B, Sk) bool marks the
    valid keys of a ragged batch."""
    B, Sq, H, D = q.shape
    K, Sk = k.shape[2], k.shape[1]
    G = H // K
    scores = _gqa_scores(q.reshape(B, Sq, K, G, D), k) * D ** -0.5   # (B,K,G,Sq,Sk)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    scores = scores.masked_fill(~mask, NEG_INF)
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, D)


def blocked_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    window: int = 0, q_block: int = 512, kv_block: int = 512,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flash-style attention: an online softmax over KV blocks, O(S *
    kv_block) memory.  Every KV block is computed and masked.  A length
    that does not divide into blocks takes ``naive_attention``."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    if S % q_block or S % kv_block:
        return naive_attention(q, k, v, causal=causal, window=window, kv_mask=kv_mask)
    scale = D ** -0.5
    nq, nk = S // q_block, S // kv_block
    dev = q.device
    qb = q.reshape(B, nq, q_block, K, G, D).float()
    qpos = (torch.arange(nq, device=dev)[:, None] * q_block
            + torch.arange(q_block, device=dev)[None, :])             # (nq, qb)
    m = torch.full((B, nq, K, G, q_block), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, nq, K, G, q_block), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, K, G, q_block, D), dtype=torch.float32, device=dev)
    for i in range(nk):
        ks = k[:, i * kv_block:(i + 1) * kv_block]
        vs = v[:, i * kv_block:(i + 1) * kv_block]
        s = torch.einsum("bnqkgd,bjkd->bnkgqj", qb, ks.float()) * scale
        kpos = i * kv_block + torch.arange(kv_block, device=dev)
        mask = torch.ones((nq, q_block, kv_block), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[..., None] >= kpos[None, None, :]
        if window:
            mask &= qpos[..., None] - kpos[None, None, :] < window
        s = s.masked_fill(~mask[None, :, None, None], NEG_INF)
        if kv_mask is not None:
            km = kv_mask[:, i * kv_block:(i + 1) * kv_block]            # (B, kb)
            s = s.masked_fill(~km[:, None, None, None, None, :], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bnkgqj,bjkd->bnkgqd", p.to(vs.dtype), vs)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.to(q.dtype).permute(0, 1, 4, 2, 3, 5)                    # (B,nq,qb,K,G,D)
    return out.reshape(B, S, H, D)


def swa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int,
    q_block: int = 512, kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sliding-window attention computing only the window: each query block
    attends a slice of ``window + q_block`` keys ending at its last
    position.  A ragged batch, or a length this does not cover, takes
    ``naive_attention``."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    if kv_mask is not None or S <= window + q_block or S % q_block:
        return naive_attention(q, k, v, causal=True, window=window, kv_mask=kv_mask)
    scale = D ** -0.5
    span = window + q_block
    dev = q.device
    # keys and values padded on the left so every slice is in bounds
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    outs = []
    for i in range(S // q_block):
        qs = q[:, i * q_block:(i + 1) * q_block].reshape(B, q_block, K, G, D)
        # in padded coordinates query block i sees keys [i*qb, i*qb + span)
        ks = kp[:, i * q_block:i * q_block + span]
        vs = vp[:, i * q_block:i * q_block + span]
        s = _gqa_scores(qs, ks) * scale                                   # (B,K,G,qb,span)
        qpos = i * q_block + torch.arange(q_block, device=dev)
        kpos = i * q_block + torch.arange(span, device=dev) - window    # original coords
        mask = ((qpos[:, None] >= kpos[None, :]) & (qpos[:, None] - kpos[None, :] < window)
                & (kpos[None, :] >= 0))
        p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p.to(vs.dtype), vs)
        outs.append(o.reshape(B, q_block, H, D))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Full-sequence attention ((B, S, H, D) / (B, S, K, D))
# ---------------------------------------------------------------------------
def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    lengths: Optional[torch.Tensor] = None, q_offset: int = 0,
    differentiable: bool = False,
) -> torch.Tensor:
    """Causal attention of every prefill, at any length: query i (absolute
    position ``q_offset + i``, keys from position 0) sees keys
    ``i - window < j <= i`` (no lower limit when ``window`` is 0) and
    ``j < lengths[b]``.  Output rows at or past ``lengths[b]`` are zeros
    (they are never read).  K4 on a CUDA tensor, its plain version on the
    CPU.  ``differentiable``: the reference's dispatch instead (a sliding
    window past the window ``swa_attention``, S <= 1024 or a query offset
    ``naive_attention``, else ``blocked_attention``), whose rows past
    ``lengths[b]`` are not zeroed."""
    if differentiable:
        kv_mask = None
        if lengths is not None:
            Sk = k.shape[1]
            lens = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
            kv_mask = torch.arange(Sk, device=q.device)[None, :] < lens
        S = q.shape[1]
        if q_offset or (S <= 1024 and not (window and S > window)):
            return naive_attention(q, k, v, causal=True, window=window,
                                   q_offset=q_offset, kv_mask=kv_mask)
        if window and S > window:
            return swa_attention(q, k, v, window=window, kv_mask=kv_mask)
        return blocked_attention(q, k, v, causal=True, window=window, kv_mask=kv_mask)
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               window=window, lengths=lengths, q_offset=q_offset)


# ---------------------------------------------------------------------------
# Module-level forward passes
# ---------------------------------------------------------------------------
def attn_forward(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    prefix_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    differentiable: bool = False,
    ctx=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention.  Returns (output, {"k", "v"}) so prefill
    can cache.  ``lengths`` (B,) masks the keys at right-padded positions;
    outputs at padded query positions are never read (the attention writes
    them as zeros).  ``prefix_kv`` (k, v), each (B, P, K, hd): the cached
    KV of the first P positions (a prefix-cache hit); ``x`` is then the
    suffix at ``positions`` P.., its keys follow the prefix's, and the
    entry returned is the whole row's.  ``differentiable`` as
    ``full_attention``'s (training).  ``ctx`` on a mesh: ``attn_forward_mesh``."""
    if ctx is not None and ctx.on_mesh:
        assert prefix_kv is None, "a cached prefix is not sharded"
        return attn_forward_mesh(cfg, p, x, ctx, positions, lengths, differentiable)
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q_offset = 0
    if prefix_kv is not None:
        q_offset = prefix_kv[0].shape[1]
        k, v = torch.cat([prefix_kv[0], k], dim=1), torch.cat([prefix_kv[1], v], dim=1)
    out = full_attention(q, k, v, window=cfg.sliding_window, lengths=lengths,
                         q_offset=q_offset, differentiable=differentiable)
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return y, {"k": k, "v": v}


def kv_span(cfg: ModelConfig, max_seq: int) -> int:
    return min(max_seq, cfg.sliding_window) if cfg.sliding_window else max_seq


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Zeroed (batch, span, K, hd) K and V buffers on ``device`` (``cuda``
    by default; raises without CUDA)."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (batch, kv_span(cfg, max_seq), cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_qkv(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               posv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A decode step's projections with rope at positions ``posv`` (B,):
    q (B, 1, H, hd), k and v (B, 1, K, hd)."""
    q, k, v = _project_qkv(cfg, p, x)
    posb = posv[:, None]
    return apply_rope(q, posb, cfg.rope_theta), apply_rope(k, posb, cfg.rope_theta), v


def decode_slot(cfg: ModelConfig, posv, span: int):
    """The cache slot a decode step at ``posv`` writes: ``pos % span`` under a
    sliding window (a ring), else ``pos`` clamped to the last slot.  Works on
    tensors and numpy arrays alike."""
    if cfg.sliding_window > 0:
        return posv % span
    if torch.is_tensor(posv):
        return torch.clamp(posv, max=span - 1)
    return posv.clip(max=span - 1)


def attn_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                       # (B, 1, D)
    cache: Dict[str, torch.Tensor],        # (B, span, K, hd), written in place
    pos,                                   # int or (B,) int: current position
    ctx=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against a preallocated (possibly circular) cache.

    Each row writes its new K/V IN PLACE at slot ``pos`` (``pos % span``
    under a sliding window, else clamped to the last slot) and attends its
    own slots ``<= pos``; the mechanism is ``ops.decode_attention``.
    Returns (y (B, 1, D), cache) -- the same cache tensors.

    On a mesh (``ctx``) whose model axis divides the heads, each rank
    attends its H/m heads against its cache (its K/m KV heads, or all K
    when the axis does not divide them), ``wo`` row-parallel and its
    partial sums all-reduced; otherwise every rank computes every head."""
    m = 1 if ctx is None or not ctx.on_mesh else ctx.model_size
    split = m > 1 and cfg.num_heads % m == 0
    if split:
        from repro_torch.distributed import collectives as C

        x = C.to_model(ctx, x)
    B = x.shape[0]
    posv = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    posv = posv.reshape(-1).expand(B)
    q, k, v = decode_qkv(cfg, p, x, posv)                  # (B, 1, ., hd)
    span = cache["k"].shape[1]
    slot = decode_slot(cfg, posv, span)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    ck, cv = cache["k"], cache["v"]
    if split and cfg.num_kv_heads % m:
        ck, cv = (_kv_for_heads(cfg, t, m, ctx.model_rank) for t in (ck, cv))
    o = ops.decode_attention(q[:, 0].contiguous(), ck, cv, posv)
    y = o.reshape(B, 1, p["wo"].shape[0]) @ p["wo"]
    return (C.reduce_model(ctx, y) if split else y), cache


# ---------------------------------------------------------------------------
# On a mesh (the model-sharding path)
# ---------------------------------------------------------------------------
def _kv_for_heads(cfg: ModelConfig, k: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """All ``K`` KV heads (dim 2) -> those rank ``r``'s H/m query heads read,
    so that the local heads group as GQA does: a contiguous run of KV heads
    when each serves whole groups, one head when the local heads share it,
    else one KV head per query head."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    G, n = H // K, H // m
    lo = (r * n) // G
    if n % G == 0:
        return k[:, :, lo:lo + n // G]
    if G % n == 0:
        return k[:, :, lo:lo + 1]
    idx = torch.arange(r * n, (r + 1) * n, device=k.device) // G
    return k.index_select(2, idx)


def attn_forward_mesh(cfg: ModelConfig, p, x: torch.Tensor, ctx,
                      positions: Optional[torch.Tensor] = None,
                      lengths: Optional[torch.Tensor] = None,
                      differentiable: bool = False):
    """``attn_forward`` on a mesh; ``x`` is the residual's layout (``ctx``,
    ``collectives.enter``).

    When the model axis divides the heads, each rank computes its H/m heads
    (its KV heads too when it divides those, else every KV head, whole) and
    ``wo`` is row-parallel: partial sums all-reduced, or reduce-scattered
    under ``seq_shard``.  Otherwise context parallelism: each rank computes
    its S/m query rows against the whole sequence's keys and values, every
    weight whole (all rows on every rank when S does not split, or under a
    sliding window without autograd, which K4 does not take with a query
    offset).  The cache entry is this rank's KV heads (or all of them)."""
    from repro_torch.distributed import collectives as C

    m, r = ctx.model_size, ctx.model_rank
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    split = ctx.residual_split
    B = x.shape[0]
    S = x.shape[1] * (m if split else 1)
    pos = torch.arange(S, device=x.device)[None, :] if positions is None else positions
    if H % m == 0:
        h = C.enter(ctx, x)
        kv_split = K % m == 0
        if not kv_split:                 # whole KV weights serve every rank's heads
            p = {n: (t if n in ("wq", "wq_bias", "wo") else C.to_model(ctx, t))
                 for n, t in p.items()}
        q, k, v = _project_qkv(cfg, p, h)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
        ka, va = (k, v) if kv_split else (_kv_for_heads(cfg, k, m, r),
                                          _kv_for_heads(cfg, v, m, r))
        out = full_attention(q, ka, va, window=cfg.sliding_window, lengths=lengths,
                             differentiable=differentiable)
        y = out.reshape(B, S, (H // m) * hd) @ p["wo"]
        return C.leave(ctx, y), {"k": k, "v": v}
    # context parallelism: every weight whole, used for this rank's rows
    rows = S % m == 0 and (differentiable or not cfg.sliding_window)
    w = {n: (C.to_model(ctx, t) if rows else t) for n, t in p.items()}
    if rows and split:
        hq, hkv = x, C.gather_model(ctx, x, 1, partial=True)
    elif rows:
        hq, hkv = C.split_model(ctx, x, 1), C.to_model(ctx, x)
    else:
        hq = hkv = C.whole_sequence(ctx, x)
    n_q = hq.shape[1]
    off = r * n_q if rows else 0
    q, _, _ = _project_qkv(cfg, w, hq)
    _, k, v = _project_qkv(cfg, w, hkv)
    q = apply_rope(q, pos[:, off:off + n_q], cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    # the keys past the last query row are masked: K4 takes q_offset + Sq keys
    out = full_attention(q, k[:, :off + n_q], v[:, :off + n_q], window=cfg.sliding_window,
                         lengths=lengths, q_offset=off, differentiable=differentiable)
    y = out.reshape(B, n_q, H * hd) @ w["wo"]
    if not rows:
        y = C.residual_rows(ctx, y)
    elif not split:
        y = C.gather_model(ctx, y, 1, partial=False)
    return y, {"k": k, "v": v}
