"""Attention: GQA with RoPE; full-sequence (prefill) and decode paths.

* ``full_attention`` -- every prefill: causal GQA attention with an optional
  sliding window and per-row ``lengths`` of a right-padded batch; its
  mechanism is the hand-written flash-attention kernel
  (``kernels.ops.flash_attention``), whose plain version runs on the CPU.
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
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["wq_bias"]
        k = k + p["wk_bias"]
        v = v + p["wv_bias"]
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


# ---------------------------------------------------------------------------
# Full-sequence attention ((B, S, H, D) / (B, S, K, D))
# ---------------------------------------------------------------------------
def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int = 0,
    lengths: Optional[torch.Tensor] = None, q_offset: int = 0,
) -> torch.Tensor:
    """Causal attention of every prefill, at any length: query i (absolute
    position ``q_offset + i``, keys from position 0) sees keys
    ``i - window < j <= i`` (no lower limit when ``window`` is 0) and
    ``j < lengths[b]``.  Output rows at or past ``lengths[b]`` are zeros
    (they are never read).  K4 on a CUDA tensor, its plain version on the
    CPU -- the reference's naive, blocked and sliding-window dispatch."""
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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence attention.  Returns (output, {"k", "v"}) so prefill
    can cache.  ``lengths`` (B,) masks the keys at right-padded positions;
    outputs at padded query positions are never read (the attention writes
    them as zeros).  ``prefix_kv`` (k, v), each (B, P, K, hd): the cached
    KV of the first P positions (a prefix-cache hit); ``x`` is then the
    suffix at ``positions`` P.., its keys follow the prefix's, and the
    entry returned is the whole row's."""
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
                         q_offset=q_offset)
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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against a preallocated (possibly circular) cache.

    Each row writes its new K/V IN PLACE at slot ``pos`` (``pos % span``
    under a sliding window, else clamped to the last slot) and attends its
    own slots ``<= pos``; the mechanism is ``ops.decode_attention``.
    Returns (y (B, 1, D), cache) -- the same cache tensors."""
    B = x.shape[0]
    posv = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    posv = posv.reshape(-1).expand(B)
    q, k, v = decode_qkv(cfg, p, x, posv)                  # (B, 1, ., hd)
    span = cache["k"].shape[1]
    slot = decode_slot(cfg, posv, span)
    rows = torch.arange(B, device=x.device)
    cache["k"][rows, slot] = k[:, 0]
    cache["v"][rows, slot] = v[:, 0]
    o = ops.decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"], posv)
    y = o.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ p["wo"]
    return y, cache
