"""Host-side decode attention: the paper's CPU attention (§4.2 and §B).

MoE-Gen accumulates tokens in host memory and runs the attention mechanism
of a fraction omega of the batch on the host CPU, where those rows' KV cache
lives, so that no KV byte of theirs crosses the bus on a decode tick.  This
is that mechanism, in PyTorch on CPU tensors.  It runs on the host by
design: it is the mechanism itself and its own plain version.

The paper's numerical-consistency scheme (§B): bf16 operands are held in
f32 with their trailing mantissa bits zero, the dot products accumulate in
f32, each score is rounded back to bf16 after its dot product, and the
probabilities and the output are rounded to bf16 too.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """An f32 tensor of ``x``'s values rounded to bf16 (nearest even)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _as_bf16_f32(x: torch.Tensor) -> torch.Tensor:
    """``round_bf16(x)``; a bf16 tensor only widens (the rounding is exact)."""
    return x.float() if x.dtype == torch.bfloat16 else round_bf16(x.float())


def host_decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos) -> torch.Tensor:
    """Decode-step GQA with the §B arithmetic: q (B, H, D); k_cache and
    v_cache (B, S, K, D); ``pos`` an int or a (B,) vector, row b attending
    its slots ``<= pos[b]``.  Returns (B, H, D) f32 holding bf16 values."""
    return host_decode_attention_heads(q, to_heads(k_cache), to_heads(v_cache), pos)


def to_heads(kv: torch.Tensor) -> torch.Tensor:
    """(B, S, K, D) KV as the mechanism reads it: (B, K, S, D) f32 holding
    bf16 values, contiguous (each head's slots one matrix)."""
    return _as_bf16_f32(kv).permute(0, 2, 1, 3).contiguous()


def host_decode_attention_heads(q: torch.Tensor, k_heads: torch.Tensor,
                                v_heads: torch.Tensor, pos) -> torch.Tensor:
    """``host_decode_attention`` on KV already in the mechanism's layout
    (``to_heads``: (B, K, S, D) f32 holding bf16 values), as the engine keeps
    its host rows' KV, so that a decode step neither widens nor transposes
    the cache."""
    B, H, D = q.shape
    K, S = k_heads.shape[1], k_heads.shape[2]
    qf = _as_bf16_f32(q).reshape(B, K, H // K, D)
    scores = torch.matmul(qf, k_heads.transpose(-1, -2)) * (D ** -0.5)   # (B, K, G, S)
    scores = round_bf16(scores)                        # §B: round after the dot
    posv = torch.as_tensor(pos, dtype=torch.long).reshape(-1, 1)    # (B|1, 1)
    valid = torch.arange(S)[None, :] <= posv
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(round_bf16(probs), v_heads)
    return round_bf16(out).reshape(B, H, D)
