"""Reference generation loop (model-based batching).

The execution order every offloading baseline shares: one unified batch
through the whole model, prefill then auto-regressive decode.  The
module-batching engine (``core/engine.py``) must give the same tokens.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_mod
from repro_torch.serving.kvcache import cache_from_prefill
from repro_torch.serving.sampling import greedy


def greedy_generate(
    cfg: ModelConfig,
    params,
    tokens: torch.Tensor,              # (B, S) prompt, on the params' device
    decode_len: int,
    frontend_emb: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Returns (B, decode_len) generated tokens (greedy)."""
    B, S = tokens.shape
    logits, caches = model_mod.prefill(cfg, params, tokens, frontend_emb)
    cache = cache_from_prefill(cfg, caches, max_seq=S + decode_len)
    out = [greedy(logits[:, 0])]
    for t in range(decode_len - 1):
        logits, cache = model_mod.decode_step(cfg, params, cache, out[-1], S + t)
        out.append(greedy(logits))
    return torch.stack(out, dim=1)
