"""Reference generation loop (model-based batching).

The execution order every offloading baseline shares: one unified batch
through the whole model, prefill then auto-regressive decode.  The
module-batching engine (``core/engine.py``) must give the same tokens.
With a mesh ``ctx`` it is the sharded serving path: model-based batching
over a data x model mesh of rank processes (``models.model``'s sharded
``prefill`` and ``decode_step``), each rank serving its batch rows.
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
    ctx=None,
) -> torch.Tensor:
    """Returns (B, decode_len) generated tokens (greedy).  On a mesh
    (``ctx``): ``params`` are this rank's shares and ``tokens`` its rows
    (``model.rows_of``), and each rank keeps its share of the decode cache;
    every rank of a model axis gets the same tokens."""
    B, S = tokens.shape
    logits, caches = model_mod.prefill(cfg, params, tokens, frontend_emb, ctx=ctx)
    cache = cache_from_prefill(cfg, caches, max_seq=S + decode_len, ctx=ctx)
    out = [greedy(logits[:, 0])]
    for t in range(decode_len - 1):
        logits, cache = model_mod.decode_step(cfg, params, cache, out[-1], S + t, ctx=ctx)
        out.append(greedy(logits))
    return torch.stack(out, dim=1)
