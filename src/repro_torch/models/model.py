"""Decoder-only model: attention, SSM (Mamba2) and hybrid layer stacks, each
layer followed by an MoE, a dense FFN or nothing.

Parameters are a dict of tensors with the layers as a per-layer list
(``params["layers"][i]``), not stacked over layer groups: PyTorch runs
eagerly, so there is no trace to keep one-group-sized.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models.blocks import (
    init_layer_cache,
    init_layer_params,
    layer_decode,
    layer_forward,
)
from repro_torch.models.layers import dense_init, rms_norm


def layer_pattern(cfg: ModelConfig) -> List[Tuple[str, str]]:
    g = cfg.attn_period if cfg.attn_period else 1
    if cfg.has_moe:
        g = math.lcm(g, cfg.moe_layer_period)
    assert cfg.num_layers % g == 0, (cfg.name, cfg.num_layers, g)
    pattern = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(g)]
    for i in range(cfg.num_layers):
        assert (cfg.layer_kind(i), cfg.ffn_kind(i)) == pattern[i % g]
    return pattern


def layer_schema(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer kind, FFN kind) of every layer."""
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Dict:
    """Seeded weights drawn on ``device`` with a ``torch.Generator``: the
    JAX package's shapes, dtypes and ``dense_init`` scales, not its bits."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    layers = [init_layer_params(cfg, kind, ffn, gen)
              for kind, ffn in layer_schema(cfg)]
    return {"layers": layers, **init_base_params(cfg, gen)}


def init_base_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """The base weights (embedding, final norm, LM head), drawn from
    ``gen`` after every layer, as ``init_params`` draws them."""
    dt = torch_dtype(cfg.dtype)
    base = {
        "embed": dense_init((cfg.vocab_size, cfg.d_model), gen, dtype=dt),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        base["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), gen, dtype=dt)
    return base


def head(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head."""
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def prefill(
    cfg: ModelConfig,
    params: Dict,
    tokens: torch.Tensor,                  # (B, S) int
    lengths: Optional[torch.Tensor] = None,
):
    """Returns (last-token logits (B, 1, V), caches).

    Cache entries are the raw per-layer ``{"k", "v"}`` of shape (B, S, K, hd)
    with rope applied (``serving.kvcache`` aligns them into decode buffers),
    or an SSM layer's ``{"h", "conv"}`` state at each row's length.
    ``lengths`` (B,) makes a ragged right-padded batch exact.  The MoE runs
    the dense-combine reference."""
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device)[None, :]
    caches = []
    for (kind, ffn), p in zip(layer_schema(cfg), params["layers"]):
        x, cache, _ = layer_forward(cfg, kind, ffn, p, x, positions, lengths)
        caches.append(cache)
    if lengths is not None:
        last = x[torch.arange(B, device=x.device), lengths.long() - 1][:, None]
    else:
        last = x[:, -1:]
    return head(cfg, params, last), caches


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> List:
    """Zeroed decode caches of every layer (KV buffers or SSM states) on
    ``device`` (``cuda`` by default, like ``init_params``; raises without
    CUDA)."""
    dev = resolve_device(device)
    return [init_layer_cache(cfg, kind, batch, max_seq, dev)
            for kind, _ in layer_schema(cfg)]


def decode_step(
    cfg: ModelConfig,
    params: Dict,
    cache: List,
    tokens: torch.Tensor,              # (B,) int
    pos,                               # int or (B,) int current position
):
    """One token for every sequence.  Returns (logits (B, V), cache); the
    cache tensors are written in place."""
    x = params["embed"][tokens][:, None]
    for (kind, ffn), p, c in zip(layer_schema(cfg), params["layers"], cache):
        x, _ = layer_decode(cfg, kind, ffn, p, x, c, pos)
    return head(cfg, params, x)[:, 0], cache
