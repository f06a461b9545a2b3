"""KV-cache conversion and slot management for contiguous decode buffers.

Prefill returns raw per-layer K/V (or an SSM layer's ``{"h", "conv"}``
state); decode runs on preallocated (possibly ring-buffer) caches that the
engine owns and writes IN PLACE -- their ``data_ptr()`` never changes across
decode ticks, insertions and evictions.  Sliding-window ring alignment:
absolute position p lives in slot ``p % span``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import kv_span


def aligned_kv(
    cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor, span: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw prefill K/V ``(n, S, K, hd)`` -> decode-ready ``(n, span, K, hd)``.

    Pads/truncates to ``span`` slots; with a sliding window longer prompts
    are ring-aligned (absolute position p -> slot ``p % span``)."""
    n_rows, S, K, hd = k.shape
    n = min(S, span)
    nk = torch.zeros((n_rows, span, K, hd), dtype=k.dtype, device=k.device)
    nv = torch.zeros_like(nk)
    if cfg.sliding_window and S > span:
        slots = torch.arange(S - n, S, device=k.device) % span
        nk[:, slots] = k[:, -n:]
        nv[:, slots] = v[:, -n:]
    else:
        nk[:, :n] = k[:, -n:]
        nv[:, :n] = v[:, -n:]
    return nk, nv


def cache_from_prefill(cfg: ModelConfig, caches: List[Dict], max_seq: int) -> List[Dict]:
    """Convert raw prefill caches into decode-ready buffers of span
    ``kv_span(cfg, max_seq)``; SSM states pass through."""
    span = kv_span(cfg, max_seq)
    out = []
    for c in caches:
        if "h" in c:
            out.append(c)
            continue
        nk, nv = aligned_kv(cfg, c["k"], c["v"], span)
        out.append({"k": nk, "v": nv})
    return out


def _rows(rows, device) -> torch.Tensor:
    if torch.is_tensor(rows):
        return torch.as_tensor(rows, device=device).reshape(-1).long()
    return torch.as_tensor(np.asarray(rows, np.int64).reshape(-1), device=device)  # lint: allow[MG105] a host row index, asynchronous


def insert_prefill_rows(
    cfg: ModelConfig, layer_cache: Dict[str, torch.Tensor],
    entry: Dict[str, torch.Tensor], rows: Sequence[int],
) -> Dict[str, torch.Tensor]:
    """Write ONE layer's raw prefill ``entry`` into batch rows ``rows`` of
    its decode buffer, in place.  Each newcomer's FULL row is overwritten
    (KV beyond its prompt is zeroed; an SSM layer's ``h`` and ``conv`` rows
    are replaced), so nothing of an evicted sequence survives slot
    recycling."""
    if "h" in layer_cache:
        idx = _rows(rows, layer_cache["h"].device)
        for key in ("h", "conv"):
            layer_cache[key].index_copy_(0, idx, entry[key])
        return layer_cache
    span = layer_cache["k"].shape[1]
    nk, nv = aligned_kv(cfg, entry["k"], entry["v"], span)
    idx = _rows(rows, layer_cache["k"].device)
    layer_cache["k"].index_copy_(0, idx, nk)
    layer_cache["v"].index_copy_(0, idx, nv)
    return layer_cache


def evict_rows(cache: List[Dict[str, torch.Tensor]], rows: Sequence[int]) -> List:
    """Zero batch rows across every layer buffer, in place (slot recycling).

    Not needed for correctness -- decode masks by per-sequence position and
    insertion overwrites whole rows -- but keeps freed slots inert."""
    if len(rows) == 0:
        return cache
    for layer in cache:
        if not layer:                      # a layer whose KV lives in pages
            continue
        idx = _rows(rows, next(iter(layer.values())).device)
        for buf in layer.values():
            buf.index_fill_(0, idx, 0)
    return cache

