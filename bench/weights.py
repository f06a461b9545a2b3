"""The benchmark's weights, drawn on the device from the seed.

Every leaf has a generator of its own, seeded from (seed, layer, leaf), so
any layer can be drawn again alone and in any order: the program gets each
layer as it is drawn, and the reference draws each again when it reaches
it.  Leaves are drawn in the type they are served in (bfloat16; the router
in float32, as the program keeps it), one ``randn`` call each, scaled by
``fan_in ** -0.5``; norm scales are ``1 + 0.1 * randn``.

The layout is the one the program's ``ParamStore`` takes: a dict with a
list of per-layer dicts under ``"layers"`` and the base weights beside it.
Imports neither the program nor JAX.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterator, Optional

import torch

from bench.spec import Sizes

BF16 = torch.bfloat16
_BASE_LAYER = 1 << 20          # the base weights' layer number in the seeds
_M = (1 << 63) - 1


def leaf_seed(seed: int, layer: int, leaf: int) -> int:
    """A generator seed for one leaf, mixed from (seed, layer, leaf)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + layer * 0xBF58476D1CE4E5B9
         + leaf * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & _M
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & _M
    return x ^ (x >> 29)


def _drawn(shape, seed: int, layer: int, leaf: int, device, dtype=BF16,
         scale: Optional[float] = None, offset: float = 0.0, served=None) -> torch.Tensor:
    """One leaf, drawn in ``dtype`` and handed over in ``served`` (default:
    ``dtype``): a float32 model serves the bfloat16 draws' values."""
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, layer, leaf))
    t = torch.randn(shape, generator=g, device=device, dtype=dtype)
    if scale is not None:
        t.mul_(scale)
    if offset:
        t.add_(offset)
    return t if served is None or served == dtype else t.to(served)


def layer(sz: Sizes, seed: int, li: int, device, served=BF16) -> Dict:
    """Layer ``li``'s weights: pre-norms, attention projections (x @ W), the
    router and the expert stacks (E, D, F) / (E, F, D), in ``served``
    (the router always in float32)."""
    D, H, K, hd = sz.d_model, sz.n_heads, sz.n_kv_heads, sz.head_dim
    E, F = sz.n_experts, sz.expert_ff

    draw = functools.partial(_drawn, served=served)
    return {
        "norm1": draw((D,), seed, li, 0, device, scale=0.1, offset=1.0),
        "attn": {
            "wq": draw((D, H * hd), seed, li, 1, device, scale=D ** -0.5),
            "wk": draw((D, K * hd), seed, li, 2, device, scale=D ** -0.5),
            "wv": draw((D, K * hd), seed, li, 3, device, scale=D ** -0.5),
            "wo": draw((H * hd, D), seed, li, 4, device, scale=(H * hd) ** -0.5),
        },
        "norm2": draw((D,), seed, li, 5, device, scale=0.1, offset=1.0),
        "moe": {
            "router": draw((D, E), seed, li, 6, device, dtype=torch.float32,
                           scale=D ** -0.5, served=torch.float32),
            "experts_w_gate": draw((E, D, F), seed, li, 7, device, scale=D ** -0.5),
            "experts_w_up": draw((E, D, F), seed, li, 8, device, scale=D ** -0.5),
            "experts_w_down": draw((E, F, D), seed, li, 9, device, scale=F ** -0.5),
        },
    }


def base(sz: Sizes, seed: int, device, served=BF16) -> Dict:
    D, V = sz.d_model, sz.vocab
    draw = functools.partial(_drawn, served=served)
    return {
        "embed": draw((V, D), seed, _BASE_LAYER, 0, device),
        "final_norm": draw((D,), seed, _BASE_LAYER, 1, device, scale=0.1, offset=1.0),
        "lm_head": draw((D, V), seed, _BASE_LAYER, 2, device, scale=D ** -0.5),
    }


class Layers:
    """The layers as a sequence the program's ``ParamStore`` iterates: each
    layer is drawn when it is reached, so a model larger than the card is
    never whole on it (the store moves what it streams to host memory)."""

    def __init__(self, sz: Sizes, seed: int, device, served=BF16) -> None:
        self.sz, self.seed, self.device, self.served = sz, seed, device, served

    def __len__(self) -> int:
        return self.sz.n_layers

    def __iter__(self) -> Iterator[Dict]:
        for li in range(self.sz.n_layers):
            yield layer(self.sz, self.seed, li, self.device, self.served)


def params(sz: Sizes, seed: int, device, served=BF16) -> Dict:
    """The model as the program takes it, its layers drawn lazily."""
    return {"layers": Layers(sz, seed, device, served), **base(sz, seed, device, served)}
