"""Shared neural-net primitives: norms, RoPE, initializers, losses."""
from __future__ import annotations

from typing import Optional

import torch


def dense_init(shape, generator: torch.Generator, in_dim: Optional[int] = None,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal weights scaled by ``in_dim ** -0.5`` (``shape[0]`` by
    default), drawn in f32 from ``generator``, scaled in place and cast to
    ``dtype``."""
    in_dim = in_dim if in_dim is not None else shape[0]
    scale = (1.0 / max(in_dim, 1)) ** 0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device if device is not None else generator.device)
    return w.mul_(scale).to(dtype)


def as_drawn(name: str, t: torch.Tensor) -> torch.Tensor:
    """The default ``keep`` of the ``init_*_params`` functions, which pass
    each leaf through ``keep(name, leaf)`` as soon as it is drawn (on a
    mesh: the rank's share of it): the leaf itself."""
    return t


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm computed in f32, returned in ``x``'s dtype."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE.  x: (..., S, H, D); positions: broadcastable to
    (..., S)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (D/2,)
    angles = positions[..., None].float() * freqs                # (..., S, D/2)
    angles = angles[..., None, :]                                # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL in f32.  logits: (B, S, V); labels (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - label_logit).mean()
