"""Modality frontend stubs.

``[audio]`` and ``[vlm]`` architectures specify only the transformer
backbone; the EnCodec conv stack and the ViT vision encoder are not
implemented.  ``frontend_embeddings`` returns stand-in frame or patch
embeddings of the right shape (deterministic pseudo-features, so runs are
reproducible), which ``models.model.forward``/``prefill`` and the engine's
``prefill``/``generate`` put in place of the first ``frontend_tokens``
positions' token embeddings; ``frontend_spec`` describes them on the
``meta`` device.

The default seed is ``zlib.crc32`` of the frontend's name: stable across
processes, where Python's ``hash`` of a string is not.
"""
from __future__ import annotations

import zlib
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype


def frontend_embeddings(cfg: ModelConfig, batch: int,
                        generator: Optional[torch.Generator] = None,
                        device="cuda") -> Optional[torch.Tensor]:
    """(batch, frontend_tokens, d_model) normal features x 0.02 in the
    config's dtype, drawn in f32 from ``generator`` (default: one seeded
    with ``zlib.crc32(cfg.frontend)``) on ``device``; None without a
    frontend."""
    if not cfg.frontend:
        return None
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(zlib.crc32(cfg.frontend.encode()))
    emb = torch.randn((batch, cfg.frontend_tokens, cfg.d_model), generator=generator,
                      dtype=torch.float32, device=dev)
    return (emb * 0.02).to(torch_dtype(cfg.dtype))


def frontend_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    """A ``meta`` tensor of ``frontend_embeddings``' shape and dtype, or None."""
    if not cfg.frontend:
        return None
    return torch.empty((batch, cfg.frontend_tokens, cfg.d_model),
                       dtype=torch_dtype(cfg.dtype), device="meta")
