"""Causal GQA flash-attention wrapper (kernel K4, ``csrc/flash_attention.cu``).

The prefill attention of every layer: q (B, S, H, hd) against k/v
(B, S, K, hd), query head h reading KV head h // (H // K), with an optional
sliding window and per-row ``lengths`` of a right-padded batch.  With
``q_offset`` the queries are the last Sq of Sk = q_offset + Sq positions (a
prefix-cache hit's suffix prefill against the stored prefix and its own
keys).  On a CUDA
tensor the wrapper launches the kernel (or raises); on a CPU tensor it runs
``kernels.ref.flash_attention_ref``.  Three designs, chosen by dtype and
head width alone (``flash_attention_design``): ``wgmma`` (bf16 at hd 64 and
128: TMA-fed warp-specialised wgmma, every full-size config), ``mma``
(bf16 at hd 32, the smoke configs: the first, mma.sync kernel) and ``simt``
(f32).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu, refuse_autograd

SUPPORTED_G = (1, 2, 4, 8)
SUPPORTED_HD = (32, 64, 128)        # 32: the smoke configs
WGMMA_HD = (64, 128)


def flash_attention_design(dtype: torch.dtype, hd: int) -> str:
    """The K4 design a CUDA call of this dtype and head width launches."""
    if dtype == torch.float32:
        return "simt"
    return "wgmma" if hd in WGMMA_HD else "mma"


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, q_offset: int) -> None:
    B, S, H, hd = q.shape
    K = k.shape[2]
    if k.shape != (B, q_offset + S, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape} at q_offset "
                         f"{q_offset}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"{name}: window {window} or q_offset {q_offset} < 0")
    if window and q_offset:
        # the prefix cache, the one caller of an offset, refuses windowed models
        raise ValueError(f"{name}: a sliding window with a query offset is not supported")


def _check_flash(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths) -> Optional[torch.Tensor]:
    """Validate CUDA inputs; returns ``lengths`` as a contiguous (B,) int32
    vector on q's device (or None)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    _check_cuda(name, (q, k, v), None)
    if H // K not in SUPPORTED_G or hd not in SUPPORTED_HD:
        raise ValueError(
            f"{name}: G={H // K}, hd={hd} not built "
            f"(G in {SUPPORTED_G}, hd in {SUPPORTED_HD})"
        )
    if lengths is None:
        return None
    lens = torch.as_tensor(lengths, device=q.device).to(torch.int32)
    return lens.reshape(-1).expand(B).contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, lengths: Optional[torch.Tensor] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, hd), k/v (B, q_offset + Sq, K, hd) -> (B, Sq, H, hd) in
    q's dtype.

    Query row r is absolute position ``i = q_offset + r``; it sees key j iff
    ``j <= i``, ``i - window < j`` (when ``window`` > 0) and ``j <
    lengths[b]`` (when ``lengths``); rows with ``i >= lengths[b]`` come back
    as zeros.  ``window`` and ``q_offset`` together raise."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    _check_shapes("flash_attention", q, k, v, window, q_offset)
    refuse_autograd("flash_attention", q, k, v)
    if _is_cpu(q):
        return ref.flash_attention_ref(q, k, v, window=window, lengths=lengths,
                                       q_offset=q_offset)
    lens = _check_flash("flash_attention", q, k, v, lengths)
    out = torch.empty_like(q)
    lib = build.library("flash_attention")
    if flash_attention_design(q.dtype, hd) == "wgmma":
        err = lib.repro_flash_attention_wgmma(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens), build.ptr(out),
            B, S, H, K, hd, int(window), int(q_offset), build.stream_of(q),
        )
        build.check(err, "flash_attention")
        build.LAUNCHES["flash_attention_wgmma"] += 1
    else:
        err = lib.repro_flash_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens), build.ptr(out),
            B, S, H, K, hd, int(window), int(q_offset), int(q.dtype == torch.bfloat16),
            build.stream_of(q),
        )
        build.check(err, "flash_attention")
    build.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_prev(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int = 0,
                         lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first design (``mma`` in bf16) on any CUDA inputs: a yardstick
    for timing the ``wgmma`` design beside it.  No served path calls it,
    and it takes no query offset."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    if q.device.type != "cuda":
        raise ValueError("flash_attention_prev: CUDA tensors only")
    _check_shapes("flash_attention_prev", q, k, v, window, 0)
    refuse_autograd("flash_attention_prev", q, k, v)
    lens = _check_flash("flash_attention_prev", q, k, v, lengths)
    out = torch.empty_like(q)
    err = build.library("flash_attention").repro_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens), build.ptr(out),
        B, S, H, K, hd, int(window), 0, int(q.dtype == torch.bfloat16), build.stream_of(q),
    )
    build.check(err, "flash_attention_prev")
    build.LAUNCHES["flash_attention_prev"] += 1
    return out
