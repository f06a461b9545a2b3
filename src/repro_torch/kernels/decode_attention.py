"""GQA decode attention wrapper (kernel K3, ``csrc/decode_attention.cu``).

One query per sequence against its (S, K, hd) cache row, masked per row to
slots ``<= pos[b]``.  On a CUDA tensor the wrapper launches the kernel (or
raises); on a CPU tensor it runs ``kernels.ref.decode_attention_ref``.  Two
designs, chosen by dtype and head width alone (``decode_attention_design``):
``split`` (bf16 at hd 64 and 128, every served shape: split-KV over
``SPLIT_SLOTS``-slot splits fixed by slot index, mma.sync tiles, the last
split of a row to finish merging the row's partials) and ``simt`` (f32 and
hd 32: the first design, one block per (row, KV head)).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu

SUPPORTED_G = (1, 2, 4, 8)
SUPPORTED_HD = (32, 64, 128)
SPLIT_HD = (64, 128)
SPLIT_SLOTS = 256         # slots per split: a multiple of the kernel's 32-slot tile
# per device, the split design's int32 tickets, one per (row, KV head): zero
# between launches (each launch resets the tickets it takes), so the buffer
# is zeroed once and only grows; the port launches on one stream
_TICKETS: Dict[torch.device, torch.Tensor] = {}


def decode_attention_design(dtype: torch.dtype, G: int, hd: int) -> str:
    """The K3 design a CUDA call of this dtype, group size and head width
    launches: ``split`` for bf16 at hd 64 and 128, ``simt`` otherwise."""
    if dtype == torch.bfloat16 and hd in SPLIT_HD and G in SUPPORTED_G:
        return "split"
    return "simt"


def split_partition(S: int) -> List[Tuple[int, int]]:
    """The slot ranges ``[lo, hi)`` of a row's splits in a cache of S slots:
    slot s belongs to split ``s // SPLIT_SLOTS`` whatever S, B or pos."""
    return [(lo, min(lo + SPLIT_SLOTS, S)) for lo in range(0, S, SPLIT_SLOTS)]


def _tickets(n: int, device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _prepare(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos):
    """Validate CUDA inputs; returns ``pos`` as a contiguous (B,) int32
    vector on q's device."""
    B, H, hd = q.shape
    K = k.shape[2]
    _check_cuda(name, (q, k, v), None)
    if H // K not in SUPPORTED_G or hd not in SUPPORTED_HD:
        raise ValueError(
            f"{name}: G={H // K}, hd={hd} not built "
            f"(G in {SUPPORTED_G}, hd in {SUPPORTED_HD})"
        )
    posv = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    return posv.reshape(-1).expand(B).contiguous()


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"{name}: shapes {q.shape} {k.shape} {v.shape}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos) -> torch.Tensor:
    """q (B, H, hd), k/v (B, S, K, hd), pos int or (B,) int -> (B, H, hd)."""
    _check_shapes("decode_attention", q, k, v)
    if _is_cpu(q):
        return ref.decode_attention_ref(q, k, v, pos)
    posv = _prepare("decode_attention", q, k, v, pos)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    if decode_attention_design(q.dtype, H // K, hd) == "split":
        nsplit = -(-S // SPLIT_SLOTS)
        # partials only where a row can span two splits
        part = (None if nsplit == 1 else
                torch.empty(B * H * nsplit * (hd + 2), dtype=torch.float32, device=q.device))
        err = lib.repro_decode_attention_split(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv), build.ptr(out),
            build.ptr(part), build.ptr(_tickets(B * K, q.device)), B, H, K, S, hd,
            SPLIT_SLOTS, build.stream_of(q),
        )
        build.check(err, "decode_attention")
        build.LAUNCHES["decode_attention_split"] += 1
    else:
        err = lib.repro_decode_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv),
            build.ptr(out), B, H, K, S, hd, int(q.dtype == torch.bfloat16),
            build.stream_of(q),
        )
        build.check(err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out


def decode_attention_prev(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos) -> torch.Tensor:
    """The first design (``simt``) on any CUDA inputs: a yardstick for
    timing the ``split`` design beside it.  No served path calls it."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention_prev: CUDA tensors only")
    _check_shapes("decode_attention_prev", q, k, v)
    posv = _prepare("decode_attention_prev", q, k, v, pos)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = build.library("decode_attention").repro_decode_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv), build.ptr(out),
        B, H, K, S, hd, int(q.dtype == torch.bfloat16), build.stream_of(q),
    )
    build.check(err, "decode_attention_prev")
    build.LAUNCHES["decode_attention_prev"] += 1
    return out
