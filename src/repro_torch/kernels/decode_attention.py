"""GQA decode attention wrapper (kernel K3, ``csrc/decode_attention.cu``).

One query per sequence against its (S, K, hd) cache row, masked per row to
slots ``<= pos[b]``.  On a CUDA tensor the wrapper launches the kernel (or
raises); on a CPU tensor it runs ``kernels.ref.decode_attention_ref``.  With an
``lse`` buffer it also writes each row's log-sum-exp (the model-sharding
path's decode over a cache split by span merges ranks' partials with it).
Two designs, chosen by dtype and head width alone (``decode_attention_design``):
``split`` (bf16 at hd 64 and 128, every served shape: split-KV over
``SPLIT_SLOTS``-slot splits fixed by slot index, mma.sync tiles, the last
split of a row to finish merging the row's partials) and ``simt`` (f32 and
hd 32: the first design, one block per (row, KV head)).

``decode_attention_paged`` is K3p, the same kernel reading K and V through
a page table (``serving.cache.KVPageTable``): from the device pool or from
the window's copy of the layer's host frames, with no gathered copy.  It
takes the same design as K3 at the same dtype and head width, and its
output is bit-identical to K3's on the gathered contiguous copy.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu, refuse_autograd

SUPPORTED_G = (1, 2, 4, 8)
SUPPORTED_HD = (32, 64, 128)
SPLIT_HD = (64, 128)
SPLIT_SLOTS = 256         # slots per split: a multiple of the kernel's 32-slot tile
# per device, the split design's int32 tickets, one per (row, KV head): zero
# between launches (each launch resets the tickets it takes), so the buffer
# is zeroed once and only grows.  K3 launches never overlap: eager launches
# and CUDA graph replays are ordered on the engine's current stream (a graph
# capture and its warm-up run on a side stream that first waits for it)
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


def reserve_tickets(n: int, device: torch.device) -> torch.Tensor:
    """The device's ticket buffer, grown (zeroed) to at least ``n`` tickets.
    A caller that captures K3 into a CUDA graph reserves B x K tickets
    before the capture, so that the buffer never comes from (and outlives)
    the graph's private memory pool; growing it inside a capture raises."""
    device = torch.device(device)
    if device.index is None:                   # "cuda" and "cuda:0": one buffer
        device = torch.device(device.type, torch.cuda.current_device())
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode_attention: {n} tickets needed inside a CUDA "
                               f"graph capture; reserve_tickets before capturing")
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


def _check_lse(q: torch.Tensor, lse: Optional[torch.Tensor]) -> None:
    if lse is not None and (lse.shape != q.shape[:2] or lse.dtype != torch.float32
                            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"decode_attention: lse must be a contiguous f32 {tuple(q.shape[:2])} "
                         f"tensor on {q.device}, got {lse.dtype} {tuple(lse.shape)} "
                         f"on {lse.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, hd), k/v (B, S, K, hd), pos int or (B,) int -> (B, H, hd).
    ``lse`` (B, H) f32, when given, is written with each row's log-sum-exp
    of its scaled scores over its valid slots (-inf for a row with none),
    which is what merging attention over slot ranges takes
    (``collectives.merge_lse``); the output is the same bits either way."""
    _check_shapes("decode_attention", q, k, v)
    _check_lse(q, lse)
    refuse_autograd("decode_attention", q, k, v)
    if _is_cpu(q):
        return ref.decode_attention_ref(q, k, v, pos, lse)
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
            build.ptr(lse), build.ptr(part), build.ptr(reserve_tickets(B * K, q.device)),
            B, H, K, S, hd, SPLIT_SLOTS, build.stream_of(q),
        )
        build.check(err, "decode_attention")
        build.LAUNCHES["decode_attention_split"] += 1
    else:
        err = lib.repro_decode_attention(
            build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv),
            build.ptr(out), build.ptr(lse), B, H, K, S, hd, int(q.dtype == torch.bfloat16),
            build.stream_of(q),
        )
        build.check(err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    if lse is not None:
        build.LAUNCHES["decode_attention_lse"] += 1
    return out


def decode_attention_prev(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos) -> torch.Tensor:
    """The first design (``simt``) on any CUDA inputs: a yardstick for
    timing the ``split`` design beside it.  No served path calls it."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention_prev: CUDA tensors only")
    _check_shapes("decode_attention_prev", q, k, v)
    refuse_autograd("decode_attention_prev", q, k, v)
    posv = _prepare("decode_attention_prev", q, k, v, pos)
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = build.library("decode_attention").repro_decode_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv), build.ptr(out), None,
        B, H, K, S, hd, int(q.dtype == torch.bfloat16), build.stream_of(q),
    )
    build.check(err, "decode_attention_prev")
    build.LAUNCHES["decode_attention_prev"] += 1
    return out


def _check_paged(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                 ek: Optional[torch.Tensor], ev: Optional[torch.Tensor],
                 frames: torch.Tensor, span: int) -> None:
    n, H, hd = q.shape
    pt, K = pk.shape[1], pk.shape[2]
    ok = (pk.dim() == 4 and pk.shape[3] == hd and pv.shape == pk.shape and H % K == 0
          and frames.dim() == 2 and frames.shape[0] == n
          and 0 < span <= frames.shape[1] * pt and (ek is None) == (ev is None)
          and (ek is None or (ek.shape[1:] == pk.shape[1:] and ev.shape == ek.shape)))
    if not ok:
        raise ValueError(f"decode_attention_paged: shapes q {tuple(q.shape)} pool "
                         f"{tuple(pk.shape)} {tuple(pv.shape)} window "
                         f"{None if ek is None else tuple(ek.shape)} frames "
                         f"{tuple(frames.shape)} span {span}")


def decode_attention_paged(q: torch.Tensor, pk: torch.Tensor, pv: torch.Tensor,
                           ek: Optional[torch.Tensor], ev: Optional[torch.Tensor],
                           frames: torch.Tensor, pos, span: int) -> torch.Tensor:
    """K3p: q (n, H, hd); the device pool pk/pv (P + 1, pt, K, hd); the
    window's frames ek/ev (Hf, pt, K, hd) or None; ``frames`` (n, pages)
    int32, an index below P + 1 naming a pool frame and P + 1 + h frame h of
    the window; pos int or (n,) int; ``span`` the slots of a row.  Row b's
    slot s is at offset s % pt of frame ``frames[b, s // pt]``.  Returns
    (n, H, hd)."""
    _check_paged(q, pk, pv, ek, ev, frames, span)
    refuse_autograd("decode_attention_paged", q, pk, pv, ek, ev)
    if _is_cpu(q):
        return ref.decode_attention_paged_ref(q, pk, pv, ek, ev, frames, pos, span)
    posv = _prepare("decode_attention_paged", q, pk, pv, pos)
    if ek is not None:
        _check_cuda("decode_attention_paged", (q, ek, ev), None)
    if frames.device != q.device:
        raise ValueError(f"decode_attention_paged: frames on {frames.device}, q on {q.device}")
    n, H, hd = q.shape
    pt, K = pk.shape[1], pk.shape[2]
    frames = frames.to(torch.int32).contiguous()
    pages = frames.shape[1]
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    if decode_attention_design(q.dtype, H // K, hd) == "split":
        nsplit = -(-span // SPLIT_SLOTS)
        part = (None if nsplit == 1 else
                torch.empty(n * H * nsplit * (hd + 2), dtype=torch.float32, device=q.device))
        err = lib.repro_decode_attention_paged_split(
            build.ptr(q), build.ptr(pk), build.ptr(pv), build.ptr(ek), build.ptr(ev),
            build.ptr(frames), build.ptr(posv), build.ptr(out), build.ptr(part),
            build.ptr(reserve_tickets(n * K, q.device)), n, H, K, span, hd, pt, pages,
            pk.shape[0], SPLIT_SLOTS, build.stream_of(q),
        )
        build.check(err, "decode_attention_paged")
        build.LAUNCHES["decode_attention_paged_split"] += 1
    else:
        err = lib.repro_decode_attention_paged(
            build.ptr(q), build.ptr(pk), build.ptr(pv), build.ptr(ek), build.ptr(ev),
            build.ptr(frames), build.ptr(posv), build.ptr(out), n, H, K, span, hd, pt, pages,
            pk.shape[0], int(q.dtype == torch.bfloat16), build.stream_of(q),
        )
        build.check(err, "decode_attention_paged")
    build.LAUNCHES["decode_attention_paged"] += 1
    return out
