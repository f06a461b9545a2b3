"""Mamba2 SSD chunked-scan wrapper (kernel K5, ``csrc/ssd_scan.cu``).

The sequence mixer of every SSM layer's prefill: x (B, S, nh, hp), B/C
(B, S, ns) shared by every head, dt (B, S, nh) f32 and A (nh,) f32 give
y (B, S, nh, hp) in x's dtype and the final f32 state (B, nh, ns, hp).
The chunk is fixed; a last chunk shorter than it, and positions at or past
``lengths[b]``, are padding (dt = 0, y rows zero).  On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs
``kernels.ref.ssd_scan_ref``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu

SUPPORTED_HP = (32, 64)
SUPPORTED_NS = (16, 64, 128)
SUPPORTED_CHUNK = (32, 64, 128, 256)


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int, *,
             lengths: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hp), B/C (B, S, ns), dt (B, S, nh) f32, A (nh,) f32 ->
    (y (B, S, nh, hp) in x's dtype, state (B, nh, ns, hp) f32).

    Positions at or past ``lengths[b]`` count as padding: their inputs are
    never read, their y rows come back as zeros, and the state is the state
    at ``lengths[b]``."""
    Bt, S, nh, hp = x.shape
    ns = B.shape[-1]
    if (B.shape != (Bt, S, ns) or C.shape != B.shape or dt.shape != (Bt, S, nh)
            or A.shape != (nh,)):
        raise ValueError(f"ssd_scan: shapes {x.shape} {B.shape} {C.shape} "
                         f"{dt.shape} {A.shape}")
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk {chunk} <= 0")
    if _is_cpu(x):
        return ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lengths)
    _check_cuda("ssd_scan", (x, B, C), None)
    for name, t in (("dt", dt), ("A", A)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"ssd_scan: {name} must be contiguous float32 on {x.device}")
    if hp not in SUPPORTED_HP or ns not in SUPPORTED_NS or chunk not in SUPPORTED_CHUNK:
        raise ValueError(
            f"ssd_scan: hp={hp}, ns={ns}, chunk={chunk} not built (hp in "
            f"{SUPPORTED_HP}, ns in {SUPPORTED_NS}, chunk in {SUPPORTED_CHUNK})")
    lens = None
    if lengths is not None:
        lens = torch.as_tensor(lengths, device=x.device).to(torch.int32)
        lens = lens.reshape(-1).expand(Bt).contiguous()
    y = torch.empty_like(x)
    state = torch.empty((Bt, nh, ns, hp), dtype=torch.float32, device=x.device)
    lib = build.library("ssd_scan")
    err = lib.repro_ssd_scan(
        build.ptr(x), build.ptr(B), build.ptr(C), build.ptr(dt), build.ptr(A),
        build.ptr(lens), build.ptr(y), build.ptr(state),
        Bt, S, nh, hp, ns, int(chunk), int(x.dtype == torch.bfloat16),
        build.stream_of(x),
    )
    build.check(err, "ssd_scan")
    build.LAUNCHES["ssd_scan"] += 1
    return y, state
