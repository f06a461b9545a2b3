"""GQA decode attention wrapper (kernel K3, ``csrc/decode_attention.cu``).

One query per sequence against its (S, K, hd) cache row, masked per row to
slots ``<= pos[b]``.  On a CUDA tensor the wrapper launches the kernel (or
raises); on a CPU tensor it runs ``kernels.ref.decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu

SUPPORTED_G = (1, 2, 4, 8)
SUPPORTED_HD = (32, 64, 128)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos) -> torch.Tensor:
    """q (B, H, hd), k/v (B, S, K, hd), pos int or (B,) int -> (B, H, hd)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if k.shape != (B, S, K, hd) or v.shape != k.shape or H % K:
        raise ValueError(f"decode_attention: shapes {q.shape} {k.shape} {v.shape}")
    if _is_cpu(q):
        return ref.decode_attention_ref(q, k, v, pos)
    _check_cuda("decode_attention", (q, k, v), None)
    if H // K not in SUPPORTED_G or hd not in SUPPORTED_HD:
        raise ValueError(
            f"decode_attention: G={H // K}, hd={hd} not built "
            f"(G in {SUPPORTED_G}, hd in {SUPPORTED_HD})"
        )
    posv = torch.as_tensor(pos, dtype=torch.int32, device=q.device)
    posv = posv.reshape(-1).expand(B).contiguous()
    out = torch.empty_like(q)
    lib = build.library("decode_attention")
    err = lib.repro_decode_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(posv),
        build.ptr(out), B, H, K, S, hd, int(q.dtype == torch.bfloat16),
        build.stream_of(q),
    )
    build.check(err, "decode_attention")
    build.LAUNCHES["decode_attention"] += 1
    return out
