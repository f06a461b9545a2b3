"""Plain PyTorch versions of every kernel (the CPU path and the allclose
targets the CUDA kernels are held to)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _zero_rows_past(out: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero capacity rows ``c >= counts[e]`` of an (E, C, N) output, the
    rows the kernels skip and write as zeros."""
    if counts is None:
        return out
    rows = torch.arange(out.shape[1], device=out.device)
    live = rows[None, :] < counts.to(out.device)[:, None]
    return out * live[..., None].to(out.dtype)


def grouped_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> (E, C, N), f32 accumulation, out in x's
    dtype.  Rows ``c >= counts[e]`` are zero when ``counts`` is given."""
    out = torch.matmul(x.float(), w.float()).to(x.dtype)
    return _zero_rows_past(out, counts)


def expert_gate_up_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h = silu(x@wg) * (x@wu), f32 accumulation, rounded to x's dtype."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    h = (torch.nn.functional.silu(g) * u).to(x.dtype)
    return _zero_rows_past(h, counts)


def expert_ffn_ref(x: torch.Tensor, wg, wu, wd,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gated expert FFN silu(x@wg) * (x@wu) @ wd, with h rounded to x's
    dtype between the two products (where the fused TPU kernel rounds it)."""
    h = expert_gate_up_ref(x, wg, wu, counts)
    return grouped_matmul_ref(h, wd, counts)


def decode_attention_ref(
    q: torch.Tensor,       # (B, H, D)
    k: torch.Tensor,       # (B, S, K, D)
    v: torch.Tensor,       # (B, S, K, D)
    pos,                   # int or (B,) int: row b attends slots <= pos[b]
) -> torch.Tensor:
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    G = H // K
    qf = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * (D ** -0.5)
    posv = torch.as_tensor(pos, device=q.device).reshape(-1, 1)  # (B|1, 1)
    valid = torch.arange(S, device=q.device)[None, :] <= posv    # (B|1, S)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def flash_attention_ref(
    q: torch.Tensor,       # (B, S, H, D)
    k: torch.Tensor,       # (B, S, K, D), H % K == 0: head h reads KV head h // G
    v: torch.Tensor,       # (B, S, K, D)
    window: int = 0,
    lengths: Optional[torch.Tensor] = None,   # (B,) int: valid prefix per row
) -> torch.Tensor:
    """Causal GQA attention, materialised f32 softmax, scale D**-0.5.

    Query i sees key j iff ``j <= i``, ``i - window < j`` (when ``window``)
    and ``j < lengths[b]`` (when ``lengths``); output rows ``i >= lengths[b]``
    are zeros (the kernel skips them).  The twin of the JAX package's
    ``kernels/ref.py::flash_attention_ref`` extended by window and lengths.
    Queries go in chunks so the (B, K, G, chunk, S) scores stay near 256 MB;
    each query row is computed whole, so the chunking changes no value."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    dev = q.device
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=dev)
    lens = None if lengths is None else torch.as_tensor(lengths, device=dev).reshape(B)
    chunk = max(1, min(S, (1 << 26) // max(1, B * H * S)))
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        qf = q[:, lo:hi].reshape(B, hi - lo, K, G, D).float()
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * (D ** -0.5)
        qpos = torch.arange(lo, hi, device=dev)
        mask = kpos[None, :] <= qpos[:, None]                    # (q, S)
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        mask = mask[None]                                        # (1|B, q, S)
        if lens is not None:
            mask = mask & (kpos[None, None, :] < lens[:, None, None])
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        out[:, lo:hi] = o.reshape(B, hi - lo, H, D)
    if lens is not None:
        live = kpos[None, :] < lens[:, None]                     # (B, S)
        out = out * live[:, :, None, None]
    return out.to(q.dtype)
