"""Grouped expert GEMM wrappers (kernels K1 and K2, ``csrc/expert_gemm.cu``).

* ``expert_gate_up`` (K1) -- h = silu(x@wg) * (x@wu), the first half of the
  TPU's fused ``expert_ffn`` kernel, rounded to x's dtype.
* ``grouped_matmul`` (K2) -- (E, C, K) @ (E, K, N), the TPU's
  ``grouped_matmul`` kernel and the down projection of the expert FFN.

Each has three designs, chosen by dtype and shape alone
(``expert_gate_up_design``, ``grouped_matmul_design``): ``wgmma`` (bf16,
row widths multiples of 8: TMA-fed warp-specialised wgmma, every served
shape; K1 runs K2's kernel body with wg and wu side by side in one B tile),
``wmma`` (bf16 shapes TMA cannot address) and ``simt`` (f32, exact to f32).

Both take optional per-expert routed counts ``counts`` (E,) int32: rows
``c >= counts[e]`` are written as zeros and their weight tiles never read.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs the plain version from ``kernels.ref``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = (torch.float32, torch.bfloat16)
WGMMA_MAX_E = 1024            # experts gemm_wgmma_kernel's tile list holds


def grouped_matmul_design(dtype: torch.dtype, E: int, K: int, N: int) -> str:
    """The K2 design a CUDA call of these inputs launches: ``wgmma`` where
    TMA can address both operands (bf16, 16-byte row strides), ``wmma`` for
    other bf16 shapes, ``simt`` for f32."""
    if dtype == torch.float32:
        return "simt"
    if K % 8 == 0 and N % 8 == 0 and E <= WGMMA_MAX_E:
        return "wgmma"
    return "wmma"


def expert_gate_up_design(dtype: torch.dtype, E: int, D: int, F: int, C: int) -> str:
    """The K1 design a CUDA call of these inputs launches: ``wgmma`` where
    TMA can address x, wg and wu (bf16, D and F multiples of 8), ``wmma``
    for other bf16 shapes, ``simt`` for f32.  The capacity C is part of
    the shape; no rule depends on it."""
    return grouped_matmul_design(dtype, E, D, F)


def _check_cuda(name: str, tensors, counts: Optional[torch.Tensor]) -> None:
    dev = tensors[0].device
    dt = tensors[0].dtype
    if dt not in _DTYPES:
        raise TypeError(f"{name}: dtype {dt} not supported (float32/bfloat16)")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if counts is not None:
        if counts.device != dev or counts.dtype != torch.int32:
            raise TypeError(f"{name}: counts must be int32 on {dev}")
        if not counts.is_contiguous() or counts.shape != (tensors[0].shape[0],):
            raise ValueError(f"{name}: counts must be a contiguous (E,) vector")


def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def expert_gate_up(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D), wg/wu (E, D, F) -> h (E, C, F)."""
    E, C, D = x.shape
    F = wg.shape[-1]
    if wg.shape != (E, D, F) or wu.shape != (E, D, F):
        raise ValueError(f"expert_gate_up: shapes {x.shape} {wg.shape} {wu.shape}")
    if _is_cpu(x):
        return ref.expert_gate_up_ref(x, wg, wu, counts)
    _check_cuda("expert_gate_up", (x, wg, wu), counts)
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    lib = build.library("expert_gemm")
    if expert_gate_up_design(x.dtype, E, D, F, C) == "wgmma":
        err = lib.repro_expert_gate_up_wgmma(
            build.ptr(x), build.ptr(wg), build.ptr(wu), build.ptr(h),
            build.ptr(counts), E, C, D, F, build.stream_of(x),
        )
        build.check(err, "expert_gate_up")
        build.LAUNCHES["expert_gate_up_wgmma"] += 1
    else:
        err = lib.repro_expert_gate_up(
            build.ptr(x), build.ptr(wg), build.ptr(wu), build.ptr(h),
            build.ptr(counts), E, C, D, F, int(x.dtype == torch.bfloat16),
            build.stream_of(x),
        )
        build.check(err, "expert_gate_up")
    build.LAUNCHES["expert_gate_up"] += 1
    return h


def expert_gate_up_prev(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                        counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first design (``wmma`` in bf16) on any CUDA inputs: a yardstick
    for timing the ``wgmma`` design beside it.  No served path calls it."""
    E, C, D = x.shape
    F = wg.shape[-1]
    if x.device.type != "cuda":
        raise ValueError("expert_gate_up_prev: CUDA tensors only")
    _check_cuda("expert_gate_up_prev", (x, wg, wu), counts)
    h = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    err = build.library("expert_gemm").repro_expert_gate_up(
        build.ptr(x), build.ptr(wg), build.ptr(wu), build.ptr(h),
        build.ptr(counts), E, C, D, F, int(x.dtype == torch.bfloat16),
        build.stream_of(x),
    )
    build.check(err, "expert_gate_up_prev")
    build.LAUNCHES["expert_gate_up_prev"] += 1
    return h


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) -> (E, C, N), f32 accumulation."""
    E, C, K = x.shape
    N = w.shape[-1]
    if w.shape != (E, K, N):
        raise ValueError(f"grouped_matmul: shapes {x.shape} {w.shape}")
    if _is_cpu(x):
        return ref.grouped_matmul_ref(x, w, counts)
    _check_cuda("grouped_matmul", (x, w), counts)
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    lib = build.library("expert_gemm")
    if grouped_matmul_design(x.dtype, E, K, N) == "wgmma":
        err = lib.repro_grouped_matmul_wgmma(
            build.ptr(x), build.ptr(w), build.ptr(out), build.ptr(counts),
            E, C, K, N, build.stream_of(x),
        )
        build.check(err, "grouped_matmul")
        build.LAUNCHES["grouped_matmul_wgmma"] += 1
    else:
        err = lib.repro_grouped_matmul(
            build.ptr(x), build.ptr(w), build.ptr(out), build.ptr(counts),
            E, C, K, N, int(x.dtype == torch.bfloat16), build.stream_of(x),
        )
        build.check(err, "grouped_matmul")
    build.LAUNCHES["grouped_matmul"] += 1
    return out


def grouped_matmul_prev(x: torch.Tensor, w: torch.Tensor,
                        counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The first design (``wmma`` in bf16) on any CUDA inputs: a yardstick
    for timing the ``wgmma`` design beside it.  No served path calls it."""
    E, C, K = x.shape
    N = w.shape[-1]
    if x.device.type != "cuda":
        raise ValueError("grouped_matmul_prev: CUDA tensors only")
    _check_cuda("grouped_matmul_prev", (x, w), counts)
    out = torch.empty((E, C, N), dtype=x.dtype, device=x.device)
    err = build.library("expert_gemm").repro_grouped_matmul(
        build.ptr(x), build.ptr(w), build.ptr(out), build.ptr(counts),
        E, C, K, N, int(x.dtype == torch.bfloat16), build.stream_of(x),
    )
    build.check(err, "grouped_matmul_prev")
    build.LAUNCHES["grouped_matmul_prev"] += 1
    return out
