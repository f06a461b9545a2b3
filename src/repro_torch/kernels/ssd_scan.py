"""Mamba2 SSD chunked-scan wrapper (kernel K5, ``csrc/ssd_scan.cu``).

The sequence mixer of every SSM layer's prefill: x (B, S, nh, hp), B/C
(B, S, ns) shared by every head, dt (B, S, nh) f32 and A (nh,) f32 give
y (B, S, nh, hp) in x's dtype and the final f32 state (B, nh, ns, hp).
The chunk is fixed; a last chunk shorter than it, and positions at or past
``lengths[b]``, are padding (dt = 0, y rows zero).  On a CUDA tensor the
wrapper launches the kernel (or raises); on a CPU tensor it runs
``kernels.ref.ssd_scan_ref``.  Two designs, chosen by dtype and shape alone
(``ssd_scan_design``): ``mma`` (bf16 at every supported shape: the chunk's
bf16 tiles staged once by cp.async, all four products on the tensor cores
as mma.sync, their f32 operands M, H and w x as two bf16 terms each;
mirrored on the CPU by ``kernels.ref.ssd_scan_mma_ref``) and ``simt`` (f32:
the first design, every product SIMT f32).  A row's y and state do not depend on the
other rows of the batch in either design.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.expert_gemm import _check_cuda, _is_cpu, refuse_autograd

SUPPORTED_HP = (32, 64)
SUPPORTED_NS = (16, 64, 128)
SUPPORTED_CHUNK = (32, 64, 128, 256)


def ssd_scan_design(dtype: torch.dtype, hp: int, ns: int, chunk: int) -> str:
    """The K5 design a CUDA call of this dtype and shape launches: ``mma``
    for bf16 at every supported shape, ``simt`` for f32."""
    if (dtype == torch.bfloat16 and hp in SUPPORTED_HP and ns in SUPPORTED_NS
            and chunk in SUPPORTED_CHUNK):
        return "mma"
    return "simt"


def _check_shapes(name: str, x, B, C, dt, A, chunk: int) -> None:
    Bt, S, nh, hp = x.shape
    ns = B.shape[-1]
    if (B.shape != (Bt, S, ns) or C.shape != B.shape or dt.shape != (Bt, S, nh)
            or A.shape != (nh,)):
        raise ValueError(f"{name}: shapes {x.shape} {B.shape} {C.shape} "
                         f"{dt.shape} {A.shape}")
    if chunk <= 0:
        raise ValueError(f"{name}: chunk {chunk} <= 0")


def _prepare(name: str, x, B, C, dt, A, chunk: int, lengths):
    """Validate CUDA inputs; returns ``lengths`` as a contiguous (B,) int32
    vector on x's device (or None)."""
    Bt, hp, ns = x.shape[0], x.shape[-1], B.shape[-1]
    _check_cuda(name, (x, B, C), None)
    for what, t in (("dt", dt), ("A", A)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name}: {what} must be contiguous float32 on {x.device}")
    if hp not in SUPPORTED_HP or ns not in SUPPORTED_NS or chunk not in SUPPORTED_CHUNK:
        raise ValueError(
            f"{name}: hp={hp}, ns={ns}, chunk={chunk} not built (hp in "
            f"{SUPPORTED_HP}, ns in {SUPPORTED_NS}, chunk in {SUPPORTED_CHUNK})")
    if lengths is None:
        return None
    lens = torch.as_tensor(lengths, device=x.device).to(torch.int32)
    return lens.reshape(-1).expand(Bt).contiguous()


def _launch(name: str, x, B, C, dt, A, chunk: int, lens, mma: bool):
    """Launch the mma design (``mma``) or the first one on validated inputs."""
    Bt, S, nh, hp = x.shape
    ns = B.shape[-1]
    y = torch.empty_like(x)
    state = torch.empty((Bt, nh, ns, hp), dtype=torch.float32, device=x.device)
    lib = build.library("ssd_scan")
    args = (build.ptr(x), build.ptr(B), build.ptr(C), build.ptr(dt), build.ptr(A),
            build.ptr(lens), build.ptr(y), build.ptr(state), Bt, S, nh, hp, ns, int(chunk))
    if mma:
        err = lib.repro_ssd_scan_mma(*args, build.stream_of(x))
    else:
        err = lib.repro_ssd_scan(*args, int(x.dtype == torch.bfloat16), build.stream_of(x))
    build.check(err, name)
    return y, state


def ssd_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             dt: torch.Tensor, A: torch.Tensor, chunk: int, *,
             lengths: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, nh, hp), B/C (B, S, ns), dt (B, S, nh) f32, A (nh,) f32 ->
    (y (B, S, nh, hp) in x's dtype, state (B, nh, ns, hp) f32).

    Positions at or past ``lengths[b]`` count as padding: their inputs are
    never read, their y rows come back as zeros, and the state is the state
    at ``lengths[b]``."""
    _check_shapes("ssd_scan", x, B, C, dt, A, chunk)
    refuse_autograd("ssd_scan", x, B, C, dt, A)
    if _is_cpu(x):
        return ref.ssd_scan_ref(x, B, C, dt, A, chunk, lengths=lengths)
    lens = _prepare("ssd_scan", x, B, C, dt, A, chunk, lengths)
    mma = ssd_scan_design(x.dtype, x.shape[-1], B.shape[-1], chunk) == "mma"
    out = _launch("ssd_scan", x, B, C, dt, A, chunk, lens, mma)
    if mma:
        build.LAUNCHES["ssd_scan_mma"] += 1
    build.LAUNCHES["ssd_scan"] += 1
    return out


def ssd_scan_prev(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  dt: torch.Tensor, A: torch.Tensor, chunk: int, *,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first design (``simt``) on any CUDA inputs: a yardstick for
    timing the ``mma`` design beside it.  No served path calls it."""
    if x.device.type != "cuda":
        raise ValueError("ssd_scan_prev: CUDA tensors only")
    _check_shapes("ssd_scan_prev", x, B, C, dt, A, chunk)
    refuse_autograd("ssd_scan_prev", x, B, C, dt, A)
    lens = _prepare("ssd_scan_prev", x, B, C, dt, A, chunk, lengths)
    out = _launch("ssd_scan_prev", x, B, C, dt, A, chunk, lens, mma=False)
    build.LAUNCHES["ssd_scan_prev"] += 1
    return out
