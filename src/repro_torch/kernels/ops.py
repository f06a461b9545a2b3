"""Public kernel ops: what the model code calls.

Every op takes its path from the device of its inputs alone: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor runs the plain
version from ``kernels.ref``.  Nothing here catches a kernel failure and
falls back.  No kernel has a backward: every op raises a ``RuntimeError``
naming itself when grad mode is on and an input requires grad
(``refuse_autograd``), on CUDA and CPU tensors alike.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import launch_counts, reset_launch_counts  # noqa: F401
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention,
    decode_attention_paged,
)
from repro_torch.kernels.expert_gemm import (  # noqa: F401
    expert_gate_up,
    grouped_matmul,
    refuse_autograd,
)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401


def grouped_expert_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                       wd: torch.Tensor,
                       counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped gated expert FFN over an (E, C, D) capacity buffer:
    ``silu(x@wg) * (x@wu) @ wd`` with h rounded to x's dtype in between
    (K1 then K2 on the card).  ``counts`` (E,) int32 marks each expert's
    routed rows; rows past it come back as zeros."""
    refuse_autograd("grouped_expert_ffn", x, wg, wu, wd)
    h = expert_gate_up(x, wg, wu, counts)
    return grouped_matmul(h, wd, counts)
