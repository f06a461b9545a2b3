"""Hardware profiles for the batching planner and the roofline analysis.

The paper's testbeds (Table 3) are modeled with published A5000/A6000 specs
plus the PCIe 4.0 link the paper states (32 GB/s).  ``H100_SXM_80GB`` is the
card this package serves on: its device fields are NVIDIA's H100 SXM data
sheet figures and its host fields are read from the running machine.

``matmul_utilization`` models the empirically observed ramp of achieved
FLOPs with per-module batch size (paper Fig. 3 left: ~2^10 tokens required
to saturate): a tile-quantization ramp that saturates at
``saturation_tokens``.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HardwareProfile:
    name: str
    # accelerator
    device_flops: float            # peak dense matmul FLOP/s (bf16)
    device_mem_bw: float           # HBM bytes/s
    device_mem_bytes: float        # HBM capacity
    saturation_tokens: int         # per-module batch needed for full util
    # host
    host_mem_bytes: float
    cpu_flops: float               # effective host matmul FLOP/s
    cpu_mem_bw: float              # host DRAM bytes/s (bounds host GEMV)
    cpu_cores: int = 16
    # links
    htod_bw: float = 32e9          # host -> device bytes/s
    dtoh_bw: float = 32e9          # device -> host bytes/s
    ici_bw: float = 0.0            # inter-chip bytes/s per link
    launch_overhead_s: float = 20e-6   # per-module launch overhead

    def matmul_utilization(self, tokens: int) -> float:
        """Fraction of peak FLOPs achieved by a GEMM over `tokens` rows."""
        if tokens <= 0:
            return 1e-6
        # linear ramp to saturation, floored at the single-tile rate
        return min(1.0, max(tokens, 8) / self.saturation_tokens)

    def gemm_time(self, flops: float, weight_bytes: float, act_bytes: float,
                  tokens: int) -> float:
        """Roofline GEMM time with the utilization ramp."""
        compute = flops / (self.device_flops * self.matmul_utilization(tokens))
        memory = (weight_bytes + act_bytes) / self.device_mem_bw
        return max(compute, memory) + self.launch_overhead_s

    def cpu_attn_time(self, flops: float, kv_bytes: float) -> float:
        """Host attention (GEMV-dominated => bandwidth bound)."""
        return max(flops / self.cpu_flops, kv_bytes / self.cpu_mem_bw)

    def a2a_time(self, nbytes: float, n_ranks: int) -> float:
        """All-to-all exchange time over ``n_ranks`` expert-parallel ranks.

        ``nbytes`` is the TOTAL payload of the exchange (both directions
        summed, as reported by ``distributed.a2a_bytes_per_stage``).  Each
        rank keeps 1/n of its sends local, so only the (n-1)/n fraction
        crosses the link; the link is the ICI where profiled, else the
        host-interconnect (multi-GPU boxes exchange over PCIe/NVLink
        modeled at the host-link rate).
        """
        if n_ranks <= 1 or nbytes <= 0:
            return 0.0
        bw = self.ici_bw or self.htod_bw
        wire = nbytes * (n_ranks - 1) / n_ranks
        return wire / bw + self.launch_overhead_s


# --------------------------------------------------------------------------
# Paper testbeds (Table 3)
# --------------------------------------------------------------------------
A5000_C1 = HardwareProfile(
    name="C1-A5000-256GB",
    device_flops=27.8e12 * 2,      # fp16/bf16 tensor-core dense
    device_mem_bw=768e9,
    device_mem_bytes=24e9,
    saturation_tokens=1024,        # paper Fig. 3 left
    host_mem_bytes=256e9,
    cpu_flops=1.2e12,              # AMD 7453 28C AVX2
    cpu_mem_bw=60e9,               # achieved AVX attention-kernel bandwidth
    cpu_cores=28,
    htod_bw=32e9,
    dtoh_bw=32e9,
)

A5000_C2 = HardwareProfile(
    name="C2-A5000-512GB",
    device_flops=27.8e12 * 2,
    device_mem_bw=768e9,
    device_mem_bytes=24e9,
    saturation_tokens=1024,
    host_mem_bytes=512e9,
    cpu_flops=1.2e12,
    cpu_mem_bw=60e9,
    cpu_cores=28,
    htod_bw=32e9,
    dtoh_bw=32e9,
)

A6000_C3 = HardwareProfile(
    name="C3-A6000-480GB",
    device_flops=38.7e12 * 2,
    device_mem_bw=768e9,
    device_mem_bytes=48e9,
    saturation_tokens=1024,
    host_mem_bytes=480e9,
    cpu_flops=0.6e12,              # AMD 7313P 16C — weaker host
    cpu_mem_bw=30e9,
    cpu_cores=16,
    htod_bw=32e9,
    dtoh_bw=32e9,
)

def _host_mem_bytes() -> float:
    """Physical memory of the running host, from the OS."""
    import os

    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def _host_cores() -> int:
    import os

    return os.cpu_count() or 1


# The serving card.  Field origins:
#   device_flops, device_mem_bw, device_mem_bytes -- NVIDIA H100 SXM data
#     sheet (989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 80 GB);
#   host_mem_bytes, cpu_cores -- read from the OS when this module loads;
#   htod_bw, dtoh_bw -- the dataclass default (not measured on this host);
#   saturation_tokens -- a placeholder until it is measured on the card;
#   cpu_flops, cpu_mem_bw -- placeholders: they price the host-attention
#     path (omega > 0, ``core.host_attention`` on the host CPU) that the
#     planner weighs against device attention and the engine serves.  They
#     stay placeholders until the CPU's measured attention rate is recorded
#     (PERF.md, from ``chip_smoke.py``'s serve_omega phase).
H100_SXM_80GB = HardwareProfile(
    name="H100-SXM-80GB",
    device_flops=989e12,
    device_mem_bw=3.35e12,
    device_mem_bytes=80e9,
    saturation_tokens=1024,
    host_mem_bytes=_host_mem_bytes(),
    cpu_flops=1.2e12,
    cpu_mem_bw=60e9,
    cpu_cores=_host_cores(),
)

PROFILES = {p.name: p for p in (A5000_C1, A5000_C2, A6000_C3, H100_SXM_80GB)}
