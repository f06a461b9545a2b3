"""Kernels: the expert FFN's share of its roofline in the traced slice: the
least time the slice's expert work needs (``arith.ffn_launch``: one launch
a MoE layer per decode tick over its live rows, and one per prefill
micro-batch over its prompt tokens) over the device time of the kernels
that do it (K1 gate/up and K2 down, both designs)."""

from bench import arith

KERNELS = ("gate_up_wgmma_kernel", "gemm_wgmma_kernel", "gemm_bf16_kernel",
           "gemm_f32_kernel")


def read(r):
    if r.slice is None:
        return None
    t = r.slice.kernels(KERNELS)
    sz = r.cell.sizes
    least = 0.0
    for wave in r.slice_log.prefill:
        for mb in wave:
            least += arith.least_s(*arith.ffn_launch(sz, sum(mb)))
    for ticks, keys in r.slice_log.decode:
        live = len(keys) / ticks
        least += ticks * arith.least_s(*arith.ffn_launch(sz, live))
    least *= sz.n_layers
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
