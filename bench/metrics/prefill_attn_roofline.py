"""Kernels: prefill attention's share of its roofline in the traced slice:
the least time the slice's prompts need, causal over their own lengths
(``arith.prefill_attn``, every layer), over the device time of K4 (wgmma
and mma.sync designs)."""

from bench import arith

KERNELS = ("flash_wgmma_kernel", "flash_bf16_kernel", "flash_f32_kernel")


def read(r):
    if r.slice is None:
        return None
    t = r.slice.kernels(KERNELS)
    sz = r.cell.sizes
    least = sz.n_layers * sum(arith.least_s(*arith.prefill_attn(sz, L))
                              for wave in r.slice_log.prefill for mb in wave for L in mb)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
