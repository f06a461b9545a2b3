"""Model step: the window's model FLOPs over its seconds, as a share of the
H100's bf16 peak.  Every prompt token of the window's prefill waves and
every token its decode ticks generated counts 2 x the parameters it touches
plus its attention over the keys it sees (``arith``); padding and dead
slots count nothing."""

from bench import arith


def read(r):
    sz = r.cell.sizes
    flops = sum(arith.prefill_flops(sz, L) for wave in r.window.prefill
                for mb in wave for L in mb)
    flops += sum(arith.decode_flops(sz, k) for _, keys in r.window.decode for k in keys)
    if flops <= 0:
        return None
    return 100.0 * flops / r.window_s / arith.PEAK_FLOPS
