"""Kernels: decode attention's share of its roofline in the traced slice:
the least time the slice's decode tokens need, each reading the K and V of
every key it sees once (``arith.decode_attn``, every layer), over the
device time of K3 (split-KV and SIMT designs)."""

from bench import arith

KERNELS = ("decode_split_kernel", "decode_attn_kernel")


def read(r):
    if r.slice is None:
        return None
    t = r.slice.kernels(KERNELS)
    sz = r.cell.sizes
    least = sz.n_layers * sum(arith.least_s(*arith.decode_attn(sz, k))
                              for _, keys in r.slice_log.decode for k in keys)
    if t <= 0 or least <= 0:
        return None
    return 100.0 * least / t
