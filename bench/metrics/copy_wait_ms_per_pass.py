"""Weights: the compute stream's wait for streamed weight copies in the
window (``ServeReport.prefetch_wait_s``, timed with CUDA events) per pass
over the layers: each decode tick and each prefill wave streams the same
stacks once, and the counter holds the waits of both.  Nothing to read where
every weight is resident."""


def read(r):
    passes = sum(t for t, _ in r.window.decode) + len(r.window.prefill)
    if passes <= 0 or r.counters["weight_htod_bytes"] <= 0:
        return None
    return 1e3 * r.counters["prefetch_wait_s"] / passes
