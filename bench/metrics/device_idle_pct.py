"""Device: the share of the traced slice in which neither a kernel nor a
copy ran on the card."""


def read(r):
    if r.slice is None or r.slice.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.slice.busy_s / r.slice.window_s)
