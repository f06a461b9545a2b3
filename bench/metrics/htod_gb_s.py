"""Weights: streamed weight bytes copied host to device in the window
(``ServeReport.weight_htod_bytes``) over the window's seconds.  Nothing to
read where every weight is resident."""


def read(r):
    b = r.counters["weight_htod_bytes"]
    if b <= 0:
        return None
    return b / r.window_s / 1e9
