"""Serving: the share of the decode slot-steps run in the window that served
a live request (``ServeReport.wasted_slot_steps`` against
``decode_slot_steps``)."""


def read(r):
    steps = r.counters["decode_slot_steps"]
    if steps <= 0:
        return None
    return 100.0 * (1.0 - r.counters["wasted_slot_steps"] / steps)
