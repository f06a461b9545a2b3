"""Engine: prompt tokens the window's prefill waves computed over the seconds
they took (``ServeReport.prefill_tokens`` / ``prefill_s``)."""


def read(r):
    s = r.counters["prefill_s"]
    if s <= 0:
        return None
    return r.counters["prefill_tokens"] / s
