"""Engine: the program's decode seconds in the window (``ServeReport.decode_s``,
each chunk timed to its token read) over the decode ticks the window ran."""


def read(r):
    ticks = sum(t for t, _ in r.window.decode)
    if ticks <= 0:
        return None
    return 1e3 * r.counters["decode_s"] / ticks
