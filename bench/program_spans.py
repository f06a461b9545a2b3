"""The traced slice as the program's own ranges divide it.

``repro_torch`` writes profiler ranges while a profile is active
(``repro_torch.analysis.spans``): ``serve.prefill`` over each admission
wave, ``serve.decode`` over each decode chunk through its token read, and
``sync.<tag>`` over each planned host read or wait.  ``read(events)`` takes
the same chrome-trace events as ``bench.trace.read`` (the ``bench.slice``
range, the main thread's host ranges and the device's records) and gives a
``Program``, or None where the slice holds no ``serve.*`` range (a program
without the ranges); ``shares`` turns it into the per-layer quantities in
percent.  ``bench.trace`` does not call it yet: its ``Slice`` would carry
the result for readers under ``metrics/``.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from bench.trace import _DEVICE, _HOST, _union

_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")

Intervals = List[Tuple[float, float]]


@dataclass
class Program:
    """In seconds:

    * ``idle_in``: the device's idle time inside ``serve.prefill`` ranges
      (``prefill``), inside ``serve.decode`` ranges (``decode``) and outside
      both (``outside``); the three sum to the slice's window less its busy
      time (``bench.trace.Slice``);
    * ``sync_idle``: every idle gap that began while the host waited on the
      device, whole: by tag where it began inside a ``sync.<tag>`` range,
      ``unplanned`` where it began in a stream, device or event
      synchronisation or a device-to-host ``cudaMemcpyAsync`` outside one;
    * ``decode_span_s``: the time inside ``serve.decode`` ranges; of it,
      ``htod_idle_s`` with no host-to-device copy on the card, and
      ``copy_only_s`` with one and no kernel;
    * ``spans``: the program's ranges in the slice, by name.
    """

    window_s: float
    idle_in: Dict[str, float]
    sync_idle: Dict[str, float]
    decode_span_s: float
    htod_idle_s: float
    copy_only_s: float
    spans: Dict[str, int]


def _length(iv: Intervals) -> float:
    return sum(b - a for a, b in iv)


def _meet(x: Intervals, y: Intervals) -> Intervals:
    """The intersection of two sorted unions of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def read(events: List[Dict]) -> Optional[Program]:
    """The slice's split by the program's ranges (times in the trace's us)."""
    win = next((e for e in events if e.get("name") == "bench.slice"
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        raise RuntimeError("the trace has no bench.slice range")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    tid = win.get("tid")
    dev, kern, htod, dtoh = [], [], [], set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        if e["name"].startswith("Memcpy DtoH"):
            dtoh.add(e.get("args", {}).get("correlation"))
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        if b > a:
            dev.append((a, b))
            if e["cat"] == "kernel":
                kern.append((a, b))
            elif e["name"].startswith("Memcpy HtoD"):
                htod.append((a, b))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
                    e.get("args", {}).get("correlation"))
                   for e in events if e.get("ph") == "X" and e.get("cat") in _HOST
                   and e.get("tid") == tid and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0),
                  key=lambda t: (t[0], -t[1]))
    ranges: Dict[str, Intervals] = defaultdict(list)
    for a, b, name, _ in host:
        if name.startswith(("serve.", "sync.")):
            ranges[name].append((max(w0, a), min(w1, b)))
    if not any(n.startswith("serve.") for n in ranges):
        return None
    gaps, t = [], w0
    for a, b in _union(dev):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # the host's open ranges where each gap began, as bench.trace finds them
    sync_idle: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        i_end = bisect.bisect_right(starts, g0)
        while i < i_end:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        tag = next((h[2][len("sync."):] for h in reversed(stack)
                    if h[2].startswith("sync.")), None)
        if tag is None and any(h[2] in _WAITS or (h[2] == "cudaMemcpyAsync" and h[3] in dtoh)
                               for h in stack):
            tag = "unplanned"
        if tag is not None:
            sync_idle[tag] += (g1 - g0) * 1e-6
    prefill, decode = _union(ranges["serve.prefill"]), _union(ranges["serve.decode"])
    in_prefill, in_decode = _length(_meet(gaps, prefill)), _length(_meet(gaps, decode))
    copying = _meet(decode, _union(htod))
    return Program(
        window_s=(w1 - w0) * 1e-6,
        idle_in={"prefill": in_prefill * 1e-6, "decode": in_decode * 1e-6,
                 "outside": (_length(gaps) - in_prefill - in_decode) * 1e-6},
        sync_idle=dict(sync_idle), decode_span_s=_length(decode) * 1e-6,
        htod_idle_s=(_length(decode) - _length(copying)) * 1e-6,
        copy_only_s=(_length(copying) - _length(_meet(copying, _union(kern)))) * 1e-6,
        spans={n: len(v) for n, v in ranges.items() if v})


def shares(p: Program) -> Dict[str, float]:
    """The per-layer quantities, in percent: the idle share of the slice in
    prefill, in decode and outside both (together the slice's device idle
    share), in gaps begun in a host wait; and of the decode ranges, the link
    idle (``htod_idle_pct``) and the copies alone on the card
    (``copy_bound_pct``)."""
    w, d = p.window_s, p.decode_span_s
    return {"prefill_idle_pct": 100.0 * p.idle_in["prefill"] / w,
            "decode_idle_pct": 100.0 * p.idle_in["decode"] / w,
            "serve_idle_pct": 100.0 * p.idle_in["outside"] / w,
            "sync_idle_pct": 100.0 * sum(p.sync_idle.values()) / w,
            "htod_idle_pct": 100.0 * p.htod_idle_s / d if d > 0 else 0.0,
            "copy_bound_pct": 100.0 * p.copy_only_s / d if d > 0 else 0.0}
