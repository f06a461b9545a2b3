"""A traced slice of a run: ``torch.profiler`` over a few steps, read back.

The slice is one ``bench.slice`` range; every call the harness makes into
the server inside it is a ``bench.step`` range.  From the profiler's trace
(written to the run's temporary directory and deleted once read):

* ``window_s``: the slice's length; ``busy_s``: the union of the device's
  kernels, copies and fills inside it;
* ``kernel_s``: device seconds by kernel or copy name;
* ``gaps_s``: idle device seconds, by what the host's main thread was doing
  when each gap began (the harness's range, then the innermost operation);
* ``unmatched``: host launches and copies in the slice with no device
  record (the profiler drops one now and then; such a slice is traced again).
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaGraphLaunch",
             "cudaMemcpyAsync", "cuLaunchKernel", "cuLaunchKernelEx")


@dataclass
class Slice:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)
    gaps_s: Dict[str, float] = field(default_factory=dict)
    unmatched: int = 0

    def kernels(self, names) -> float:
        """Device seconds of the kernels whose names contain any of ``names``."""
        return sum(s for k, s in self.kernel_s.items() if any(n in k for n in names))

    def breakdown(self, n: int = 10) -> Dict[str, List[Tuple[str, float]]]:
        top = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def read(events: List[Dict]) -> Slice:
    """Reduce a chrome trace's events to the slice's numbers."""
    win = next((e for e in events if e.get("name") == "bench.slice"
                and e.get("cat") == "user_annotation"), None)
    if win is None:
        raise RuntimeError("the trace has no bench.slice range")
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    tid = win.get("tid")
    dev, kernel_s, corr = [], defaultdict(float), set()
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in _DEVICE:
            continue
        a, b = max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"]))
        corr.add(e.get("args", {}).get("correlation"))
        if b > a:
            dev.append((a, b))
            kernel_s[e["name"]] += (b - a) * 1e-6
    busy = _union(dev)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("ph") == "X" and e.get("cat") in _HOST
                   and e.get("tid") == tid and float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0),
                  key=lambda t: (t[0], -t[1]))
    unmatched = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                    and e.get("name") in _LAUNCHES and w0 <= float(e["ts"]) < w1
                    and e.get("args", {}).get("correlation") not in corr)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    gaps_s: Dict[str, float] = defaultdict(float)
    starts = [h[0] for h in host]
    stack: List[Tuple[float, float, str]] = []
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
        outer = next((h[2] for h in reversed(stack) if h[2].startswith("bench.")), "bench")
        inner = stack[-1][2] if stack else "idle host"
        gaps_s[outer if inner == outer else f"{outer} > {inner}"] += (g1 - g0) * 1e-6
    return Slice(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 kernel_s=dict(kernel_s), gaps_s=dict(gaps_s), unmatched=unmatched)


class Tracer:
    """``with tracer.slice(): ...`` profiles the block as one slice; the
    ``step()`` context marks each call into the server."""

    def __init__(self) -> None:
        self.result: Slice | None = None

    @contextlib.contextmanager
    def slice(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        with prof:
            with record_function("bench.slice"):
                yield self
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.result = read(events)

    @staticmethod
    def step():
        from torch.profiler import record_function

        return record_function("bench.step")
