"""Open-loop arrival processes for online serving.

The offline protocol drains a fixed queue (every request due at t=0); an
online workload is open-loop — request *i* becomes admissible only at its
``arrival_s`` offset on the server's virtual clock (which is keyed off wall
time from the first ``Server.step``).  This module generates arrival-time
vectors and stamps them onto requests:

* ``poisson(n, rate)``   — exponential inter-arrival gaps (the standard
  open-loop load model vLLM/Ollama-style serving benchmarks use);
* ``uniform(n, gap)``    — a fixed-gap trace;
* ``trace([...])``       — an explicit offset list (validated);
* ``assign(requests, t)``— stamp ``arrival_s`` onto a request list.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def poisson(n: int, rate: float, seed: int = 0,
            start: float = 0.0) -> np.ndarray:
    """``n`` arrival offsets (seconds) of a Poisson process at ``rate``
    requests/second, starting at ``start``.  Deterministic in ``seed``."""
    if rate <= 0:
        raise ValueError(f"Poisson arrival rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return start + np.cumsum(gaps)


def uniform(n: int, gap: float, start: float = 0.0) -> np.ndarray:
    """``n`` arrivals a fixed ``gap`` seconds apart (first at ``start``)."""
    return start + gap * np.arange(n, dtype=np.float64)


def trace(times: Sequence[float]) -> np.ndarray:
    """Validate an explicit arrival trace: finite, non-negative offsets."""
    t = np.asarray(list(times), np.float64)
    if t.size and (not np.isfinite(t).all() or (t < 0).any()):
        raise ValueError(f"arrival trace must be finite and >= 0, got {t}")
    return t


def assign(requests: List, times: Sequence[float]) -> List:
    """Stamp ``times[i]`` onto ``requests[i].arrival_s`` (in place).

    Returns the request list for chaining.  Raises when the trace is
    shorter than the request list (a silently-cycled arrival trace would
    fabricate load)."""
    t = trace(times)
    if len(requests) > t.size:
        raise ValueError(
            f"arrival trace has {t.size} entries for {len(requests)} requests"
        )
    for r, s in zip(requests, t):
        r.arrival_s = float(s)
    return requests
