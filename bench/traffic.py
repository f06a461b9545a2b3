"""The one traffic generator: a mix file's parameters -> a seeded request stream.

A mix (``traffic/<name>.json``) gives

* ``prompt_len`` and ``decode_len``: ``{"dist": "loguniform"|"uniform"|"const",
  "lo": a, "hi": b}`` (``"value": n`` for ``const``), in tokens;
* ``deck``: how many requests share one fixed set of sizes.  Each deck holds
  the distribution's ``deck`` evenly spaced quantiles, in an order drawn from
  the seed, so every seed serves the same work in another order;
* ``loop``: ``"closed"``: every request due at once, the harness keeping the
  queue full as requests finish (open-loop arrivals are not generated yet).

Token ids are drawn uniformly from the vocabulary.  Every request is greedy.
After ``repro_torch.data.datasets.synthetic_requests``, frozen here; it
imports nothing of the program.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """``n`` evenly spaced quantiles of a length distribution, as ints."""
    q = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "const":
        return np.full(n, int(dist["value"]), np.int64)
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if kind == "loguniform":
        x = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif kind == "uniform":
        x = lo + q * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def max_len(dist: Dict) -> int:
    return int(dist["value"]) if dist["dist"] == "const" else int(dist["hi"])


@dataclass
class Spec:
    """One generated request: its prompt and decode length."""

    index: int
    prompt: np.ndarray
    decode_len: int


class Stream:
    """The seeded request stream of a mix: ``take(n)`` gives the next ``n``."""

    def __init__(self, mix: Dict, seed: int, vocab: int) -> None:
        self.mix = mix
        self.vocab = vocab
        self.deck = int(mix.get("deck", 1024))
        self._rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x7261FF1C])
        self._prompts = quantiles(mix["prompt_len"], self.deck)
        self._decodes = quantiles(mix["decode_len"], self.deck)
        if mix.get("loop", "closed") != "closed":
            raise ValueError(f"loop {mix['loop']!r}: only closed-loop mixes are generated")
        self._queue: List[Spec] = []
        self._n = 0

    def _refill(self) -> None:
        rng = self._rng
        p = self._prompts[rng.permutation(self.deck)]
        d = self._decodes[rng.permutation(self.deck)]
        for i in range(self.deck):
            prompt = rng.integers(0, self.vocab, int(p[i]), dtype=np.int32)
            self._queue.append(Spec(self._n, prompt, int(d[i])))
            self._n += 1

    def take(self, n: int) -> List[Spec]:
        while len(self._queue) < n:
            self._refill()
        out, self._queue = self._queue[:n], self._queue[n:]
        return out


def max_seq(mix: Dict) -> int:
    """The longest prompt plus decode the mix can draw."""
    return max_len(mix["prompt_len"]) + max_len(mix["decode_len"])
