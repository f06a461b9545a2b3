"""Token sampling: per-request params and per-slot batched sampling.

This slice serves greedy decoding (the paper's strategy, §B): a slot's next
token is the argmax of its logits, computed on the device.  Seeded
temperature / top-k sampling needs the JAX package's threefry streams to
keep the determinism contract (a slot's t-th token is a pure function of
logits, seed and t); that port is the sampling slice, and asking for it
here raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

SAMPLING_SLICE = ("seeded temperature/top-k sampling is the sampling slice "
                  "of the port; this slice serves greedy decoding only")


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy; ``temperature <= 0`` is greedy."""

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


GREEDY = SamplingParams()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis (the first maximal index on ties)."""
    return torch.argmax(logits, dim=-1)


class BatchSampler:
    """Per-slot sampling state for one engine batch.

    Same surface as the JAX package's sampler: ``set_slot`` at admission,
    ``clear_slot`` at eviction, ``sample`` once per logits column (each call
    advances the sampled slots' token indices).  Every slot is greedy here.
    """

    def __init__(self, nslots: int) -> None:
        self.nslots = nslots
        self._steps = np.zeros(nslots, np.int32)

    def set_slot(self, i: int, params: Optional[SamplingParams],
                 salt: Optional[int] = None) -> None:
        if params is not None and not params.is_greedy:
            raise NotImplementedError(SAMPLING_SLICE)
        self._steps[i] = 0

    def clear_slot(self, i: int) -> None:
        self._steps[i] = 0

    @classmethod
    def uniform(cls, nslots: int,
                params: Optional[SamplingParams]) -> "BatchSampler":
        s = cls(nslots)
        for i in range(nslots):
            s.set_slot(i, params, salt=i)
        return s

    def sample(self, logits: torch.Tensor,
               slots: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Next token for each selected slot: (n, V) logits -> (n,) tokens
        on the logits' device, row j belonging to ``slots[j]``."""
        idx = (np.arange(self.nslots) if slots is None
               else np.asarray(slots, np.int64))
        assert logits.shape[0] == idx.size, (logits.shape, idx.size)
        self._steps[idx] += 1
        return greedy(logits)
