"""Token sampling: per-request params, batched per-slot device-side sampling.

The engine's default decoding strategy is greedy argmax (paper §B); online
serving needs per-request sampling -- a batch may mix greedy slots with
seeded temperature / top-k slots.  ``SamplingParams`` is the per-request
policy, ``BatchSampler`` holds one slot of sampling state per engine batch
row and turns a ``(B, V)`` logits tensor into ``(B,)`` next tokens on the
logits' device (``sample_tokens``): per-slot Gumbel-max over temperature-
scaled, top-k-masked logits, greedy slots taking the plain argmax.

Determinism contract: slot *i*'s token at its *t*-th generated position is
a pure function of ``(logits, PRNGKey(seed), t)`` -- the key is folded with
the per-request token index, not any global step counter, so the same
request produces the same stream under the static and the continuous
scheduler, across runs, regardless of which batch slot it lands in, and in
the JAX package (the noise is its threefry stream, ``serving.prng``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.serving import prng


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy.

    ``temperature <= 0`` means greedy (argmax).  ``top_k > 0`` restricts
    sampling to the k highest logits.  ``seed`` determines the request's
    whole token stream (see the module determinism contract)."""

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


def _categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    ``logits`` plus Gumbel noise drawn over their whole (B, n) shape from
    the one threefry ``key`` (a ``prng.key_from_seed`` pair), element
    (b, j) taking counter ``b * n + j``."""
    B, n = logits.shape
    gum = prng.gumbel(_upload(np.asarray(key, np.int64).reshape(1, 2), logits.device),
                      B * n).reshape(B, n)
    return torch.argmax(gum + logits.float(), dim=-1)


def temperature_sample(key, logits: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens: Gumbel-max over ``logits /
    temperature`` under ``key`` (the JAX function's tokens for the same
    key); greedy when ``temperature <= 0``."""
    if temperature <= 0:
        return greedy(logits)
    return _categorical(key, logits / temperature)


def top_k_sample(key, logits: torch.Tensor, k: int,
                 temperature: float = 1.0) -> torch.Tensor:
    """(B, V) logits -> (B,) tokens drawn among each row's ``k`` highest
    logits (ties to the lower index, as ``jax.lax.top_k``), scaled by
    ``max(temperature, 1e-6)``; the noise covers the (B, k) candidates."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    choice = _categorical(key, vals / max(temperature, 1e-6))
    return torch.gather(idx, 1, choice[:, None])[:, 0]


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor, steps: torch.Tensor,
                  temps: torch.Tensor, topks: torch.Tensor,
                  use_topk: bool) -> torch.Tensor:
    """Batched sampling: (B, V) logits -> (B,) tokens.

    THE per-slot sampling function: ``BatchSampler.sample`` calls it and
    the engine's fused decode tick calls it inside the captured tick, so
    both paths sample bit-identically.  ``keys`` (B, 2) int64 are the slots'
    base threefry keys, folded with ``steps`` (B,) (each slot's token
    index); ``temps`` (B,) float32 and ``topks`` (B,) int64.  Slots with
    ``temps <= 0`` take the argmax of the raw logits.  ``use_topk=False``
    (the caller's promise that no slot has ``top_k > 0``) skips the vocab
    sort; a pure-temperature slot samples the same either way.  No host
    read, no data-dependent control flow."""
    V = logits.shape[-1]
    greedy_tok = greedy(logits)
    lg = logits.float()
    if use_topk:
        k = torch.clamp(topks, 0, V)
        sorted_desc = torch.sort(lg, dim=-1, descending=True).values
        kth = torch.gather(sorted_desc, 1, (torch.clamp(k, min=1) - 1)[:, None])
        lg = torch.where((k[:, None] > 0) & (lg < kth), float("-inf"), lg)
    scaled = lg / torch.clamp(temps, min=1e-6)[:, None]
    gum = prng.gumbel(prng.fold_in(keys, steps), V)
    sampled = torch.argmax(scaled + gum, dim=-1)
    return torch.where(temps > 0, sampled, greedy_tok)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host-side wait (an asynchronous
    copy; pageable memory is staged before the call returns)."""
    return torch.from_numpy(np.array(a)).to(device, non_blocking=True)  # lint: allow[MG105] the sampler's per-slot state, up once a sampled tick, asynchronous


class BatchSampler:
    """Per-slot sampling state for one engine batch.

    The scheduler sets a slot's ``SamplingParams`` at admission
    (``set_slot``), clears it at eviction (``clear_slot``; cleared slots
    are greedy), and calls ``sample`` once per logits column -- each call
    advances the sampled slots' token indices by one.  The engine's fused
    chunk reads the raw ``state`` instead, samples on the device and then
    ``advance``s the slots.  When every selected slot is greedy, ``sample``
    is a plain argmax (no keys uploaded, no noise drawn)."""

    def __init__(self, nslots: int) -> None:
        self.nslots = nslots
        self._keys = np.zeros((nslots, 2), np.uint32)
        self._steps = np.zeros(nslots, np.int64)
        self._temps = np.zeros(nslots, np.float32)
        self._topks = np.zeros(nslots, np.int64)

    def set_slot(self, i: int, params: Optional[SamplingParams],
                 salt: Optional[int] = None) -> None:
        """Arm slot ``i`` with ``params`` (None = greedy), resetting its
        token index.  ``salt`` (when given) is folded into the base key --
        used by uniform batch APIs to decorrelate rows sharing one seed."""
        sp = params or GREEDY
        key = prng.key_from_seed(sp.seed).astype(np.int64)
        if salt is not None:
            key = prng.fold_in(key, np.int64(salt))
        self._keys[i] = key
        self._steps[i] = 0
        self._temps[i] = max(0.0, float(sp.temperature))
        self._topks[i] = int(sp.top_k)

    def clear_slot(self, i: int) -> None:
        self._keys[i] = 0
        self._steps[i] = 0
        self._temps[i] = 0.0
        self._topks[i] = 0

    @classmethod
    def uniform(cls, nslots: int,
                params: Optional[SamplingParams]) -> "BatchSampler":
        """One shared policy for every slot, with the row index folded into
        each slot's key so rows sharing a seed draw independent streams."""
        s = cls(nslots)
        if params is not None:
            for i in range(nslots):
                s.set_slot(i, params, salt=i)
        return s

    def state(self, slots: Sequence[int]):
        """The selected slots' raw sampling state ``(keys (n, 2) uint32,
        steps (n,) int64, temps (n,) float32, topks (n,) int64)``, copies."""
        idx = np.asarray(slots, np.int64)
        return (self._keys[idx].copy(), self._steps[idx].copy(),
                self._temps[idx].copy(), self._topks[idx].copy())

    def advance(self, slots: Sequence[int], n: int = 1) -> None:
        """Advance the selected slots' token indices by ``n`` (a fused chunk
        sampled ``n`` tokens for each on the device)."""
        self._steps[np.asarray(slots, np.int64)] += n

    def sample(self, logits: torch.Tensor,
               slots: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Next token for each selected slot: (n, V) logits -> (n,) tokens
        on the logits' device, row j belonging to ``slots[j]``."""
        idx = (np.arange(self.nslots) if slots is None
               else np.asarray(slots, np.int64))
        assert logits.shape[0] == idx.size, (logits.shape, idx.size)
        if not (self._temps[idx] > 0).any():
            self._steps[idx] += 1
            return greedy(logits)
        keys, steps, temps, topks = self.state(idx)
        dev = logits.device
        toks = sample_tokens(logits, _upload(keys.astype(np.int64), dev),
                             _upload(steps, dev), _upload(temps, dev),
                             _upload(topks, dev), use_topk=bool((topks > 0).any()))
        self._steps[idx] += 1
        return toks
