"""Graph-capture registry: the port's counterpart of the trace-cache registry.

In the JAX package a steady-state retrace shows as growth of a jitted
function's trace cache.  In the port the counterpart is a new CUDA-graph
capture of the decode tick (``ModuleBatchingEngine._graph``): the engine
adds every captured key to a named ``TraceKeySet``, and
``Sanitizer.steady()`` raises ``RetraceViolation`` naming the key when any
key set grows inside its region.

A key set's growth is its count of keys added so far, which never falls:
``discard`` (the engine drops the graphs of a cache it replaced) lets the
same key count again when it is captured again.

``register_collective`` marks a function that may issue a
``torch.distributed`` collective (lint rule MG107): every collective of the
distributed slice lives in such a function.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Tuple

_KEYSETS: "weakref.WeakSet[TraceKeySet]" = weakref.WeakSet()


class TraceKeySet:
    """A named set of keys one dispatcher has seen.  ``add`` returns True
    exactly when the key is new; ``added`` lists every new key in order (a
    key discarded and added again appears twice)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._keys: set = set()
        self.added: List[Any] = []
        _KEYSETS.add(self)

    def add(self, key: Any) -> bool:
        if key in self._keys:
            return False
        self._keys.add(key)
        self.added.append(key)
        return True

    def discard(self, key: Any) -> None:
        self._keys.discard(key)

    def __contains__(self, key: Any) -> bool:
        return key in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def count(self) -> int:
        return len(self._keys)


def snapshot() -> Dict[TraceKeySet, int]:
    """Every live key set with the number of keys added to it so far."""
    return {ks: len(ks.added) for ks in list(_KEYSETS)}


def growth(since: Dict[TraceKeySet, int]) -> List[Tuple[str, Any]]:
    """``(set name, key)`` of every key added since ``since`` (a
    ``snapshot()``); a key set made after it counts from zero."""
    out: List[Tuple[str, Any]] = []
    for ks in list(_KEYSETS):
        out += [(ks.name, key) for key in ks.added[since.get(ks, 0):]]
    return out


def keyset_counts() -> Dict[str, int]:
    """Distinct keys per key-set name, summed over live instances (several
    engines may each hold a set under one name)."""
    out: Dict[str, int] = {}
    for ks in list(_KEYSETS):
        out[ks.name] = out.get(ks.name, 0) + ks.count
    return out


def register_collective(name: str) -> Callable:
    """Name a function that issues ``torch.distributed`` collectives (lint
    rule MG107 matches the decorator by name; the name is kept on the
    function)."""

    def deco(fn: Callable) -> Callable:
        fn.__collective__ = name
        return fn

    return deco
