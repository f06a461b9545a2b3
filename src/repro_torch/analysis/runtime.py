"""Runtime sanitizer: host-read-guarded decode regions, steady-state capture
detection, cache-pointer checks and poisoning of dropped caches.

The port's counterpart of the JAX package's ``jax.transfer_guard`` regions.
The decode path must read nothing back to the host but at its planned
points, capture no new CUDA graph in steady state, and keep every cache
tensor at the address its captured graphs hold.  This module turns those
contracts into guards:

* ``sanitize(strict=True)`` activates a sanitizer.  While one is active,
  every engine ``decode_region()`` runs under a ``TorchFunctionMode`` that
  raises ``SanitizerError`` (``strict=False``: records it) on a host read of
  a tensor -- ``item``, ``tolist``, ``numpy``, ``cpu``, ``bool()``,
  ``int()``, ``float()``, an index, ``numpy.asarray`` -- and on
  ``torch.cuda.synchronize`` and the ``synchronize`` of an event or a
  stream.  The mode sees these on CPU tensors too, so the CPU tests hold the
  whole decode path to it.  On the card the region also sets
  ``torch.cuda.set_sync_debug_mode("error")`` (``"warn"`` when not strict),
  which catches the syncs hidden inside operators.  Planned reads run in
  ``allowed(tag)`` scopes, which suspend both guards and count each
  occurrence under ``tag`` in the report.
* ``Sanitizer.steady()`` marks a steady-state region: any key set of the
  graph-capture registry (``analysis.registry``) that grows inside it is a
  ``RetraceViolation`` naming the key.
* ``sanitize(pointers=True)``: the engine checks after every decode tick
  that its cache tensors, page pools and graph carries keep the
  ``data_ptr()`` they had at the batch's first tick
  (``analysis.donation.check_pointers``); a change is a
  ``DonationViolation``.
* ``sanitize(poison=True)``: a cache the engine drops is filled with NaN
  before it is released, so a retained reference reads NaN, not stale
  values (``analysis.donation.poison``).

Unarmed, ``decode_region()`` is a null context (no mode is installed) and
``allowed()`` only turns the CUDA sync debug mode off around the read, so
that an outside ``set_sync_debug_mode("error")`` keeps working.

``REPRO_SANITIZE=strict|log`` arms a process-wide sanitizer;
``REPRO_SANITIZE_POISON=1`` adds poisoning; ``REPRO_SANITIZE_REPORT=<path>``
writes the JSON report when the interpreter exits.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
from typing import Dict, Iterator, List, Optional

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis import registry
from repro_torch.analysis.spans import span


class SanitizerError(AssertionError):
    """Base class for sanitizer contract violations (an unplanned host read
    inside a decode region)."""


class RetraceViolation(SanitizerError):
    """A decode graph was captured inside a steady-state region."""


class DonationViolation(SanitizerError):
    """A cache tensor, page pool or graph carry moved between decode ticks
    of one batch: the port's form of a dropped donation.  The captured
    decode graphs hold those addresses, so a rebound tensor is one the
    graphs no longer write (or one they write after it was freed)."""


class Sanitizer:
    def __init__(self, strict: bool = True, pointers: bool = False,
                 poison: bool = False) -> None:
        self.strict = strict
        self.pointers = pointers
        self.poison = poison
        self.planned: Dict[str, int] = {}
        self.host_reads: List[str] = []
        self.steady_retraces: Dict[str, int] = {}
        self.pointer_checks = 0
        self.pointer_violations: List[str] = []
        self.poisoned = 0
        self.pointer_book: Dict = {}     # (owner, batch key) -> {name: data_ptr}

    def fail(self, err: type, message: str, log: List[str]) -> None:
        """Raise ``err`` (strict) or record ``message`` in ``log``."""
        if self.strict:
            raise err(message)
        log.append(message)

    @contextlib.contextmanager
    def steady(self) -> Iterator[None]:
        """Steady-state region: no decode graph may be captured inside it.
        Warm the graphs first (run the same workload once), then run again
        under ``steady()``."""
        base = registry.snapshot()
        yield
        grew = registry.growth(base)
        for name, _ in grew:
            self.steady_retraces[name] = self.steady_retraces.get(name, 0) + 1
        if grew and self.strict:
            raise RetraceViolation("steady-state graph capture: " + ", ".join(
                f"{name} {key!r}" for name, key in grew))

    def report(self) -> dict:
        return {
            "mode": "strict" if self.strict else "log",
            "planned_transfers": dict(self.planned),
            "host_reads": list(self.host_reads),
            "steady_retraces": dict(self.steady_retraces),
            "trace_key_sets": registry.keyset_counts(),
            "pointer_checks": self.pointer_checks,
            "pointer_violations": list(self.pointer_violations),
            "poisoned": self.poisoned,
        }


# ---------------------------------------------------------------------------
# Active-sanitizer stack (+ ambient env activation)
# ---------------------------------------------------------------------------
_STACK: List[Sanitizer] = []
_AMBIENT: Optional[Sanitizer] = None
_AMBIENT_INIT = False


def _dump_report(san: Sanitizer, path: str) -> None:
    try:
        with open(path, "w") as f:
            json.dump(san.report(), f, indent=2, sort_keys=True, default=str)
    except OSError:
        pass


def _ambient() -> Optional[Sanitizer]:
    """The process-wide sanitizer armed from the environment, built on
    first use so that importing the package has no side effects."""
    global _AMBIENT, _AMBIENT_INIT
    if not _AMBIENT_INIT:
        _AMBIENT_INIT = True
        mode = os.environ.get("REPRO_SANITIZE", "").strip().lower()
        if mode in ("strict", "log", "1", "true"):
            _AMBIENT = Sanitizer(strict=mode != "log",
                                 poison=bool(os.environ.get("REPRO_SANITIZE_POISON")))
            path = os.environ.get("REPRO_SANITIZE_REPORT")
            if path:
                atexit.register(_dump_report, _AMBIENT, path)
    return _AMBIENT


def current() -> Optional[Sanitizer]:
    """The innermost active sanitizer, or the ambient one, or None."""
    return _STACK[-1] if _STACK else _ambient()


@contextlib.contextmanager
def sanitize(strict: bool = True, pointers: bool = False,
             poison: bool = False) -> Iterator[Sanitizer]:
    """Activate a sanitizer for the body; yields it, so callers can open
    ``steady()`` regions and read ``report()``."""
    san = Sanitizer(strict=strict, pointers=pointers, poison=poison)
    _STACK.append(san)
    try:
        yield san
    finally:
        _STACK.pop()


# ---------------------------------------------------------------------------
# The guard
# ---------------------------------------------------------------------------
_HOST_READS = {
    torch.Tensor.item: ".item()", torch.Tensor.tolist: ".tolist()",
    torch.Tensor.numpy: ".numpy()", torch.Tensor.cpu: ".cpu()",
    torch.Tensor.__bool__: "bool()", torch.Tensor.__int__: "int()",
    torch.Tensor.__float__: "float()", torch.Tensor.__index__: "an index",
    torch.Tensor.__array__: "numpy.asarray()",
}
_SYNCS = ((torch.cuda, "synchronize", "torch.cuda.synchronize()"),
          (torch.cuda.Event, "synchronize", "Event.synchronize()"),
          (torch.cuda.Stream, "synchronize", "Stream.synchronize()"))


class _HostReadGuard(TorchFunctionMode):
    """Flags a host read of a tensor unless an ``allowed`` scope is open."""

    def __init__(self, san: Sanitizer) -> None:
        super().__init__()
        self.san = san
        self.suspended = 0

    def check(self, what: str) -> None:
        if not self.suspended:
            self.san.fail(SanitizerError, f"host read {what} inside a decode region "
                          "outside any allowed() scope", self.san.host_reads)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        what = _HOST_READS.get(func)
        if what is not None:
            self.check(what)
        return func(*args, **(kwargs or {}))


_GUARDS: List[_HostReadGuard] = []


def _guarded_sync(fn, what: str):
    def sync(*args, **kwargs):
        if _GUARDS:
            _GUARDS[-1].check(what)
        return fn(*args, **kwargs)
    return sync


def _set_sync_mode(mode) -> Optional[int]:
    """Set the CUDA sync debug mode where CUDA is in use; the previous mode,
    or None when nothing was changed."""
    if not torch.cuda.is_initialized():
        return None
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    return prev


@contextlib.contextmanager
def decode_region() -> Iterator[None]:
    """A decode region: with a sanitizer active, a host read of a tensor or
    a stream sync inside it raises (strict) or is recorded."""
    san = current()
    if san is None or _GUARDS:
        yield
        return
    guard = _HostReadGuard(san)
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in _SYNCS]
    for (owner, name, fn), (_, _, what) in zip(saved, _SYNCS):
        setattr(owner, name, _guarded_sync(fn, what))
    _GUARDS.append(guard)
    prev = _set_sync_mode("error" if san.strict else "warn")
    try:
        with guard:
            yield
    finally:
        if prev is not None:
            torch.cuda.set_sync_debug_mode(prev)
        _GUARDS.pop()
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def count(tag: str) -> None:
    """Count one planned transfer under ``tag`` without suspending any guard
    (a host-to-device copy, which is no host read)."""
    san = current()
    if san is not None:
        san.planned[tag] = san.planned.get(tag, 0) + 1


@contextlib.contextmanager
def allowed(tag: str) -> Iterator[None]:
    """A planned host read (or host wait): suspends the decode region's
    guard and the CUDA sync debug mode, counts one occurrence of ``tag`` in
    the active sanitizer's report, and runs the body in the profiler range
    ``sync.<tag>`` (``analysis.spans``)."""
    count(tag)
    guard = _GUARDS[-1] if _GUARDS else None
    if guard is not None:
        guard.suspended += 1
    prev = None
    if torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() != 0:
        prev = _set_sync_mode(0)
    try:
        with span("sync." + tag):
            yield
    finally:
        if prev is not None:
            torch.cuda.set_sync_debug_mode(prev)
        if guard is not None:
            guard.suspended -= 1
