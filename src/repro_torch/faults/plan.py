"""Deterministic fault injection and recovery policy for the serving stack.

The serving stack (streamed weights, paged KV, replica fan-out) operates
at the resource limit, where transient ``device_put`` failures, host
memory spikes, and dead replicas are routine rather than exceptional.
This module provides the *injection* half of the fault-tolerance
contract; the recovery policies live at the seams they protect
(``serving/weights.py``, ``serving/cache.py``, ``serving/server.py``,
``distributed/replicas.py``).

Design constraints:

* **Deterministic.** Every injection decision is a pure function of
  ``(seed, site, per-site event counter)`` hashed through
  ``hashlib.blake2b`` — never wall-clock time or Python's per-process
  salted ``hash``.  Replaying the same schedule against the same request
  stream reproduces the same faults, which is what makes the chaos
  property tests (token-identical to the fault-free run) possible.
* **Bounded.** A site never draws two *consecutive* transient failures,
  so any retry policy with ``max_retries >= 1`` is guaranteed to make
  progress — injected faults perturb the run, they never wedge it.
* **Unarmed == absent.** Every seam guards on ``faults.current() is
  None`` first; with no plan armed (no ``REPRO_FAULTS`` env, no
  ``ServeConfig.faults``) the serving path is byte-for-byte identical to
  a build without this package.

Arming mirrors the sanitizer (``repro.analysis.runtime``): an explicit
``with faults.armed(plan):`` region wins over the ambient process-wide
plan parsed from the ``REPRO_FAULTS`` env var; ``faults.shielded()``
masks the ambient plan for fault-free baselines inside a chaos-armed
process.  ``REPRO_FAULTS_REPORT=<path>`` dumps the injected/recovered
event counts as JSON at interpreter exit (a CI artifact).
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base class for fault-path errors.

    ``ReplicaServer`` treats a replica raising a ``FaultError`` (recovery
    exhausted) as dead and fails its requests over to survivors; any
    other exception type propagates — a bug should abort loudly, not be
    silently absorbed by failover.
    """


class TransientTransferError(FaultError):
    """A stream transfer failed transiently (retryable)."""


class StreamTimeoutError(FaultError):
    """A ``StreamWindow.acquire`` wait exceeded the watchdog deadline.

    Raised only after the one-shot recovery (abandon the dead in-flight
    entry, demand re-fetch) also fails — names the window tag and key so
    the hang is attributable.
    """


class PageAllocOOM(FaultError):
    """KV page-frame allocation found no free frame (host and device
    tiers exhausted, or an injected OOM)."""


# --------------------------------------------------------------------------
# policies & specs
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The ONE retry policy shared by weight, expert-prefetch and KV-page
    stream traffic (``StreamWindow`` instances of every tag).

    ``watchdog_s=None`` keeps the historical unbounded
    ``block_until_ready`` wait on ``acquire``; a finite watchdog polls
    device-buffer readiness against a deadline instead, so a dead
    in-flight future surfaces as ``StreamTimeoutError`` rather than a
    hang.
    """

    max_retries: int = 3
    backoff_s: float = 0.001
    backoff_cap_s: float = 0.05
    watchdog_s: Optional[float] = None

    def __post_init__(self):
        assert self.max_retries >= 0, self.max_retries
        assert self.backoff_s >= 0.0 and self.backoff_cap_s >= 0.0
        assert self.watchdog_s is None or self.watchdog_s > 0.0


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A parsed fault schedule (see ``parse_spec`` for the string form).

    Rates are per-event probabilities in ``[0, 1]``; the virtual clocks
    are event counters (fetch issues, frame allocations, decode ticks,
    fleet steps) — never wall time.
    """

    seed: int = 0
    transfer_rate: float = 0.0    # P(transient failure) per stream fetch
    stall_rate: float = 0.0       # P(in-flight transfer parks dead) per prefetch
    oom_rate: float = 0.0         # P(page-frame alloc reports OOM) per new row
    preempt_every: int = 0        # preempt one running request every N decode ticks
    kill_replica: int = -1        # replica index to kill (-1 = never)
    kill_after: int = 0           # fleet steps before the kill fires

    def __post_init__(self):
        for r in (self.transfer_rate, self.stall_rate, self.oom_rate):
            assert 0.0 <= r <= 1.0, r
        assert self.preempt_every >= 0 and self.kill_after >= 0


def parse_spec(text: str) -> FaultSpec:
    """Parse a ``REPRO_FAULTS`` / ``--faults`` spec string.

    Example: ``"seed=3,transfer=0.2,stall=0.05,oom=0.1,preempt=7,kill=1@4"``
    — seed 3; 20% transient fetch failures; 5% stalled prefetches; 10%
    page-alloc OOMs; preempt a running request every 7 decode ticks; kill
    replica 1 after 4 fleet steps.
    """
    kw: Dict[str, object] = {}
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad faults spec item {part!r} (expect key=value)")
        key, val = (s.strip() for s in part.split("=", 1))
        if key == "seed":
            kw["seed"] = int(val)
        elif key == "transfer":
            kw["transfer_rate"] = float(val)
        elif key == "stall":
            kw["stall_rate"] = float(val)
        elif key == "oom":
            kw["oom_rate"] = float(val)
        elif key == "preempt":
            kw["preempt_every"] = int(val)
        elif key == "kill":
            replica, _, after = val.partition("@")
            kw["kill_replica"] = int(replica)
            kw["kill_after"] = int(after) if after else 1
        else:
            raise ValueError(f"unknown faults spec key {key!r} in {text!r}")
    return FaultSpec(**kw)  # type: ignore[arg-type]


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------

class FaultPlan:
    """A live, armed fault schedule: deterministic draws + event ledger.

    Each injection site (``"transfer:stream-window"``,
    ``"oom"``, ...) keeps its own event counter; the n-th draw at a site
    is ``blake2b(f"{seed}:{site}:{n}") / 2**64 < rate``.  The ledger
    (``events``) counts both injected faults and the recoveries the
    serving stack reports back via ``note`` — dumped by ``report()`` /
    ``REPRO_FAULTS_REPORT``.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._counts: Dict[str, int] = {}
        self._last_fail: Dict[str, bool] = {}
        self.events: Dict[str, int] = {}

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        return cls(parse_spec(text))

    # -- deterministic draws ----------------------------------------------
    def _draw(self, site: str) -> float:
        n = self._counts.get(site, 0)
        self._counts[site] = n + 1
        digest = hashlib.blake2b(
            f"{self.spec.seed}:{site}:{n}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(digest, "big") / 2.0**64

    def _fail(self, site: str, rate: float) -> bool:
        """Rate-draw at ``site``, bounded to never fail twice in a row."""
        if rate <= 0.0:
            return False
        if self._last_fail.get(site, False):
            self._last_fail[site] = False
            return False
        hit = self._draw(site) < rate
        self._last_fail[site] = hit
        return hit

    # -- injection queries (consulted by the seams) -----------------------
    def transfer_fault(self, tag: str, key) -> bool:
        if self._fail(f"transfer:{tag}", self.spec.transfer_rate):
            self.note(f"injected:transfer:{tag}")
            return True
        return False

    def stall_fault(self, tag: str, key) -> bool:
        if self._fail(f"stall:{tag}", self.spec.stall_rate):
            self.note(f"injected:stall:{tag}")
            return True
        return False

    def page_oom(self) -> bool:
        if self._fail("oom", self.spec.oom_rate):
            self.note("injected:page-oom")
            return True
        return False

    def preempt_due(self, tick: int) -> bool:
        n = self.spec.preempt_every
        if n > 0 and tick > 0 and tick % n == 0:
            self.note("injected:preempt")
            return True
        return False

    def kill_due(self, replica: int, step: int) -> bool:
        if replica == self.spec.kill_replica and step == self.spec.kill_after:
            self.note("injected:replica-kill")
            return True
        return False

    # -- recovery ledger ---------------------------------------------------
    def note(self, event: str, n: int = 1) -> None:
        self.events[event] = self.events.get(event, 0) + n

    def report(self) -> Dict[str, object]:
        return {"spec": dataclasses.asdict(self.spec),
                "events": dict(sorted(self.events.items()))}


def resolve(obj) -> Optional[FaultPlan]:
    """Coerce a ``ServeConfig.faults`` value into a plan (or ``None``).

    Accepts ``None`` / a spec string / a ``FaultSpec`` / an armed
    ``FaultPlan`` (shared plans keep one ledger across servers).
    """
    if obj is None or isinstance(obj, FaultPlan):
        return obj
    if isinstance(obj, FaultSpec):
        return FaultPlan(obj)
    if isinstance(obj, str):
        return FaultPlan.parse(obj)
    raise TypeError(f"cannot resolve faults from {type(obj).__name__}")


# --------------------------------------------------------------------------
# arming: explicit region > ambient env  (mirrors analysis.runtime)
# --------------------------------------------------------------------------

class _Shield:
    """Stack sentinel: masks the ambient plan (fault-free baseline)."""


_STACK: List[object] = []
_AMBIENT: Optional[FaultPlan] = None
_AMBIENT_INIT = False


def _dump_report(fp: FaultPlan, path: str) -> None:
    try:
        with open(path, "w") as f:
            json.dump(fp.report(), f, indent=2, sort_keys=True)
    except OSError:
        pass


def _ambient() -> Optional[FaultPlan]:
    global _AMBIENT, _AMBIENT_INIT
    if not _AMBIENT_INIT:
        _AMBIENT_INIT = True
        spec = os.environ.get("REPRO_FAULTS", "").strip()
        if spec:
            _AMBIENT = FaultPlan.parse(spec)
            path = os.environ.get("REPRO_FAULTS_REPORT", "").strip()
            if path:
                atexit.register(_dump_report, _AMBIENT, path)
    return _AMBIENT


def current() -> Optional[FaultPlan]:
    """The armed plan for this point of execution (or ``None``)."""
    if _STACK:
        top = _STACK[-1]
        return None if isinstance(top, _Shield) else top  # type: ignore[return-value]
    return _ambient()


@contextlib.contextmanager
def armed(fp):
    """Arm ``fp`` (a ``FaultPlan``) for the dynamic extent of the block.

    ``armed(None)`` is a pass-through — the ambient ``REPRO_FAULTS``
    plan (if any) stays visible, so a server built without explicit
    faults still participates in a CI chaos run.
    """
    if fp is None:
        yield None
        return
    assert isinstance(fp, FaultPlan), fp
    _STACK.append(fp)
    try:
        yield fp
    finally:
        _STACK.pop()


@contextlib.contextmanager
def shielded():
    """Mask any armed/ambient plan: the block runs fault-free."""
    _STACK.append(_Shield())
    try:
        yield
    finally:
        _STACK.pop()


def note(event: str, n: int = 1) -> None:
    """Record a recovery event on the armed plan, if any (no-op unarmed)."""
    fp = current()
    if fp is not None:
        fp.note(event, n)
