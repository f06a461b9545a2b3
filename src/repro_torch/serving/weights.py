"""Streamed parameter store: weight residency and the prefetch window.

The paper's headline mechanism (Fig. 6; ``S_Params``/``S_Expert`` in
Table 2) keeps part of the weights in host memory and copies them to the
device behind the grouped expert GEMM.  ``ParamStore`` is the executor side
of that policy:

* the **resident set** lives on the device, filled greedily up to
  ``Plan.s_params`` by ``core.workload.plan_residency`` (base weights,
  then sequence mixers and norms, then dense FFNs, then expert stacks), the
  policy the planner's cost model charges misses with;
* the **streamed set** lives in page-locked host memory, one flat byte
  buffer per layer, and reaches the device through a ``StreamWindow``: the
  engine calls ``prefetch(l + 1)`` before layer *l*'s FFN so the copy runs
  on the copy stream while the compute stream works, and ``acquire(l)``
  makes the compute stream wait for it;
* with ``predict_topk > 0`` a streamed MoE layer's norm2 and router stay
  on the device and its experts stream one by one: the engine predicts the
  next streamed MoE layer's experts from its router, prefetches them, and
  copies each expert the routing actually used into its row of a
  preallocated (E, ...) stack; a hot-expert LRU keeps recently used experts
  on the device.

Every copy consults the armed fault plan (``repro_torch.faults``; nothing
happens unarmed): a transient failure injected at issue is retried under the
window's ``RetryPolicy``, and a stalled or overdue copy is abandoned at
``acquire`` and fetched again (``StreamWindow``).
"""
from __future__ import annotations

import sys
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch import faults
from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.device import resolve_device
from repro_torch.models.blocks import init_layer_params
from repro_torch.models.model import init_base_params, layer_schema

# per-layer module split, the streaming granularity: 'mixer' is norm1 +
# attention/SSM; 'ffn' is norm2 + (MoE stacks and router | dense FFN)
_MIXER_KEYS = ("norm1", "attn", "ssm")
_FFN_KEYS = ("norm2", "moe", "ffn")
_EXPERT_KEYS = ("experts_w_gate", "experts_w_up", "experts_w_down")
# every tensor of a flat buffer starts on this byte boundary (TMA needs 16)
_ALIGN = 256


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


# ---------------------------------------------------------------------------
# Flat buffers
# ---------------------------------------------------------------------------
class _Layout:
    """Where each tensor of a tree sits in one flat byte buffer: every
    leaf at an ``_ALIGN``-byte offset, in the tree's order."""

    def __init__(self, tree) -> None:
        self.leaves = []
        off = 0
        for path, t in _leaves(tree):
            nb = t.numel() * t.element_size()
            self.leaves.append((path, t.dtype, tuple(t.shape), off, nb))
            off += -(-nb // _ALIGN) * _ALIGN
        self.size = off                                   # bytes with padding
        self.nbytes = sum(leaf[4] for leaf in self.leaves)  # tensor bytes

    def views(self, buf: torch.Tensor) -> Dict:
        """The tree as views into ``buf`` (uint8, at least ``size`` long)."""
        out: Dict = {}
        for path, dtype, shape, off, nb in self.leaves:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = buf[off:off + nb].view(dtype).view(shape)
        return out

    def fill(self, buf: torch.Tensor, tree) -> None:
        """Copy ``tree``'s tensors into their places in ``buf``."""
        for (_, t), (_, dtype, shape, off, nb) in zip(_leaves(tree), self.leaves):
            buf[off:off + nb].view(dtype).view(shape).copy_(t)


# page-locked host bytes the live stores hold (``pinned_bytes()``)
_PINNED = {"bytes": 0}


def pinned_bytes() -> int:
    """Host bytes the port's live parameter stores hold page-locked."""
    return _PINNED["bytes"]


class _HostBuffer:
    """``nbytes`` of host memory as one uint8 tensor.  ``pin()`` page-locks
    it with ``cudaHostRegister`` (a store on a card: copies from it then run
    asynchronously); it is unregistered when the buffer dies.  Pinning that
    fails raises: pageable memory would make every copy a host wait.  A
    buffer is filled before it is pinned, which pins pages already touched
    (4x faster than letting the registration fault them in)."""

    def __init__(self, nbytes: int) -> None:
        self.tensor = torch.empty(nbytes, dtype=torch.uint8)
        self.pinned = 0

    def pin(self) -> None:
        nbytes = self.tensor.numel()
        if self.pinned or not nbytes:
            return
        rc = torch.cuda.cudart().cudaHostRegister(self.tensor.data_ptr(), nbytes, 0)
        if int(rc) != 0:
            raise RuntimeError(f"page-locking {nbytes} bytes of host memory for "
                               f"streamed weights failed ({rc})")
        self.pinned = nbytes
        _PINNED["bytes"] += nbytes

    def __del__(self) -> None:
        # at interpreter exit the process's end unpins it
        if self.pinned and not sys.is_finalizing():
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            _PINNED["bytes"] -= self.pinned
            self.pinned = 0


@dataclass
class _Packed:
    """A module tree packed into a host buffer: its layout and its bytes."""

    layout: _Layout
    host: _HostBuffer

    @classmethod
    def of(cls, tree, pin: bool) -> "_Packed":
        layout = _Layout(tree)
        packed = cls(layout, _HostBuffer(layout.size))
        layout.fill(packed.host.tensor, tree)
        if pin:
            packed.host.pin()
        return packed


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------
_COPY_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def copy_stream(device: torch.device) -> "torch.cuda.Stream":
    """The one stream per device that every host-to-device weight copy
    runs on."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    s = _COPY_STREAMS.get(device)
    if s is None:
        s = _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return s


@dataclass
class _Entry:
    slot: Optional[int]                   # None: issued, its copy deferred
    value: object = None
    ready: Optional["torch.cuda.Event"] = None
    issued_at: float = 0.0                # host clock when its copy was queued
    dead: bool = False                    # an injected stall: never consumed


class StreamWindow:
    """Bounded window of in-flight host-to-device copies (the double
    buffer), with the reference's key semantics: ``prefetch(key)`` issues
    the copy of ``key`` and parks it in a window of at most ``depth``
    in-flight keys (the oldest is dropped); ``acquire(key)`` consumes it, or
    fetches on demand when it was never staged.  ``htod_bytes`` counts what
    was issued (``size(key)`` a key, as the reference counts), ``issued``
    and ``demand`` the prefetches and demand fetches, ``wait_s`` the time
    the consumer waited for its copies.  ``copies`` and ``copied_bytes``
    count, apart from those, the copies really queued: a prefetch whose
    copy was deferred or whose slot was taken is copied again when it is
    acquired, and one dropped before it had a slot is never copied.

    On a card the window owns ``depth`` device slots of ``slot_bytes``,
    allocated once.  ``fetch(key, slot) -> (value, nbytes)`` enqueues the
    copy of ``key`` into a slot (a uint8 tensor) on the current stream and
    returns the views the consumer reads and the bytes the copy moves.
    Copies run on the device's copy stream, each followed by an event;
    ``acquire`` makes the compute stream wait on that event and never
    blocks the host.  The consumer holds the acquired slot (its lease)
    until its next ``acquire`` or ``release``: the release records an event
    on the compute stream after everything queued so far, and a later copy
    into that slot first waits on it, so a prefetch never overwrites
    weights that queued compute still reads.  A prefetch that finds no free
    slot (depth 1, the only slot leased) is issued and counted but its copy
    waits for the lease to end; ``wait_s`` comes from events, settled when
    both have been reached (``take_counters``, after the planned token
    read).

    On the CPU the slots are host tensors and a fetch is a plain copy; the
    counters count the same keys and bytes, and ``wait_s`` stays 0.

    Faults (the reference's semantics, ``repro_torch.faults``): each issue
    -- a prefetch or a demand fetch -- first draws an injected transient
    failure from the armed plan, before its copy is queued; a failure is
    retried under ``retry`` (``RetryPolicy``, with its backoff), the retried
    copy counted under the sanitizer tag ``fault-retry`` (a first attempt
    under ``tag``); exhaustion raises
    ``TransientTransferError``.  A prefetch may draw a stall, which marks
    its entry dead.  With a finite ``retry.watchdog_s`` an entry whose copy
    is older than that and not yet done (``Event.query``, which does not
    block) is dead too.  ``acquire`` of a dead entry counts a timeout and
    fetches the key again on demand (``fault-retry``); the dead copy's slot
    is reused only behind that copy (``_after``).  The host never waits on
    a copy.  ``retries`` and ``timeouts`` are drained by
    ``take_fault_counters``."""

    def __init__(self, fetch: Callable, size: Callable, slot_bytes: int,
                 device: torch.device, depth: int = 2,
                 tag: str = "stream-window",
                 retry: Optional[faults.RetryPolicy] = None) -> None:
        self._fetch = fetch
        self._size = size
        self.tag = tag
        self.retry = retry if retry is not None else faults.RetryPolicy()
        self.depth = max(1, depth)
        self.device = device
        self._cuda = device.type == "cuda"
        self._slots = ([torch.empty(slot_bytes, dtype=torch.uint8, device=device)
                        for _ in range(self.depth)] if slot_bytes else [])
        self._free: List[int] = list(range(len(self._slots)))
        self._after: List[Optional["torch.cuda.Event"]] = [None] * len(self._slots)
        self._lease: Optional[int] = None
        self._lease_key = None
        self._lease_ready: Optional["torch.cuda.Event"] = None
        self.inflight: Dict = {}
        self._order: List = []
        self._waits: List[Tuple["torch.cuda.Event", "torch.cuda.Event"]] = []
        self.htod_bytes = 0
        self.wait_s = 0.0
        self.issued = 0
        self.demand = 0
        self.copies = 0
        self.copied_bytes = 0
        self.retries = 0
        self.timeouts = 0

    def _issue(self, key, e: _Entry) -> None:
        """Enqueue ``key``'s copy into ``e.slot`` on the copy stream, after
        the slot's last reader."""
        buf = self._slots[e.slot]
        self.copies += 1
        e.issued_at = time.perf_counter()
        if not self._cuda:
            e.value, nbytes = self._fetch(key, buf)
            self.copied_bytes += nbytes
            return
        cs = copy_stream(self.device)
        if self._after[e.slot] is not None:
            cs.wait_event(self._after[e.slot])
        with torch.cuda.stream(cs):
            e.value, nbytes = self._fetch(key, buf)
            e.ready = torch.cuda.Event(enable_timing=True)
            e.ready.record(cs)
        self.copied_bytes += nbytes

    def _issue_with_retry(self, key, e: _Entry, recovery: bool = False) -> None:
        """One issue of ``key``: draw the injected transient failure, and on
        success queue the copy (when ``e`` has a slot), counted under the
        attempt's tag: ``tag`` for a first attempt, ``fault-retry`` for a
        retry or a ``recovery`` fetch (a copy is no host read: the guards
        stay on).  A failure is retried under the policy and raises
        ``TransientTransferError`` once it is spent."""
        delay = self.retry.backoff_s
        for attempt in range(self.retry.max_retries + 1):
            sanitizer.count("fault-retry" if recovery or attempt else self.tag)
            fp = faults.current()
            if fp is None or not fp.transfer_fault(self.tag, key):
                if e.slot is not None:
                    self._issue(key, e)
                return
            if attempt >= self.retry.max_retries:
                raise faults.TransientTransferError(
                    f"injected transient transfer fault (window {self.tag!r}, key {key!r})")
            self.retries += 1
            faults.note(f"recovered:transfer-retry:{self.tag}")
            if delay > 0.0:
                time.sleep(min(delay, self.retry.backoff_cap_s))
            delay = min(delay * 2.0, self.retry.backoff_cap_s or delay)

    def _landed(self, e: _Entry) -> bool:
        """Whether ``e``'s copy is done (never blocks)."""
        return e.ready is None or e.ready.query()

    def _overdue(self, e: _Entry) -> bool:
        """A queued copy older than the watchdog and not yet done."""
        wd = self.retry.watchdog_s
        return (wd is not None and e.slot is not None
                and time.perf_counter() - e.issued_at > wd and not self._landed(e))

    def _recover(self, key, e: _Entry) -> _Entry:
        """Abandon a dead entry and fetch ``key`` again on demand.  Its slot
        goes back to the free list, and the next copy into it first waits
        for the dead copy."""
        self.timeouts += 1
        faults.note(f"recovered:transfer-timeout:{self.tag}")
        if e.slot is not None:
            if e.ready is not None:
                self._after[e.slot] = e.ready
            self._free.append(e.slot)
        fresh = _Entry(self._claim())
        try:
            self._issue_with_retry(key, fresh, recovery=True)
        except faults.TransientTransferError as err:
            raise faults.StreamTimeoutError(
                f"stalled stream copy and the recovery fetch failed after "
                f"{self.retry.max_retries} retries (window {self.tag!r}, key {key!r})") from err
        self.htod_bytes += self._size(key)
        self.demand += 1
        return fresh

    def _claim(self) -> int:
        """A slot for a copy that goes out now: a free one, else the one of
        the oldest in-flight key, whose copy is then deferred (it stays
        issued and counted once, as in the reference, and moves its bytes
        again if it is acquired)."""
        if self._free:
            return self._free.pop(0)
        for k in self._order:
            e = self.inflight[k]
            if e.slot is not None:
                slot, e.slot, e.value, e.ready = e.slot, None, None, None
                return slot
        raise RuntimeError(f"stream window {self.tag!r} has no slot")

    @hot_path
    def prefetch(self, key) -> None:
        """Issue ``key``'s copy into the window (returns at once).  No-op
        when it is already in flight."""
        if key in self.inflight:
            return
        while len(self._order) >= self.depth:
            e = self.inflight.pop(self._order.pop(0))
            if e.slot is not None:          # a later copy into it queues
                self._free.append(e.slot)   # behind this one on the stream
        e = _Entry(self._free.pop(0) if self._free else None)
        self._issue_with_retry(key, e)
        fp = faults.current()
        if fp is not None and fp.stall_fault(self.tag, key):
            e.dead = True
        self.inflight[key] = e
        self._order.append(key)
        self.htod_bytes += self._size(key)
        self.issued += 1

    @hot_path
    def acquire(self, key):
        """Consume ``key``'s copy (or fetch it on demand) and make the
        compute stream wait for it; returns its views.  Ends the previous
        lease first.  A dead entry (stalled, or overdue past the watchdog)
        is fetched again on demand."""
        self.release()
        e = self.inflight.pop(key, None)
        if e is None:
            e = _Entry(self._claim())
            self._issue_with_retry(key, e)
            self.htod_bytes += self._size(key)
            self.demand += 1
        else:
            self._order.remove(key)
            if e.dead or self._overdue(e):
                e = self._recover(key, e)
            elif e.slot is None:
                e.slot = self._claim()
                self._issue(key, e)
        self._wait(e)
        self._lease, self._lease_key, self._lease_ready = e.slot, key, e.ready
        return e.value

    def _wait(self, e: _Entry) -> None:
        """Make the compute stream wait for ``e``'s copy (timed)."""
        if e.ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        reached = torch.cuda.Event(enable_timing=True)
        reached.record(cur)
        cur.wait_event(e.ready)
        self._waits.append((reached, e.ready))

    def refetch(self, key):
        """Copy ``key`` again into the slot the consumer holds (what it
        acquired went stale), counted as a demand fetch; returns the new
        views, which the compute stream waits for."""
        assert self._lease is not None and self._lease_key == key, (self._lease_key, key)
        e = _Entry(self._lease)
        self._issue(key, e)
        self.htod_bytes += self._size(key)
        self.demand += 1
        self._wait(e)
        self._lease_ready = e.ready
        return e.value

    def wait_copy(self, key) -> None:
        """Block the host until every queued copy of ``key`` (in flight or
        held by the consumer) has read its source, so that the host may
        write the source again."""
        for ready in ((self.inflight[key].ready if key in self.inflight else None),
                      self._lease_ready if self._lease_key == key else None):
            if ready is not None and not ready.query():
                ready.synchronize()

    def release(self) -> None:
        """End the consumer's lease: later copies into its slot wait for the
        compute stream's work queued so far."""
        if self._lease is None:
            return
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._after[self._lease] = ev
        self._free.append(self._lease)
        self._lease, self._lease_key, self._lease_ready = None, None, None

    def take_fault_counters(self) -> Tuple[int, int]:
        """Drain (retries, timeouts) since the last call."""
        out = (self.retries, self.timeouts)
        self.retries = self.timeouts = 0
        return out

    def take_counters(self) -> Tuple[int, float]:
        """Drain (htod_bytes, wait_s) since the last call.  A wait counts
        once both of its events were reached: the consumer's arrival at it
        and its copy's end."""
        pending = []
        for reached, ready in self._waits:
            if reached.query() and ready.query():
                self.wait_s += max(0.0, reached.elapsed_time(ready)) / 1e3
            else:
                pending.append((reached, ready))
        self._waits = pending
        out = (self.htod_bytes, self.wait_s)
        self.htod_bytes = 0
        self.wait_s = 0.0
        return out

    def close(self) -> None:
        """Free the slots.  The compute stream first waits for the copy
        stream, so no queued copy writes memory the allocator hands out
        again; the host is not blocked."""
        if self._cuda and self._slots:
            torch.cuda.current_stream(self.device).wait_stream(copy_stream(self.device))
        self._slots, self._free, self._after = [], [], []
        self.inflight.clear()
        self._order.clear()
        self._lease, self._lease_key, self._lease_ready = None, None, None


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------
class ParamStore:
    """Weight residency the engine executes through.

    ``resident_bytes=None`` keeps everything on the device.  A finite
    budget realizes the greedy ``workload.plan_residency`` split;
    ``resident_bytes=0`` streams every per-layer module (the base weights
    stay resident).  ``prefetch=False`` fetches on demand at ``acquire``:
    the serial copy-then-compute baseline.  ``predict_topk > 0`` streams
    the expert stacks of streamed MoE layers per expert (module
    docstring); ``lru_bytes`` (default: the residency plan's spare bytes)
    bounds the hot-expert LRU.

    On a card a streamed module is packed into page-locked host memory
    (``_HostBuffer``); the windows' slots, the per-expert stacks and the
    LRU are device buffers allocated once here.  ``close()`` (and dropping
    the store) frees all of them and unpins the host memory."""

    def __init__(self, cfg: ModelConfig, params: Dict,
                 resident_bytes: Optional[float] = None, prefetch: bool = True,
                 prefetch_depth: int = 2, predict_topk: int = 0,
                 lru_bytes: Optional[float] = None, device="cuda") -> None:
        self._setup(cfg, resident_bytes, prefetch, prefetch_depth, predict_topk,
                    lru_bytes, device)
        if len(params["layers"]) != len(self.schema):
            raise ValueError(
                f"{len(params['layers'])} layer dicts for {len(self.schema)} layers")
        for li, lp in enumerate(params["layers"]):
            self._place(li, lp)
        self._finish({k: v for k, v in params.items() if k != "layers"})

    @classmethod
    def seeded(cls, cfg: ModelConfig, seed: int = 0,
               resident_bytes: Optional[float] = None, prefetch: bool = True,
               prefetch_depth: int = 2, predict_topk: int = 0,
               lru_bytes: Optional[float] = None, device="cuda") -> "ParamStore":
        """The store of ``init_params(cfg, seed)``'s weights, built without
        the whole model ever being on the device: each layer is drawn on the
        device with ``init_params``'s generator, in its order, and placed in
        its home at once (a streamed module is copied to host memory and its
        device copy freed), then the base weights.  Holds bit for bit what
        ``ParamStore(cfg, init_params(cfg, seed), ...)`` holds."""
        store = cls.__new__(cls)
        store._setup(cfg, resident_bytes, prefetch, prefetch_depth, predict_topk,
                     lru_bytes, device)
        gen = torch.Generator(device=store.device)
        gen.manual_seed(seed)
        for li, (kind, ffn) in enumerate(store.schema):
            store._place(li, init_layer_params(cfg, kind, ffn, gen))
        store._finish(init_base_params(cfg, gen))
        return store

    @classmethod
    def build(cls, cfg: ModelConfig, params: Dict, plan=None,
              stream_weights: bool = False,
              resident_bytes: Optional[float] = None, prefetch: bool = True,
              predict_topk: Optional[int] = None,
              lru_bytes: Optional[float] = None, device="cuda") -> "ParamStore":
        """The budget policy shared by the engine and the server: everything
        resident unless ``stream_weights``; the budget is the plan's
        ``s_params`` unless ``resident_bytes`` overrides it; predictive
        per-expert streaming follows the plan's ``predict_topk`` unless
        overridden."""
        budget, khat = None, 0
        if stream_weights:
            budget = plan.s_params if resident_bytes is None else resident_bytes
            khat = (getattr(plan, "predict_topk", 0) if predict_topk is None
                    else predict_topk)
        return cls(cfg, params, resident_bytes=budget, prefetch=prefetch,
                   predict_topk=khat, lru_bytes=lru_bytes, device=device)

    # -- construction -----------------------------------------------------
    def _setup(self, cfg, resident_bytes, prefetch, prefetch_depth, predict_topk,
               lru_bytes, device) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.schema: List[Tuple[str, str]] = layer_schema(cfg)
        self.prefetch_enabled = prefetch
        self.prefetch_depth = max(1, prefetch_depth)
        self.residency = W.plan_residency(cfg, resident_bytes)
        self.predict_topk = (max(0, min(cfg.num_experts, int(predict_topk)))
                             if cfg.has_moe else 0)
        self._lru_budget = lru_bytes
        self._resident: List[Dict] = []            # merged resident tensors
        self._host: List[Optional[_Packed]] = []   # streamed modules of a layer
        self._moe_shared: Dict[int, Dict] = {}     # norm2 + router, on device
        self._experts_host: Dict[int, _HostBuffer] = {}   # E experts, flat
        self._expert_layout: Optional[_Layout] = None

    def _place(self, li: int, layer: Dict) -> None:
        """Put layer ``li``'s modules in their homes."""
        dev = self.device
        ffn_kind = self.schema[li][1]
        mixer = {k: v for k, v in layer.items() if k in _MIXER_KEYS}
        ffnp = {k: v for k, v in layer.items() if k in _FFN_KEYS}
        res: Dict = {}
        host: Dict = {}
        if self.residency.mixer_resident[li]:
            res.update(_tree_to(mixer, dev))
        else:
            host["mixer"] = mixer
        if ffnp:
            if self.residency.ffn_resident[li]:
                res.update(_tree_to(ffnp, dev))
            elif self.predict_topk > 0 and ffn_kind == "moe":
                moe = ffnp["moe"]
                self._moe_shared[li] = {"norm2": ffnp["norm2"].to(dev),
                                        "router": moe["router"].to(dev)}
                experts = [{k: moe[k][e] for k in _EXPERT_KEYS}
                           for e in range(self.cfg.num_experts)]
                if self._expert_layout is None:
                    self._expert_layout = _Layout(experts[0])
                lay = self._expert_layout
                buf = _HostBuffer(lay.size * len(experts))
                for e, tree in enumerate(experts):
                    lay.fill(buf.tensor[e * lay.size:(e + 1) * lay.size], tree)
                if self._pin:
                    buf.pin()
                self._experts_host[li] = buf
            else:
                host["ffn"] = ffnp
        self._resident.append(res)
        self._host.append(_Packed.of(host, self._pin) if host else None)

    def _finish(self, base: Dict) -> None:
        """Base weights, the windows, the expert stacks and the LRU."""
        dev, E = self.device, max(1, self.cfg.num_experts)
        self.base: Dict = _tree_to(base, dev)
        slot = max((h.layout.size for h in self._host if h is not None), default=0)
        # the windows' fetches close over the host buffers, not the store: a
        # store <-> window cycle would outlive ``del`` until a gc pass
        hosts, experts, lay = self._host, self._experts_host, self._expert_layout

        def fetch(li: int, slot: torch.Tensor) -> Tuple[Dict, int]:
            """One copy of layer ``li``'s flat streamed modules."""
            h = hosts[li]
            slot[:h.layout.size].copy_(h.host.tensor, non_blocking=True)
            return h.layout.views(slot), h.layout.size

        def fetch_expert(key: Tuple[int, int], slot: torch.Tensor):
            """One copy of an expert's flat weights: ((the slot, its views),
            the bytes moved)."""
            li, e = key
            slot.copy_(experts[li].tensor[e * lay.size:(e + 1) * lay.size],
                       non_blocking=True)
            return (slot, lay.views(slot)), lay.size

        self._window = StreamWindow(fetch, lambda li: hosts[li].layout.nbytes, slot,
                                    dev, depth=self.prefetch_depth)
        # two layers' worth of experts, so that prefill's all-expert staging
        # and back-to-back predicted sets do not evict each other
        self._expert_window = StreamWindow(
            fetch_expert, lambda key: lay.nbytes,
            lay.size if lay is not None else 0, dev, depth=2 * E,
            tag="expert-prefetch")
        self._stack: Dict[str, torch.Tensor] = {}
        self._lru: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        self._lru_free: List[int] = []
        self._lru_used = 0
        self.lru_bytes = float(self.residency.spare_bytes if self._lru_budget is None
                               else self._lru_budget)
        self._expert_counters = {"pred_hits": 0, "pred_misses": 0, "lru_hits": 0}
        if lay is not None:
            # the (E, ...) stacks K1/K2 read, zeroed once.  A row the routing
            # does not use keeps whatever expert it last held: finite, and
            # exact, because an unrouted expert's capacity rows are zero, its
            # outputs are never gathered back, and on the card K1/K2 skip an
            # expert whose count is 0.  (The plain CPU version does compute
            # those rows, so a NaN there would show in the CPU tests.)
            for k, (_, dtype, shape, _, _) in zip(_EXPERT_KEYS, lay.leaves):
                self._stack[k] = torch.zeros((E,) + shape, dtype=dtype, device=dev)
            n = min(int(self.lru_bytes // lay.nbytes) if lay.nbytes else 0,
                    E * len(self._experts_host))
            self._lru_pool = torch.empty((n, lay.size), dtype=torch.uint8, device=dev)
            self._lru_free = list(range(n))
        self._closed = False

    def close(self) -> None:
        """Free the device buffers (window slots, stacks, LRU) and unpin and
        free the host memory.  The host waits for the copy stream first: a
        queued copy may still read the host buffers."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        if self.device.type == "cuda" and self._host_buffers():
            copy_stream(self.device).synchronize()
        self._window.close()
        self._expert_window.close()
        self._stack, self._lru, self._lru_free = {}, OrderedDict(), []
        self._lru_pool = None
        self._host[:] = [None] * len(self._host)
        self._experts_host.clear()

    def _host_buffers(self) -> bool:
        return bool(self._experts_host) or any(h is not None for h in self._host)

    def __del__(self) -> None:
        # a store alive at interpreter exit is left to the process's end:
        # torch's modules may already be torn down
        if not sys.is_finalizing():
            self.close()

    # -- residency inspection ---------------------------------------------
    @property
    def fully_resident(self) -> bool:
        """True when every per-layer module is on the device: the condition
        for the engine's fused decode chunk (a CUDA graph needs every
        weight at a fixed address)."""
        return all(h is None for h in self._host) and not self._experts_host

    def resident_module_bytes(self) -> int:
        return (tree_bytes(self.base) + sum(tree_bytes(r) for r in self._resident)
                + sum(tree_bytes(m) for m in self._moe_shared.values()))

    def streamed_module_bytes(self) -> int:
        per_layer = self._expert_layout.nbytes * self.cfg.num_experts \
            if self._expert_layout is not None else 0
        return (sum(h.layout.nbytes for h in self._host if h is not None)
                + per_layer * len(self._experts_host))

    def describe(self) -> str:
        pred = (f", predict_topk={self.predict_topk}, "
                f"lru={self.lru_bytes / 1e9:.3f}GB" if self.predict_topk > 0 else "")
        return (f"resident {self.resident_module_bytes() / 1e9:.3f}GB "
                f"(+{self.residency.n_streamed()} streamed modules, "
                f"{self.streamed_module_bytes() / 1e9:.3f}GB host-side, "
                f"window={self.prefetch_depth}, "
                f"prefetch={'on' if self.prefetch_enabled else 'off'}{pred})")

    def device_buffer_bytes(self) -> int:
        """Device bytes of the windows' slots, the stacks and the LRU."""
        slots = sum(s.numel() for w in (self._window, self._expert_window)
                    for s in w._slots)
        lru = 0 if getattr(self, "_lru_pool", None) is None else self._lru_pool.numel()
        return slots + tree_bytes(self._stack) + lru

    # -- streaming --------------------------------------------------------
    @property
    def _inflight(self) -> Dict:
        return self._window.inflight

    @property
    def htod_bytes(self) -> int:
        return self._window.htod_bytes + self._expert_window.htod_bytes

    @property
    def prefetch_wait_s(self) -> float:
        return self._window.wait_s + self._expert_window.wait_s

    @property
    def prefetch_issued(self) -> int:
        return self._window.issued + self._expert_window.issued

    @property
    def demand_fetches(self) -> int:
        return self._window.demand + self._expert_window.demand

    @property
    def copied_bytes(self) -> int:
        """Bytes of the copies really queued since the store was built (the
        flat buffers' padding included); not drained."""
        return self._window.copied_bytes + self._expert_window.copied_bytes

    def prefetch(self, li: int) -> None:
        """Issue layer ``li``'s streamed modules into the window (returns at
        once).  Call it before the previous layer's FFN so the copy hides
        behind it.  Wraps, so the last layer prefetches layer 0."""
        if not self.prefetch_enabled:
            return
        li %= len(self.schema)
        if self._host[li] is not None:
            self._window.prefetch(li)

    def acquire(self, li: int, experts: bool = True) -> Dict:
        """Layer ``li``'s parameter dict with its streamed modules on the
        device (consuming the in-flight copy, or fetching on demand).

        For a predictively streamed MoE layer ``experts=False`` returns only
        the mixer and the resident norm2/router: the decode stage assembles
        the stacks itself (``acquire_experts``) once it knows which experts
        the routing used.  ``experts=True`` (prefill) assembles every
        expert."""
        merged = dict(self._resident[li])
        if self._host[li] is not None:
            for tree in self._window.acquire(li).values():
                merged.update(tree)
        if li in self._moe_shared:
            shared = self._moe_shared[li]
            merged["norm2"] = shared["norm2"]
            moe = {"router": shared["router"]}
            if experts:
                wg, wu, wd = self.acquire_experts(li, range(self.cfg.num_experts),
                                                  record=False)
                moe.update(experts_w_gate=wg, experts_w_up=wu, experts_w_down=wd)
            merged["moe"] = moe
        return merged

    # -- predictive per-expert streaming ------------------------------------
    def streams_experts(self, li: int) -> bool:
        """True when layer ``li``'s experts stream one by one."""
        return li % len(self.schema) in self._experts_host

    def moe_shared(self, li: int) -> Dict:
        """The resident norm2 and router of a predictively streamed MoE
        layer: the router lets layer *l* predict layer *l+1*'s experts
        before any of *l+1*'s expert bytes move."""
        return self._moe_shared[li % len(self.schema)]

    def _lru_put(self, key: Tuple[int, int], flat: torch.Tensor) -> None:
        """Keep a just-used expert in the LRU (a device copy of its flat
        bytes), demoting the coldest past the byte budget."""
        nbytes = self._expert_layout.nbytes
        if nbytes > self.lru_bytes or key in self._lru:
            return
        while self._lru_used + nbytes > self.lru_bytes and self._lru:
            _, row = self._lru.popitem(last=False)
            self._lru_free.append(row)
            self._lru_used -= nbytes
        if not self._lru_free:
            return
        row = self._lru_free.pop(0)
        self._lru_pool[row].copy_(flat)
        self._lru[key] = row
        self._lru_used += nbytes

    @hot_path
    def prefetch_experts(self, li: int, expert_ids: Iterable[int]) -> None:
        """Issue the predicted experts of layer ``li`` into the expert
        window; experts the LRU holds need no copy."""
        if not self.prefetch_enabled:
            return
        li %= len(self.schema)
        if li not in self._experts_host:
            return
        E = self.cfg.num_experts
        for e in expert_ids:
            e = int(e)
            if 0 <= e < E and (li, e) not in self._lru:
                self._expert_window.prefetch((li, e))

    @hot_path
    def acquire_experts(self, li: int, expert_ids: Iterable[int],
                        record: bool = True) -> Tuple[torch.Tensor, ...]:
        """Layer ``li``'s (E, ...) expert stacks with the weights of
        ``expert_ids`` in their rows, each from the LRU, else from the
        window (a predicted copy, or a demand fetch).  Rows are written on
        the compute stream, so the stacks are reused by every layer in
        order.  ``record`` counts the prediction and LRU hits (decode);
        prefill's all-expert assembly passes False."""
        li %= len(self.schema)
        want = {int(e) for e in expert_ids}
        lay, win = self._expert_layout, self._expert_window
        for e in range(self.cfg.num_experts):
            if e not in want:
                continue
            key = (li, e)
            row = self._lru.get(key)
            if row is not None:
                self._lru.move_to_end(key)
                if record:
                    self._expert_counters["lru_hits"] += 1
                views = lay.views(self._lru_pool[row])
            else:
                if record:
                    hit = key in win.inflight
                    self._expert_counters["pred_hits" if hit else "pred_misses"] += 1
                flat, views = win.acquire(key)
            for k in _EXPERT_KEYS:
                self._stack[k][e].copy_(views[k])
            if row is None:
                self._lru_put(key, flat)
        win.release()
        return tuple(self._stack[k] for k in _EXPERT_KEYS)

    def take_counters(self) -> Tuple[int, float]:
        """Drain (htod_bytes, prefetch_wait_s) of both windows."""
        b1, w1 = self._window.take_counters()
        b2, w2 = self._expert_window.take_counters()
        return b1 + b2, w1 + w2

    def take_fault_counters(self) -> Tuple[int, int]:
        """Drain (transfer retries, timeouts) of both windows."""
        r1, t1 = self._window.take_fault_counters()
        r2, t2 = self._expert_window.take_fault_counters()
        return r1 + r2, t1 + t2

    def take_expert_counters(self) -> Dict[str, int]:
        """Drain the predictive counters: ``pred_hits`` (the expert was
        staged by the prediction), ``pred_misses`` (fetched on demand),
        ``lru_hits`` (served from the LRU, no copy)."""
        out = dict(self._expert_counters)
        out["lru_bytes_used"] = int(self._lru_used)
        for k in self._expert_counters:
            self._expert_counters[k] = 0
        return out
