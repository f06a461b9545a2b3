"""Paged, host-tiered KV cache: the page table the engine keeps its KV in.

The paper's Eq. 2 admission lets tokens accumulate in host memory with
only the working set on the device, but a monolithic ``(B, max_seq)`` KV
buffer pins every sequence's whole extent on the device.  This module
pages the KV cache into ``page_tokens``-slot frames behind a
``KVPageTable`` that owns the slot-to-frame map and the free lists:

* **Mode A (every frame on the device).**  With no device budget, or one
  that covers every frame, the table is bookkeeping only: the engine keeps
  its contiguous per-layer buffers and its fused decode graph, bit for bit.
* **Mode B (a host tier).**  A budget of ``P`` frames makes a device pool
  of ``P + 1`` frames per attention layer (the last is the null frame, a
  sink no live row reads) and puts the other frames in page-locked host
  memory, one flat K-then-V buffer per attention layer.  Decode runs per
  module: each layer's host frames are copied to the device through a
  ``serving.weights.StreamWindow`` (prefetched a layer ahead on the copy
  stream that weights use), and the paged decode-attention kernel (K3p)
  reads each device row's slots through the page table, from the pool or
  from the window's copy, in place.  Host-attention rows (omega) prefer
  host frames, device rows device frames; either tier spills into the
  other.

A layer's epoch advances with every write to its host frames and every
admission or eviction; a prefetch issued under an older epoch is stale
when it is acquired and is copied again, on demand, and counted as such.

Faults (``repro_torch.faults``): allocation is transactional per row and an
armed plan may inject a ``PageAllocOOM`` at each new row; under memory
pressure the server's degradation ladder demotes live device frames to free
host frames (``demote_device_frames``).

On top of the page table, ``PrefixStore`` caches shared prompt prefixes at
page granularity: a hit's stored prefix KV is copied into its row and only
the suffix is prefilled (``ModuleBatchingEngine.prefill_prefix_hit``).
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import faults
from repro_torch.analysis import runtime as sanitizer
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.faults import PageAllocOOM
from repro_torch.serving.weights import StreamWindow, _HostBuffer, copy_stream

WINDOW_DEPTH = 2        # layers of host frames in flight: the next one and this one
PREFIX_ENTRIES = 64     # prefixes the server's PrefixStore keeps (LRU)


class SlotTargets(NamedTuple):
    """Where each of a micro-batch's decode slots is written (``KVPageTable
    .slot_targets``): the positions (into its rows) whose written page is a
    device frame and their flat slots in the layer's pool (frame x
    page_tokens + offset), then those whose page is a host frame and their
    flat slots among the host frames -- the same index in the host pool and
    in the window's copy of it.  Unallocated pages are in neither."""

    pool_i: np.ndarray
    pool_flat: np.ndarray
    host_i: np.ndarray
    host_flat: np.ndarray


def copy_rows_to_host(dst: torch.Tensor, dst_idx: Sequence[int], src: torch.Tensor,
                      src_idx: Sequence[int]) -> None:
    """``dst[dst_idx[j]] = src[src_idx[j]]``, from the device into host memory:
    one copy per run of consecutive indices in both (straight into
    page-locked memory, without a pageable bounce), then one wait for them."""
    n, j = len(dst_idx), 0
    while j < n:
        e = j + 1
        while e < n and dst_idx[e] == dst_idx[e - 1] + 1 and src_idx[e] == src_idx[e - 1] + 1:
            e += 1
        dst[dst_idx[j]:dst_idx[j] + e - j].copy_(src[src_idx[j]:src_idx[j] + e - j],
                                                 non_blocking=True)
        j = e
    if src.device.type == "cuda":
        torch.cuda.current_stream(src.device).synchronize()


@dataclass(frozen=True)
class CacheConfig:
    """Cache-side knobs.  ``page_tokens=0`` keeps the contiguous cache;
    ``device_pool_bytes=None`` keeps every frame on the device (Mode A), a
    finite budget sizes the device pool and puts the rest on the host
    (Mode B).  Mode B always prefetches each layer's host frames a layer
    ahead, through a window of ``WINDOW_DEPTH`` layers.  ``prefix_cache``
    enables the ``PrefixStore`` of ``PREFIX_ENTRIES`` prefixes (requires
    ``page_tokens > 0``: prefixes are keyed at page granularity)."""

    page_tokens: int = 0
    device_pool_bytes: Optional[float] = None
    prefix_cache: bool = False

    def __post_init__(self) -> None:
        assert self.page_tokens >= 0, self.page_tokens
        if self.prefix_cache:
            assert self.page_tokens > 0, (
                "prefix_cache requires paging (page_tokens > 0): prefixes "
                "are shared at page granularity"
            )

    @property
    def enabled(self) -> bool:
        return self.page_tokens > 0


class KVPageTable:
    """Slot-to-frame map, free lists and the tiered page pools.

    One table serves every attention layer: ``page_map`` (batch,
    pages_per_seq) is shared -- a row's page i is the same frame id in
    every layer -- while each layer has its own pool buffers.  Frame ids:
    -1 free; ``[0, P)`` device frame f; ``P + h`` host frame h.  Device
    pools hold one more frame, the null frame at index P.

    On a card the pools are device tensors and the host frames page-locked
    (``cudaHostRegister`` after they are filled); ``close()``, or dropping
    the table, frees both and unpins."""

    def __init__(self, cfg: ModelConfig, schema: Sequence[Tuple[str, str]], batch: int,
                 max_seq: int, cache_cfg: CacheConfig, device="cuda") -> None:
        assert cache_cfg.enabled, "KVPageTable requires page_tokens > 0"
        self.cfg = cfg
        self.cc = cache_cfg
        self.batch = batch
        self.device = resolve_device(device)
        self.attn_layers: List[int] = [li for li, (kind, _) in enumerate(schema)
                                       if kind == "attn"]
        self.n_layers = len(schema)
        sw = cfg.sliding_window
        self.span = min(max_seq, sw) if sw else max_seq
        pt = cache_cfg.page_tokens
        self.page_tokens = pt
        self.pages_per_seq = -(-self.span // pt)
        self.total_frames = batch * self.pages_per_seq
        K, hd = cfg.num_kv_heads, cfg.head_dim
        self.dtype = torch_dtype(cfg.dtype)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        # one frame across every attention layer, K and V
        self.frame_bytes = len(self.attn_layers) * 2 * pt * K * hd * itemsize
        budget = cache_cfg.device_pool_bytes
        if budget is None:
            self.device_frames = self.total_frames
        else:
            self.device_frames = max(0, min(self.total_frames,
                                            int(budget // max(1, self.frame_bytes))))
        self.host_frames = self.total_frames - self.device_frames
        self.pool_k: Dict[int, torch.Tensor] = {}
        self.pool_v: Dict[int, torch.Tensor] = {}
        self.host_k: Dict[int, torch.Tensor] = {}
        self.host_v: Dict[int, torch.Tensor] = {}
        self._host: Dict[int, _HostBuffer] = {}
        self._window: Optional[StreamWindow] = None
        self._epoch: Dict[int, int] = {}
        self.dtoh_bytes = 0
        self.reset()
        if self.fully_resident:
            return
        P, Hf = self.device_frames, self.host_frames
        frame = (pt, K, hd)
        layer_bytes = 2 * Hf * pt * K * hd * itemsize
        for li in self.attn_layers:
            self.pool_k[li] = torch.zeros((P + 1,) + frame, dtype=self.dtype, device=self.device)
            self.pool_v[li] = torch.zeros_like(self.pool_k[li])
            buf = _HostBuffer(layer_bytes)
            buf.tensor.zero_()
            if self.device.type == "cuda":
                buf.pin()
            flat = buf.tensor.view(self.dtype)
            self.host_k[li] = flat[:flat.numel() // 2].view((Hf,) + frame)
            self.host_v[li] = flat[flat.numel() // 2:].view((Hf,) + frame)
            self._host[li] = buf
            self._epoch[li] = 0
        # the fetch closes over the host buffers and the epochs, not the
        # table: a table <-> window cycle would outlive ``del`` until a gc
        hosts, epochs, dtype = self._host, self._epoch, self.dtype

        def fetch(li: int, slot: torch.Tensor):
            """One copy of layer ``li``'s host frames, stamped with the
            layer's epoch when it was issued."""
            slot.copy_(hosts[li].tensor, non_blocking=True)
            flat = slot.view(dtype)
            half = flat.numel() // 2
            return ((epochs[li], flat[:half].view((Hf,) + frame),
                     flat[half:].view((Hf,) + frame)), layer_bytes)

        self._window = StreamWindow(fetch, lambda li: layer_bytes, layer_bytes, self.device,
                                    depth=WINDOW_DEPTH)
        self._closed = False

    # -- residency -------------------------------------------------------
    @property
    def fully_resident(self) -> bool:
        """Every frame fits the device pool (Mode A): with a resident store,
        the engine's fused decode graph stays eligible."""
        return self.host_frames == 0

    def device_pool_bytes(self) -> int:
        if self.fully_resident:
            return self.total_frames * self.frame_bytes
        return (self.device_frames + 1) * self.frame_bytes

    def host_pool_bytes(self) -> int:
        return self.host_frames * self.frame_bytes

    def describe(self) -> str:
        live = int((self.page_map >= 0).sum())
        host_live = int((self.page_map >= self.device_frames).sum())
        return (f"pages {self.page_tokens} tok x {self.pages_per_seq}/seq: "
                f"{self.device_frames}/{self.total_frames} frames device "
                f"({self.device_pool_bytes() / 1e9:.3f}GB), {self.host_frames} host "
                f"({self.host_pool_bytes() / 1e9:.3f}GB), live={live} (host {host_live})")

    # -- allocation ------------------------------------------------------
    def reset(self) -> None:
        """Every row free, the free lists in their first order."""
        self.page_map = np.full((self.batch, self.pages_per_seq), -1, np.int32)
        self._free_dev: List[int] = list(range(self.device_frames))[::-1]
        self._free_host: List[int] = list(range(self.host_frames))[::-1]
        self._bump_all()

    def _alloc_frame(self, prefer_host: bool) -> int:
        a, b = ((self._free_host, self._free_dev) if prefer_host
                else (self._free_dev, self._free_host))
        if a:
            f = a.pop()
            return self.device_frames + f if prefer_host else f
        if not b:
            raise PageAllocOOM("page table out of frames (batch rows exceed capacity?)")
        f = b.pop()
        return f if prefer_host else self.device_frames + f

    def ensure_rows(self, rows: Sequence[int],
                    prefer_host: Optional[Sequence[bool]] = None) -> None:
        """Allocate frames for ``rows`` (a row already allocated keeps its
        placement).  ``prefer_host[i]`` biases row i toward the host tier.
        Per row transactional: on ``PageAllocOOM`` (both tiers out of frames,
        or one the armed fault plan injects before a new row) the row's
        frames go back before the error propagates."""
        for i, r in enumerate(rows):
            if self.page_map[r, 0] >= 0:
                continue
            fp = faults.current()
            if fp is not None and fp.page_oom():
                raise PageAllocOOM(f"injected page-alloc OOM (row {r})")
            ph = bool(prefer_host[i]) if prefer_host is not None else False
            try:
                for pp in range(self.pages_per_seq):
                    self.page_map[r, pp] = self._alloc_frame(ph)
            except PageAllocOOM:
                self.free_rows([r])
                raise
        self._bump_all()

    def free_rows(self, rows: Sequence[int]) -> None:
        """Return ``rows``' frames to the free lists (slot recycling)."""
        for r in rows:
            for pp in range(self.pages_per_seq):
                f = int(self.page_map[r, pp])
                if f < 0:
                    continue
                if f < self.device_frames:
                    self._free_dev.append(f)
                else:
                    self._free_host.append(f - self.device_frames)
                self.page_map[r, pp] = -1
        self._bump_all()

    def _bump_all(self) -> None:
        for li in self._epoch:
            self._epoch[li] += 1

    # -- page content (Mode B) -------------------------------------------
    def _host_write_guard(self, li: int) -> None:
        """Before the host writes layer ``li``'s host frames: wait for any
        queued copy that still reads them (a planned host wait,
        ``paged-host-writeback``)."""
        if self._window is not None:
            with sanitizer.allowed("paged-host-writeback"):
                self._window.wait_copy(li)

    def _paged(self, aligned: torch.Tensor) -> torch.Tensor:
        """(n, span, K, hd) -> (n, pages_per_seq, page_tokens, K, hd)."""
        n, span = aligned.shape[:2]
        full = self.pages_per_seq * self.page_tokens
        if full > span:
            pad = torch.zeros((n, full - span) + tuple(aligned.shape[2:]),
                              dtype=aligned.dtype, device=aligned.device)
            aligned = torch.cat([aligned, pad], dim=1)
        return aligned.reshape((n, self.pages_per_seq, self.page_tokens)
                               + tuple(aligned.shape[2:]))

    def insert_rows(self, li: int, nk: torch.Tensor, nv: torch.Tensor,
                    rows: Sequence[int]) -> None:
        """Write span-aligned KV (n, span, K, hd) into ``rows``' pages of
        layer ``li``, the whole row (admission): device pages by one copy
        on the device, host pages by one device-to-host copy (counted in
        ``dtoh_bytes``).  Mode A: nothing (the engine's buffers hold it)."""
        if self.fully_resident:
            return
        pk, pv = self._paged(nk), self._paged(nv)
        dev_f, dev_i, host_f, host_i = [], [], [], []
        for i, r in enumerate(rows):
            for pp in range(self.pages_per_seq):
                f = int(self.page_map[r, pp])
                assert f >= 0, (r, pp)
                if f < self.device_frames:
                    dev_f.append(f)
                    dev_i.append(i * self.pages_per_seq + pp)
                else:
                    host_f.append(f - self.device_frames)
                    host_i.append(i * self.pages_per_seq + pp)
        flat_k = pk.reshape((-1,) + tuple(pk.shape[2:]))
        flat_v = pv.reshape((-1,) + tuple(pv.shape[2:]))
        if dev_f:
            dst = torch.as_tensor(dev_f, device=self.device)
            src = torch.as_tensor(dev_i, device=nk.device)
            self.pool_k[li].index_copy_(0, dst, flat_k.index_select(0, src))
            self.pool_v[li].index_copy_(0, dst, flat_v.index_select(0, src))
        if host_f:
            self._host_write_guard(li)
            copy_rows_to_host(self.host_k[li], host_f, flat_k, host_i)
            copy_rows_to_host(self.host_v[li], host_f, flat_v, host_i)
            self.dtoh_bytes += 2 * len(host_f) * flat_k[0].numel() * flat_k.element_size()
        self._epoch[li] += 1

    def write_host_slots(self, li: int, host_flat: np.ndarray, k_new: torch.Tensor,
                         v_new: torch.Tensor) -> None:
        """Decode slots written into layer ``li``'s host frames: row j of the
        host CPU tensors (n, K, hd) at flat host slot ``host_flat[j]``
        (``SlotTargets.host_flat``); counted in ``dtoh_bytes``."""
        if not len(host_flat):
            return
        self._host_write_guard(li)
        idx = torch.as_tensor(np.asarray(host_flat, np.int64))
        for pool, new in ((self.host_k[li], k_new), (self.host_v[li], v_new)):
            pool.view((-1,) + tuple(pool.shape[2:]))[idx] = new.to(self.dtype)
        self.dtoh_bytes += (k_new.numel() * k_new.element_size()
                            + v_new.numel() * v_new.element_size())
        self._epoch[li] += 1

    def read_rows(self, li: int, rows: Sequence[int], n: int) -> Tuple[torch.Tensor,
                                                                        torch.Tensor]:
        """The first ``n`` slots of ``rows``' layer-``li`` KV as host tensors
        (len(rows), n, K, hd).  Pages on device frames come down in one
        device-to-host copy (counted in ``dtoh_bytes``; the caller plans the
        read), host frames are read in place."""
        pt, P = self.page_tokens, self.device_frames
        K, hd = self.cfg.num_kv_heads, self.cfg.head_dim
        npg = -(-n // pt)
        f = self.page_map[np.asarray(rows, np.int64)][:, :npg].reshape(-1)
        out_k = torch.zeros((f.size, pt, K, hd), dtype=self.dtype)
        out_v = torch.zeros_like(out_k)
        host = np.flatnonzero(f >= P)
        if host.size:
            at, h = torch.as_tensor(host), torch.as_tensor(f[host] - P, dtype=torch.long)
            out_k[at] = self.host_k[li].index_select(0, h)
            out_v[at] = self.host_v[li].index_select(0, h)
        dev = np.flatnonzero((f >= 0) & (f < P))
        if dev.size:
            idx = torch.as_tensor(f[dev], dtype=torch.long, device=self.device)
            pages = torch.stack([self.pool_k[li].index_select(0, idx),
                                 self.pool_v[li].index_select(0, idx)]).cpu()
            self.dtoh_bytes += pages.numel() * pages.element_size()
            at = torch.as_tensor(dev)
            out_k[at] = pages[0]
            out_v[at] = pages[1]
        flat = (len(rows), npg * pt, K, hd)
        return out_k.view(flat)[:, :n], out_v.view(flat)[:, :n]

    def device_frames_of(self, rows: Sequence[int], n: int) -> bool:
        """Whether any of the first ``n`` slots of ``rows`` is on a device
        frame (then ``read_rows`` reads the device)."""
        pages = -(-n // self.page_tokens)
        f = self.page_map[np.asarray(rows, np.int64)][:, :pages]
        return bool(((f >= 0) & (f < self.device_frames)).any())

    # -- decode-time plumbing (Mode B) -----------------------------------
    def gather_indices(self, rows: Sequence[int]) -> np.ndarray:
        """Frame ids of ``rows`` in K3p's index space over the device pool
        (P + 1 frames, the null one included) then the window's host
        frames: device frame f -> f, host frame h -> P + 1 + h, an
        unallocated page -> the null frame P (a dead row reads inert
        values that its mask or the caller discards)."""
        P = self.device_frames
        f = self.page_map[np.asarray(rows, np.int64)]
        return np.where(f < 0, P, np.where(f < P, f, f + 1)).astype(np.int32)

    def slot_targets(self, rows: Sequence[int], slot: np.ndarray) -> SlotTargets:
        """Where decode slot ``slot[i]`` of each row ``rows[i]`` is written
        this tick: the tier of its page and its flat slot there."""
        pt, P = self.page_tokens, self.device_frames
        slot = np.asarray(slot, np.int64)
        f = self.page_map[np.asarray(rows, np.int64), slot // pt].astype(np.int64)
        pool_i = np.flatnonzero((f >= 0) & (f < P))
        host_i = np.flatnonzero(f >= P)
        return SlotTargets(pool_i, f[pool_i] * pt + slot[pool_i] % pt,
                           host_i, (f[host_i] - P) * pt + slot[host_i] % pt)

    def prefetch(self, li: int) -> None:
        """Issue layer ``li``'s host-frame copy a layer ahead (the engine
        calls it beside the weights' prefetch, before the FFN).  Nothing in
        Mode A or for a layer without attention."""
        if self._window is None:
            return
        li = li % max(1, self.n_layers)
        if li in self._epoch:
            self._window.prefetch(li)

    def acquire(self, li: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Layer ``li``'s host frames on the device, (Hf, pt, K, hd) each:
        the prefetched copy, or one fetched on demand; a copy issued before
        the layer's last host write, admission or eviction is stale and is
        copied again (a demand fetch).  The compute stream waits for the
        copy; the host does not."""
        assert self._window is not None
        epoch, k, v = self._window.acquire(li)
        if epoch != self._epoch[li]:
            epoch, k, v = self._window.refetch(li)
        return k, v

    # -- memory-pressure degradation --------------------------------------
    def demote_device_frames(self, limit: int) -> int:
        """Move up to ``limit`` live device frames to free host frames (the
        degradation ladder's second stage), highest row and page first, as
        the reference picks them.  Each frame of every attention layer is
        copied device to host on the copy stream, behind the compute
        stream's queued work, into page-locked host frames (counted in
        ``dtoh_bytes``), in an ``allowed("paged-host-writeback")`` scope; the
        host then waits for the copies once (admission time, never inside a
        tick) before the device frames are handed out again.  Mode A has no
        host tier and moves nothing.  Placement only: tokens do not change.
        Returns the frames moved."""
        if self._window is None or limit <= 0:
            return 0
        moves = []                               # (row, page, device f, host h)
        for r in reversed(range(self.batch)):
            for pp in reversed(range(self.pages_per_seq)):
                if len(moves) >= limit or not self._free_host:
                    break
                f = int(self.page_map[r, pp])
                if 0 <= f < self.device_frames:
                    moves.append((r, pp, f, self._free_host.pop()))
            if len(moves) >= limit or not self._free_host:
                break
        if not moves:
            return 0
        cuda = self.device.type == "cuda"
        for li in self.attn_layers:
            self._host_write_guard(li)
        with sanitizer.allowed("paged-host-writeback"):
            stream = copy_stream(self.device) if cuda else None
            if cuda:
                stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
                for li in self.attn_layers:
                    for _, _, f, h in moves:
                        self.host_k[li][h].copy_(self.pool_k[li][f], non_blocking=True)
                        self.host_v[li][h].copy_(self.pool_v[li][f], non_blocking=True)
            if cuda:
                stream.synchronize()
        for r, pp, f, h in moves:
            self.page_map[r, pp] = self.device_frames + h
            self._free_dev.append(f)
        self.dtoh_bytes += len(moves) * self.frame_bytes
        faults.note("recovered:page-demotion", len(moves))
        self._bump_all()
        return len(moves)

    # -- accounting and teardown ----------------------------------------
    @property
    def copied_bytes(self) -> int:
        """Bytes of the host-frame copies really queued."""
        return 0 if self._window is None else self._window.copied_bytes

    @property
    def demand_fetches(self) -> int:
        return 0 if self._window is None else self._window.demand

    def take_counters(self) -> Tuple[int, int, float]:
        """Drain (htod_bytes, dtoh_bytes, stream_wait_s) since the last call."""
        htod, wait = (self._window.take_counters() if self._window is not None
                      else (0, 0.0))
        dtoh, self.dtoh_bytes = self.dtoh_bytes, 0
        return htod, dtoh, wait

    def take_fault_counters(self) -> Tuple[int, int]:
        """Drain (transfer retries, timeouts) of the host-frame window."""
        return (0, 0) if self._window is None else self._window.take_fault_counters()

    def close(self) -> None:
        """Free the pools and the window's slots and unpin the host frames.
        The host waits for the copy stream first: a queued copy may still
        read the host frames."""
        if getattr(self, "_closed", True):
            return
        self._closed = True
        if self.device.type == "cuda":
            copy_stream(self.device).synchronize()
        self._window.close()
        self.pool_k.clear()
        self.pool_v.clear()
        self.host_k.clear()
        self.host_v.clear()
        self._host.clear()

    def __del__(self) -> None:
        self.close()


class PrefixStore:
    """LRU prefix cache over page-aligned prompt prefixes.

    Keys are the exact prefix token bytes (no hash collisions by
    construction) at the largest page multiple strictly below the prompt
    length: at least one suffix token always remains, so a hit still
    produces the request's first-token logits through the engine's suffix
    prefill.  Values are per-attention-layer ``(k, v)`` tensors of the
    prefix span, (pspan, K, hd) each, in host memory (page-locked on a card,
    so that admission copies them up without a host wait); KV at position p
    depends only on tokens <= p, so copied rows are exactly what the full
    prefill would write.

    Restricted to all-attention models without a sliding window: SSM state
    and ring-aligned windows make a stored prefix non-transplantable."""

    def __init__(self, page_tokens: int, entries: int = PREFIX_ENTRIES) -> None:
        assert page_tokens > 0
        self.page_tokens = page_tokens
        self.entries = max(1, entries)
        self._store: "OrderedDict[bytes, List]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def supported(cfg: ModelConfig) -> bool:
        return cfg.sliding_window == 0 and all(
            cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))

    def key(self, prompt) -> Optional[Tuple[bytes, int]]:
        """(key bytes, prefix span) for ``prompt``, or None when no full
        page fits strictly inside it."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        pspan = ((len(prompt) - 1) // self.page_tokens) * self.page_tokens
        if pspan <= 0:
            return None
        return prompt[:pspan].tobytes(), pspan

    def touch(self, key: bytes) -> bool:
        """Whether ``key`` is stored; a stored key becomes the most recent,
        as ``put`` of a stored key makes it (so a caller can skip reading
        rows that ``put`` would drop)."""
        if key not in self._store:
            return False
        self._store.move_to_end(key)
        return True

    def get(self, key: bytes) -> Optional[List]:
        kvs = self._store.get(key)
        if kvs is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return kvs

    def put(self, key: bytes, kvs: List) -> None:
        if key in self._store:
            self._store.move_to_end(key)
            return
        self._store[key] = kvs
        while len(self._store) > self.entries:
            self._store.popitem(last=False)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0
