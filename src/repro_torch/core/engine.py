"""The MoE-Gen engine: executable module-based batching (paper §4.2).

Given a model's parameters and a ``Plan``, the engine runs generative
inference by launching per-module batched work:

* the attention module consumes micro-batches of ``b_a`` sequences; its
  decode mechanism is the hand-written decode-attention kernel, reading and
  writing the preallocated KV cache in place;
* an SSM (Mamba2) layer decodes all rows in one plain recurrent step that
  writes its ``h`` and ``conv`` state rows in place; its prefill runs the
  hand-written SSD chunked-scan kernel;
* the sparse-MoE stage runs as ONE grouped dispatch per MoE layer: routed
  tokens are gathered on device into an ``(E, C, D)`` capacity buffer
  (``C`` = the plan's per-expert budget ``b_e``), pushed through the
  hand-written grouped FFN kernels, and combined back weighted by their
  gates.  Routing never leaves the device, so a decode step issues no host
  sync; copies beyond capacity are dropped and counted per MoE layer;
* dense modules (LM head) run at full batch.

Decode runs in chunks of T ticks.  When ``fused_eligible()`` (fused decode
on, grouped experts, every weight resident), a chunk is the JAX package's
fused decode chunk: one tick body (embed, every layer, head, per-slot
sampling) whose carry -- tokens, positions, the live mask, the sampler's
keys and token indices, the drop and load counters -- lives in static
device buffers.  On a CUDA engine the tick is captured once per key as a
CUDA graph and replayed T times with no host read in between; one token
read per chunk.  On the CPU the same tick body runs eagerly T times.  The
per-module path (``fused_decode=False``) is the oracle: both give the same
tokens bit for bit, because the tick body calls the same module functions
in the same order.

Prefill is layer-major: each layer's weights are acquired once and reused
by every ``b_a`` micro-batch, and a grouped-prefill MoE layer is split into
a mixer+route launch and a grouped-FFN launch whose capacity is the next
power of two over the micro-batch's measured max expert load (one planned
host read per layer and micro-batch), so no routed copy drops at prefill.
Only positions below each row's length are routed there.

Cache ownership: the engine owns the per-layer KV buffers and SSM states;
decode, prefill insertion and eviction write them in place and their
``data_ptr()``s never change.  Callers never keep a reference across a tick.

Weight residency (the paper's S_Params / S_Expert, Fig. 6): every stage
reads its parameters through a ``serving.weights.ParamStore``.  With
``stream_weights`` the store keeps the plan's greedy resident set on the
device and the rest in page-locked host memory; the engine prefetches
layer *l+1*'s streamed modules after layer *l*'s mixer and before its FFN,
on the copy stream, so the copy hides behind the grouped expert GEMM.
With the plan's ``predict_topk`` > 0 a streamed MoE layer reads back one
packed vector (its used experts and the next streamed MoE layer's
predicted ones) -- the one planned host read of such a layer in a decode
tick, counted in ``EngineStats.planned_reads`` -- fetches only the
experts it uses and prefetches the predicted ones.  A streamed engine
decodes per module and captures no graph.  Streamed and resident engines
give the same tokens.

Host attention (the paper's omega split, §4.2 and §B): the first
``round(omega * B)`` rows of the batch run their attention mechanism on the
host CPU (``core.host_attention``).  Their norm, projections and rope run on
the device; q, k_new and v_new come down in one planned read a layer and
micro-batch, the slot is written into the host-resident KV and the CPU
attends; the output goes back up by one copy from page-locked memory and
``wo`` runs on the device.  With a contiguous cache those rows' KV lives in
a page-locked host buffer (n_host, span, K, hd) per attention layer, filled
by prefill and never read from the device.  A micro-batch that straddles
the boundary is split at it.  In a fused chunk the host rows run their T
ticks per module first, then the device rows replay the fused graph.

Paged KV (``serving.cache``, ``cache_config``): in Mode A the page table is
bookkeeping only and everything above holds bit for bit; in Mode B the KV
lives only in the table's pools, decode runs per module, each layer's host
frames are prefetched a layer ahead beside the weights, and the device rows
of a micro-batch run the paged decode-attention kernel (K3p) over the
device pool and the window's copy of the layer's host frames.

Prefix cache (``serving.cache.PrefixStore``): ``read_prefix_rows`` copies a
freshly prefilled row's prefix KV into page-locked host memory in one
planned read, and ``prefill_prefix_hit`` admits a hit by uploading the
stored prefix (one asynchronous copy a layer) and prefilling only the
suffix, its queries at absolute positions against prefix and suffix keys
(K4 with a query offset).  ``set_expert_capacity`` overrides the plan's
``b_e`` (the server's online re-plan); a new capacity captures one new
decode graph.

Preemption (``checkpoint_slot`` / ``restore_slot``): a row's KV and SSM
state go to page-locked host memory and come back into a free row in place,
so the captured graphs stay valid and a resume runs no prefill.

Analysis (``repro_torch.analysis``): ``decode_step`` and ``decode_chunk``
run inside a sanitizer ``decode_region``; every planned host read is an
``allowed`` scope with a tag (and, on the decode path, counted in
``EngineStats.planned_reads``); each graph capture adds its key to the
``graph_keys`` registry set; under ``sanitize(pointers=True)`` every tick
holds the cache, page pools and carries to their addresses, and under
``poison=True`` a dropped cache is filled with NaN.

Expert parallelism (``sctx``, ``distributed.ep_engine``): the engine is one
rank of a ``torch.distributed`` group whose MoE decode stage is collective;
it decodes per module.

The oracles: ``expert_path='loop'`` decodes the MoE stage as the reference's
sequential per-expert loop (``_expert_stage_loop``: the routing read to the
host in one planned ``expert-loop-oracle`` read a layer and tick, then one
chain of ``torch.matmul`` products per expert and chunk of ``b_e`` rows, no
kernel); a loop engine decodes per module and captures no graph.
``grouped_prefill=False`` prefills a MoE layer through the exact
dense-combine reference (``blocks.layer_forward``), with no capacity probe.
``frontend_emb`` (a modality frontend's embeddings) replaces the first
positions' token embeddings of ``prefill``, ``prefill_slots`` and
``generate``, per micro-batch.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis import donation
from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.analysis.registry import TraceKeySet
from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import Plan
from repro_torch.core.host_attention import (
    host_decode_attention,
    host_decode_attention_heads,
    round_bf16,
    to_heads,
)
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.distributed.ep_engine import ep_expert_stage, validate_ep_shard
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import reserve_tickets
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ffn_apply, init_layer_cache, layer_forward, mixer_forward
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import head
from repro_torch.serving.cache import CacheConfig, KVPageTable, copy_rows_to_host
from repro_torch.serving.kvcache import aligned_kv, evict_rows, insert_prefill_rows
from repro_torch.serving.sampling import BatchSampler, greedy, sample_tokens
from repro_torch.serving.weights import ParamStore, _HostBuffer
from repro_torch.sharding.specs import ShardCtx

@dataclass
class EngineStats:
    attn_microbatches: int = 0
    expert_launches: int = 0             # grouped: one per MoE layer per step;
    #                                      loop: one per expert and chunk
    expert_tokens: int = 0               # routed token-copies processed
    expert_tokens_dropped: int = 0       # routed copies over the b_e capacity
    device_attn_tokens: int = 0
    host_attn_tokens: int = 0            # rows x attention layers on the host
    host_attn_s: float = 0.0             # host CPU seconds in the mechanism
    expert_tokens_dropped_by_layer: Optional[np.ndarray] = None
    #                                      (n_moe,) int64 per-MoE-layer drops
    expert_load: Optional[np.ndarray] = None
    #                                      (n_moe, E) int64 routed-copy
    #                                      histogram (pre-capacity)
    fused_dispatches: int = 0            # fused decode chunks issued
    fused_ticks: int = 0                 # decode ticks served by fused chunks
    decode_retraces: int = 0             # distinct fused (B, path, chunk) keys
    weight_htod_bytes: int = 0           # streamed weight bytes copied htod
    prefetch_wait_s: float = 0.0         # compute stream's wait on the copies
    prefetch_issued: int = 0             # prefetches issued (store total)
    demand_fetches: int = 0              # fetches on demand (store total)
    expert_pred_hits: int = 0            # routed experts found prefetched
    expert_pred_misses: int = 0          # routed experts fetched on demand
    expert_lru_hits: int = 0             # routed experts served from the LRU
    expert_lru_bytes: int = 0            # device bytes the LRU holds
    planned_reads: int = 0               # planned host reads of decode
    kv_htod_bytes: int = 0               # host KV frames copied to the device
    kv_dtoh_bytes: int = 0               # KV pages written to the host tier
    transfer_retries: int = 0            # injected copy failures retried
    transfer_timeouts: int = 0           # dead copies recovered by re-fetch
    a2a_bytes: int = 0                   # bytes the expert-parallel MoE stage
    #                                      exchanged (a2a dispatch + return)
    collective_dispatches: int = 0       # expert-parallel MoE stages run


# one side stream per device on which every engine warms up and captures
# its decode graphs: cuBLAS keeps a workspace per (handle, stream) for the
# life of the process, so a stream per engine would leave one per engine
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}
_SERIALS = itertools.count()     # engine ids of the sanitizer's pointer book


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream decode graphs are captured on, for ``device``."""
    if device.index is None:                   # "cuda" and "cuda:0": one stream
        device = torch.device(device.type, torch.cuda.current_device())
    s = _CAPTURE_STREAMS.get(device)
    if s is None:
        s = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return s


class PrefixRows(list):
    """A captured prefix: per attention layer ``(k, v)`` (pspan, K, hd), as
    views of ``pairs`` (layers, 2, pspan, K, hd), which lies in ``host`` (a
    page-locked ``_HostBuffer`` on a card, kept alive with the rows)."""

    def __init__(self, pairs: torch.Tensor, host: _HostBuffer) -> None:
        super().__init__((pairs[li, 0], pairs[li, 1]) for li in range(pairs.shape[0]))
        self.pairs = pairs
        self.host = host


class SlotCheckpoint:
    """A preempted row's decode state in (pageable) host memory:
    ``layers[li]`` is an attention layer's ``{"k", "v"}`` (span, K, hd) or
    an SSM layer's ``{"h", "conv"}`` row.  (Page-locking a fresh buffer a
    preemption, 478 MB for an OLMoE row at span 3648, took longer than its
    copies on an H100: PERF.md.)"""

    def __init__(self, layers: List[Dict[str, torch.Tensor]]) -> None:
        self.layers = layers

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for layer in self.layers
                   for t in layer.values())


@dataclass
class _Carry:
    """A fused chunk's carry for n rows, in static buffers whose addresses
    the captured graphs hold: ``state`` (n, 8) int64 with columns token,
    position, live (0/1), token index (the sampler's step), top-k, the two
    key words, and in row 0 the tick within the chunk; ``temps`` (n,)
    float32; ``out`` (n, width) int64, column t the tokens tick t sampled."""

    state: torch.Tensor
    temps: torch.Tensor
    out: torch.Tensor

    @classmethod
    def zeros(cls, n: int, width: int, device: torch.device) -> "_Carry":
        return cls(torch.zeros((n, 8), dtype=torch.long, device=device),
                   torch.zeros((n,), dtype=torch.float32, device=device),
                   torch.zeros((n, width), dtype=torch.long, device=device))

    def clone(self) -> "_Carry":
        return _Carry(self.state.clone(), self.temps.clone(), self.out.clone())


class ModuleBatchingEngine:
    """Executes a batching ``Plan`` over a real model on ``device``.

    ``expert_path`` selects the MoE decode stage: ``'grouped'`` (default),
    one grouped-dispatch launch per MoE layer with capacity ``plan.b_e``, or
    ``'loop'``, the reference's sequential per-expert loop kept as the
    numerical oracle (a planned host read of the routing per MoE layer and
    tick; never fused).  ``grouped_prefill`` (default True) runs a prefill
    MoE layer through the grouped dispatch at a zero-drop capacity; False,
    through the exact dense-combine reference.  The two are independent, so
    a loop engine shares the grouped prefill by default.

    ``stream_weights``, ``resident_bytes`` and ``prefetch`` go to
    ``ParamStore.build`` (predictive streaming follows the plan's
    ``predict_topk``), or pass a built ``store`` (``params`` may then be
    None).  ``cache_config`` (``serving.cache.CacheConfig``) pages the KV
    cache.  ``plan.omega`` sends the first ``round(omega * B)`` rows'
    attention to the host.  ``predictor`` is a test seam: a callable
    ``(next layer, khat) -> expert ids`` that replaces the device's
    prediction for what to prefetch, never what is computed.

    ``sctx`` (``sharding.specs.ShardCtx`` naming a ``torch.distributed``
    group, ``moe_dispatch`` 'a2a' or 'psum') makes the engine one rank of an
    expert-parallel group: its MoE decode stage is the collective one of
    ``distributed.ep_engine`` (``ep_chunks`` pipeline chunks, ``ep_serial``
    waiting for each exchange before posting the next), counted in
    ``EngineStats.a2a_bytes`` and ``collective_dispatches``; prefill and
    everything else stay the single-device path, and such an engine always
    decodes per module.  Without a group the engine is the single-device
    one.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict,
        plan: Plan,
        max_seq: int = 512,
        expert_path: str = "grouped",
        grouped_prefill: bool = True,
        store: Optional[ParamStore] = None,
        stream_weights: bool = False,
        resident_bytes: Optional[float] = None,
        cache_config: Optional[CacheConfig] = None,
        device="cuda",
        fused_decode: bool = True,
        prefetch: bool = True,
        sctx: Optional[ShardCtx] = None,
        ep_chunks: int = 1,
        ep_serial: bool = False,
    ) -> None:
        assert expert_path in ("grouped", "loop"), expert_path
        # an expert-parallel rank: the reference's construction checks,
        # before anything is built
        self.sctx = sctx if sctx is not None and sctx.group is not None else None
        self.ep_chunks = max(1, int(ep_chunks))
        self.ep_serial = bool(ep_serial)
        if self.sctx is not None:
            validate_ep_shard(cfg, self.sctx)
            if expert_path != "grouped":
                raise ValueError(
                    "a ShardCtx replaces the grouped MoE stage with the collective "
                    "dispatch; expert_path='loop' is single-device only")
            if self.sctx.moe_dispatch == "a2a" and plan.predict_topk > 0:
                raise ValueError(
                    "moe_dispatch='a2a' does not compose with predictive per-expert "
                    "streaming (predict_topk > 0): the a2a stage needs every rank's "
                    "expert shard resident")
            if stream_weights:
                raise ValueError(
                    "stream_weights does not compose with a ShardCtx: the collective "
                    "stage needs resident expert shards")
        self.device = resolve_device(device)
        self.expert_path = expert_path
        self.grouped_prefill = grouped_prefill
        self.cfg = cfg
        self.plan = plan
        self.max_seq = max_seq
        self.fused_decode = fused_decode
        self.cache_config = cache_config
        if store is None:
            store = ParamStore.build(
                cfg, params, plan, stream_weights=stream_weights,
                resident_bytes=resident_bytes, prefetch=prefetch, device=self.device,
            )
        self.store = store
        if self.sctx is not None and not store.fully_resident:
            raise ValueError(
                "a ShardCtx needs a fully resident ParamStore: the collective MoE "
                "stage shards whole expert stacks over the group and cannot stream them")
        self.predictor = None
        self.schema = store.schema                  # [(kind, ffn)] per layer
        self.cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self._batch = 0                             # rows of the cache
        self.pages: Optional[KVPageTable] = None
        # contiguous cache with omega > 0: the host rows' KV per attention
        # layer on the host, in the mechanism's layout (n_host, K, span, hd)
        # f32 of bf16 values, and the page-locked buffers behind it and
        # behind the host output's upload
        self._host_kv: Dict[int, Dict[str, torch.Tensor]] = {}
        self._host_bufs: Dict[str, _HostBuffer] = {}
        self.stats = EngineStats()
        # device-side counters, folded into `stats` by sync_stats(): drops and
        # routed-load histograms accumulate per MoE layer without a host sync
        self._moe_layers = [li for li, (_, f) in enumerate(self.schema)
                            if f == "moe"]
        self._moe_index = {li: j for j, li in enumerate(self._moe_layers)}
        self._n_attn = sum(1 for kind, _ in self.schema if kind == "attn")
        # static buffers (the decode graphs add to them in place)
        dev, n_moe = self.device, len(self._moe_layers)
        E = max(1, self.cfg.num_experts)
        self._kept_dev = torch.zeros((), dtype=torch.int32, device=dev)
        self._dropped_dev = torch.zeros((n_moe,), dtype=torch.int32, device=dev)
        self._load_dev = torch.zeros((n_moe, E), dtype=torch.int32, device=dev)
        # fused decode: reference keys seen, carries by row count, graphs by
        # key (all in one private memory pool that dies with the engine),
        # and one record per capture (key, seconds, pool bytes, launches)
        self._fused_keys: set = set()
        self._carries: Dict[int, _Carry] = {}
        self._graphs: Dict[Tuple, Tuple["torch.cuda.CUDAGraph", Dict[str, int]]] = {}
        self._pool: Optional[Tuple[int, int]] = None
        self.graph_captures: List[Dict] = []
        # the registry's record of captured graph keys (a key whose graph is
        # dropped is discarded, so capturing it again counts again)
        self.graph_keys = TraceKeySet("engine.decode_graphs")
        self._b_e_override: Optional[int] = None
        # the sanitizer's pointer check: this engine's id, and an epoch that
        # advances where the engine itself reallocates what the graphs hold
        self._serial = next(_SERIALS)
        self._alloc_epoch = 0

    def _expert_capacity(self, batch: int) -> int:
        """Per-expert capacity C: the plan's b_e (or the online re-plan's
        override), clamped to the most tokens one expert can receive (top-k
        ids are distinct per token)."""
        b_e = self.plan.b_e if self._b_e_override is None else self._b_e_override
        return max(1, min(b_e, batch))

    def set_expert_capacity(self, b_e: Optional[int]) -> None:
        """The online capacity re-plan's entry point: override the plan's
        ``b_e`` for later decode dispatches; ``None`` restores the plan's.
        Capacity is part of the decode graph's key, so a new capacity
        captures one new graph (``graph_captures``) and the old one stays
        valid for a return to the old capacity."""
        self._b_e_override = None if b_e is None else max(1, int(b_e))

    def sync_stats(self, planned: bool = False) -> EngineStats:
        """Materialize the device-side expert counters (one host read of
        one packed vector) and drain the store's transfer and prediction
        counters.  ``planned``: the read is one the decode path plans (the
        server's re-plan check), made in an ``allowed("replan-counters")``
        scope and counted in ``stats.planned_reads``."""
        n_moe = len(self._moe_layers)
        packed = torch.cat([self._kept_dev.reshape(1), self._dropped_dev,
                            self._load_dev.reshape(-1)])
        with sanitizer.allowed("replan-counters") if planned else contextlib.nullcontext():
            host = packed.cpu().numpy().astype(np.int64)
        if planned:
            self.stats.planned_reads += 1
        self.stats.expert_tokens += int(host[0])
        if n_moe:
            dropped = host[1:1 + n_moe]
            load = host[1 + n_moe:].reshape(self._load_dev.shape)
            self.stats.expert_tokens_dropped += int(dropped.sum())
            if self.stats.expert_tokens_dropped_by_layer is None:
                self.stats.expert_tokens_dropped_by_layer = np.zeros(n_moe, np.int64)
                self.stats.expert_load = np.zeros_like(load)
            self.stats.expert_tokens_dropped_by_layer += dropped
            self.stats.expert_load += load
        for t in (self._kept_dev, self._dropped_dev, self._load_dev):
            t.zero_()
        htod, wait = self.store.take_counters()
        self.stats.weight_htod_bytes += htod
        self.stats.prefetch_wait_s += wait
        self.stats.prefetch_issued = self.store.prefetch_issued
        self.stats.demand_fetches = self.store.demand_fetches
        ec = self.store.take_expert_counters()
        self.stats.expert_pred_hits += ec["pred_hits"]
        self.stats.expert_pred_misses += ec["pred_misses"]
        self.stats.expert_lru_hits += ec["lru_hits"]
        self.stats.expert_lru_bytes = ec["lru_bytes_used"]
        if self.pages is not None:
            kv_htod, kv_dtoh, _ = self.pages.take_counters()
            self.stats.kv_htod_bytes += kv_htod
            self.stats.kv_dtoh_bytes += kv_dtoh
        for owner in (self.store, self.pages):
            if owner is not None:
                retries, timeouts = owner.take_fault_counters()
                self.stats.transfer_retries += retries
                self.stats.transfer_timeouts += timeouts
        return self.stats

    # -- cache management ---------------------------------------------
    @property
    def n_host(self) -> int:
        """Rows ``[0, n_host)`` of the batch take the host attention path:
        ``round(omega * B)``."""
        return int(round(self.plan.omega * self._batch))

    def _paged_b(self) -> bool:
        """Mode B: the KV lives only in the page table's pools."""
        return self.pages is not None and not self.pages.fully_resident

    def init_cache(self, batch: int) -> None:
        """A zeroed cache of ``batch`` rows.  A cache of that batch already
        held is zeroed in place (its page table reset), so its
        ``data_ptr()``s -- which the captured decode graphs read and write
        -- never change; a new batch allocates new buffers and drops the
        graphs.  With ``cache_config`` paging on, the page table; with
        omega > 0 and a contiguous cache, the host rows' KV."""
        if self.cache is not None and self._batch == batch:
            for layer in self.cache:
                for buf in layer.values():
                    buf.zero_()
            for kv in self._host_kv.values():
                for buf in kv.values():
                    buf.zero_()
            if self.pages is not None:
                self.pages.reset()
            return
        self._drop_owned()
        self.cache = None                 # free the old buffers first
        self._drop_graphs(list(self._graphs))
        self._host_kv, self._host_bufs = {}, {}
        if self.pages is not None:
            self.pages.close()
            self.pages = None
        self._batch = batch
        cc = self.cache_config
        if cc is not None and cc.enabled and self._n_attn:
            self.pages = KVPageTable(self.cfg, self.schema, batch, self.max_seq, cc,
                                     device=self.device)
        paged_b = self._paged_b()
        self.cache = [{} if kind == "attn" and paged_b else
                      init_layer_cache(self.cfg, kind, batch, self.max_seq, self.device)
                      for kind, _ in self.schema]
        if self.n_host and self._n_attn:
            self._init_host_buffers(kv=not paged_b)

    def _owned(self) -> Dict[str, torch.Tensor]:
        """Every tensor the engine writes in place across decode ticks and
        its captured graphs hold: the cache, the host rows' KV, the page
        pools, the carries and the device counters."""
        out: Dict[str, torch.Tensor] = {}
        for li, layer in enumerate(self.cache or []):
            out.update((f"cache.{li}.{name}", t) for name, t in layer.items())
        for li, kv in self._host_kv.items():
            out.update((f"host_kv.{li}.{name}", t) for name, t in kv.items())
        if self.pages is not None:
            out.update((f"pool_k.{li}", t) for li, t in self.pages.pool_k.items())
            out.update((f"pool_v.{li}", t) for li, t in self.pages.pool_v.items())
        for n, c in self._carries.items():
            out.update({f"carry.{n}.state": c.state, f"carry.{n}.temps": c.temps,
                        f"carry.{n}.out": c.out})
        out.update(kept=self._kept_dev, dropped=self._dropped_dev, load=self._load_dev)
        return out

    def _check_pointers(self) -> None:
        """After a decode tick, under ``sanitize(pointers=True)``: nothing
        the graphs hold moved since this batch's first tick."""
        san = sanitizer.current()
        if san is not None and san.pointers:
            donation.check_pointers(f"engine {self._serial}",
                                    (self._batch, self._alloc_epoch), self._owned())

    def _drop_owned(self) -> None:
        """The cache is about to be replaced: poison it (under
        ``sanitize(poison=True)``) and start a new pointer epoch."""
        if self.cache is not None:
            donation.poison(t for name, t in self._owned().items()
                            if name.startswith(("cache.", "host_kv.", "pool_")))
        self._alloc_epoch += 1

    def _drop_graphs(self, keys) -> None:
        for key in keys:
            self._graphs.pop(key, None)
            self.graph_keys.discard(key)

    def _init_host_buffers(self, kv: bool) -> None:
        """The staging buffer of the host rows' output upload and, with
        ``kv`` (a contiguous cache), the host rows' KV: K and V per attention
        layer in the host mechanism's layout, (n_host, K, span, hd) f32 of
        bf16 values (``host_attention.to_heads``: a decode step neither
        widens nor transposes it), in one zeroed host buffer.  Both
        page-locked on a card."""
        cfg, n = self.cfg, self.n_host
        item = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
        bufs = {"out": _HostBuffer(n * cfg.num_heads * cfg.head_dim * item)}
        attn = [li for li, (kind, _) in enumerate(self.schema) if kind == "attn"]
        shape = (n, cfg.num_kv_heads, attn_mod.kv_span(cfg, self.max_seq), cfg.head_dim)
        per = int(np.prod(shape)) * 4
        if kv:
            bufs["kv"] = _HostBuffer(2 * per * len(attn))
            bufs["kv"].tensor.zero_()
        if self.device.type == "cuda":
            for buf in bufs.values():
                buf.pin()
        for j, li in enumerate(attn if kv else []):
            flat = bufs["kv"].tensor[2 * j * per:2 * (j + 1) * per].view(torch.float32)
            self._host_kv[li] = {"k": flat[:flat.numel() // 2].view(shape),
                                 "v": flat[flat.numel() // 2:].view(shape)}
        self._host_bufs = bufs

    def evict_slots(self, rows) -> None:
        """Recycle batch slots: zero their rows in every layer, in place
        (the host rows' KV too), and return their page frames."""
        assert self.cache is not None
        evict_rows(self.cache, rows)
        rows = np.asarray(rows, np.int64).reshape(-1)
        host = torch.as_tensor(rows[rows < self.n_host])
        if self._host_kv and host.numel():
            for kv in self._host_kv.values():
                for buf in kv.values():
                    buf.index_fill_(0, host, 0)
        if self.pages is not None:
            self.pages.free_rows([int(r) for r in rows])

    def reserve_slot_rows(self, rows) -> None:
        """Reserve page frames for batch rows ``rows`` before their prefill
        (nothing without paging; a reserved row keeps its placement).  The
        host-attention rows prefer the host tier.  Raises
        ``faults.PageAllocOOM`` when both tiers are out of frames, or when an
        armed fault plan injects one, before any prefill work is spent."""
        if self.pages is None:
            return
        rows_l = [int(r) for r in np.asarray(rows).reshape(-1)]
        self.pages.ensure_rows(rows_l, prefer_host=[r < self.n_host for r in rows_l])

    def _write_cache_rows(self, li: int, kind: str, entry: Dict, rows: np.ndarray) -> None:
        """A prefill micro-batch's raw ``entry`` into batch rows ``rows`` of
        layer ``li``: the contiguous buffer (``insert_prefill_rows``), or
        under paging the rows' frames (allocated on first touch); with a
        host rows' KV, its rows by one device-to-host copy."""
        if kind == "attn" and self.pages is not None:
            self.reserve_slot_rows(rows)
            if self._paged_b():
                nk, nv = aligned_kv(self.cfg, entry["k"], entry["v"], self.pages.span)
                self.pages.insert_rows(li, nk, nv, [int(r) for r in rows])
                return
        insert_prefill_rows(self.cfg, self.cache[li], entry, self._tensor(rows))
        host = np.flatnonzero(rows < self.n_host)
        if kind == "attn" and self._host_kv and host.size:
            span = self._host_kv[li]["k"].shape[2]
            nk, nv = aligned_kv(self.cfg, entry["k"], entry["v"], span)
            dst = [int(r) for r in rows[host]]
            copy_rows_to_host(self._host_kv[li]["k"], dst, to_heads(nk), host.tolist())
            copy_rows_to_host(self._host_kv[li]["v"], dst, to_heads(nv), host.tolist())

    # -- phases ---------------------------------------------------------
    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        """``a`` on the engine's device.  A host array goes up without a
        host-side wait (pageable memory is staged before the copy returns),
        so an upload on the decode path is not a hidden sync."""
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a))
        return a.to(device=self.device, dtype=dtype, non_blocking=True)  # lint: allow[MG105] the engine's one upload of host index, position and token vectors, asynchronous

    def prefill(self, tokens, frontend_emb=None, lengths=None) -> torch.Tensor:
        """Prefill a fresh batch (micro-batched by b_a), filling the engine
        cache.  Returns the last-token logits (B, V).  ``lengths`` (B,)
        makes a ragged right-padded batch exact; ``frontend_emb`` (B, F, D)
        replaces the first F positions' embeddings."""
        B = tokens.shape[0]
        self.init_cache(B)
        return self.prefill_slots(tokens, np.arange(B), lengths=lengths,
                                  frontend_emb=frontend_emb)

    def prefill_slots(self, tokens, rows, lengths=None, frontend_emb=None) -> torch.Tensor:
        """Prefill ``tokens`` (n, S) into existing batch rows ``rows`` (n,).

        Layer-major module batching: layers in the outer loop (weights
        acquired once per layer), ``b_a`` micro-batches in the inner loop.
        Also the continuous scheduler's admission path: newcomers overwrite
        their slots' cache rows; every other slot is untouched.  A MoE layer
        runs the grouped dispatch (``grouped_prefill``) or the exact
        dense-combine reference.  ``frontend_emb`` (n, F, D) replaces each
        micro-batch's first F positions' embeddings.  Returns the
        newcomers' last-token logits (n, V)."""
        cfg, plan = self.cfg, self.plan
        assert self.cache is not None, "init_cache/prefill before prefill_slots"
        tokens = self._tensor(tokens)
        n, S = tokens.shape
        assert S <= self.max_seq
        if cfg.sliding_window and S > cfg.sliding_window:
            # the reference engine asserts the same; models.model.prefill
            # takes prompts beyond the window
            raise NotImplementedError(
                f"engine prefill requires prompt <= window ({S} > "
                f"{cfg.sliding_window}); models.model.prefill takes longer prompts")
        rows = np.asarray(rows).reshape(-1)
        b_a = max(1, min(plan.b_a, n))
        spans = [(lo, min(n, lo + b_a)) for lo in range(0, n, b_a)]
        live = [None] * len(spans)
        if lengths is not None:
            lens_np = np.asarray(lengths.cpu() if torch.is_tensor(lengths)
                                 else lengths, np.int64).reshape(-1)
            live = [self._live_index(lens_np[lo:hi], S) for lo, hi in spans]
            lengths = self._tensor(lens_np)
        positions = torch.arange(S, device=self.device)[None, :]
        embed = self.store.base["embed"]
        xs = [embed[tokens[lo:hi]] for lo, hi in spans]
        if frontend_emb is not None:
            fe = self._tensor(frontend_emb, torch_dtype(cfg.dtype))
            F = fe.shape[1]
            xs = [torch.cat([fe[lo:hi], x[:, F:]], dim=1)
                  for (lo, hi), x in zip(spans, xs)]
        for li, (kind, ffn) in enumerate(self.schema):
            p = self.store.acquire(li)
            self.store.prefetch(li + 1)     # hide l+1's copy behind this layer
            outs = []
            for j, ((lo, hi), x) in enumerate(zip(spans, xs)):
                ln = None if lengths is None else lengths[lo:hi]
                if ffn == "moe" and self.grouped_prefill:
                    x, entry = self._prefill_moe_layer(kind, p, x, positions, ln,
                                                       live[j])
                else:
                    x, entry, _ = layer_forward(cfg, kind, ffn, p, x, positions, ln)
                self._write_cache_rows(li, kind, entry, rows[lo:hi])
                outs.append(x)
            xs = outs
        self.stats.attn_microbatches += len(spans)
        x_full = torch.cat(xs, dim=0)
        if lengths is None:
            h_last = x_full[:, -1]
        else:
            h_last = x_full[torch.arange(n, device=self.device), lengths - 1]
        return head(cfg, self.store.base, h_last)

    def _live_index(self, lens: np.ndarray, S: int) -> Optional[torch.Tensor]:
        """Flat (row * S + position) indices of a micro-batch's positions
        below its ``lens``; None when no position is padding."""
        if (lens >= S).all():
            return None
        mask = np.arange(S)[None, :] < lens[:, None]
        return self._tensor(np.flatnonzero(mask))

    def _prefill_moe_layer(self, kind, p, x, positions, lengths, live=None,
                           prefix_kv=None, cap=None):
        """A grouped-prefill MoE layer as two launches: mixer (attention or
        SSM, by ``kind``; ``prefix_kv`` as ``mixer_forward``'s) + route, then
        the grouped FFN at capacity ``cap``, by default ``next_pow2(max
        expert load)`` -- zero drops, and the same output as any capacity
        >= that load.

        Only the positions in ``live`` (those below ``lengths``) are routed:
        padded positions are never read, and since their attention rows are
        zeros they would all route to the same experts and inflate the
        capacity probe.  Their MoE output is zero."""
        cfg = self.cfg
        y, entry = mixer_forward(cfg, kind, p, x, positions, lengths, prefix_kv)
        x = x + y
        B, S, D = x.shape
        xt = rms_norm(x, p["norm2"], cfg.norm_eps).reshape(-1, D)
        if live is not None:
            xt = xt.index_select(0, live)
        moe = p["moe"]
        gates, idx, _ = moe_mod.route(cfg, moe["router"], xt)
        if cap is None:
            load = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
            with sanitizer.allowed("prefill-capacity-probe"):
                cap = W.next_pow2(int(load.max()))   # the planned capacity probe
        y, _, _, _ = moe_mod.grouped_dispatch(
            cfg, xt, gates, idx, moe["experts_w_gate"], moe["experts_w_up"],
            moe["experts_w_down"], cap,
        )
        if live is not None:
            y = torch.zeros((B * S, D), dtype=y.dtype,
                            device=y.device).index_copy_(0, live, y)
        return x + y.reshape(B, S, D).to(x.dtype), entry

    # -- prefix caching ---------------------------------------------------
    def read_prefix_rows(self, slot: int, pspan: int) -> List[Tuple[torch.Tensor,
                                                                    torch.Tensor]]:
        """The first ``pspan`` KV slots of batch row ``slot`` in every
        attention layer, as ``(k, v)`` host tensors (pspan, K, hd) -- the
        capture side of the prefix cache, safe to keep across decode ticks.
        They land in one host buffer (page-locked on a card), each layer's
        K then V, so that ``prefill_prefix_hit`` uploads a layer in one
        copy.  From the cache rows (contiguous or Mode A) by one planned
        read, counted in ``stats.planned_reads``; under Mode B through
        ``KVPageTable.read_rows``, one planned read for each layer with a
        page on a device frame.  Admission calls it, never a decode tick."""
        cfg = self.cfg
        assert all(kind == "attn" for kind, _ in self.schema), (
            "prefix capture requires an attention-only model")
        shape = (pspan, cfg.num_kv_heads, cfg.head_dim)
        dtype = torch_dtype(cfg.dtype)
        per = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = _HostBuffer(2 * per * len(self.schema))
        if self.device.type == "cuda":
            buf.pin()
        flat = buf.tensor.view(dtype).view((len(self.schema), 2) + shape)
        self._kv_rows_to_host(slot, pspan, {li: (flat[li, 0], flat[li, 1])
                                            for li in range(len(self.schema))},
                              "prefix-capture")
        return PrefixRows(flat, buf)

    def _kv_rows_to_host(self, slot: int, n: int,
                         dst: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
                         tag: Optional[str]) -> None:
        """The first ``n`` KV slots of batch row ``slot`` of each attention
        layer ``li`` of ``dst`` into its host tensors ``(k, v)`` (n, K, hd):
        under Mode B through ``KVPageTable.read_rows``, one planned read for
        each layer with a page on a device frame; else from the cache rows,
        one copy each and one planned read.  Each planned read is an
        ``allowed(tag)`` scope (None: the caller's), counted in
        ``stats.planned_reads``."""
        if self._paged_b():
            on_device = self.pages.device_frames_of([slot], n)
            for li, (dk, dv) in dst.items():
                with sanitizer.allowed(tag) if on_device and tag else contextlib.nullcontext():
                    k, v = self.pages.read_rows(li, [slot], n)
                self.stats.planned_reads += int(on_device)
                dk.copy_(k[0])
                dv.copy_(v[0])
            return
        for li, (dk, dv) in dst.items():
            dk.copy_(self.cache[li]["k"][slot, :n], non_blocking=True)
            dv.copy_(self.cache[li]["v"][slot, :n], non_blocking=True)
        with sanitizer.allowed(tag) if tag else contextlib.nullcontext():
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        self.stats.planned_reads += 1

    # -- preemption checkpoints -------------------------------------------
    def checkpoint_slot(self, slot: int) -> SlotCheckpoint:
        """Batch row ``slot``'s whole decode state in host memory: every
        attention layer's KV row over the cache span (from the cache, the
        host rows' KV or the pages, as the row lives) and every SSM layer's
        ``h`` and ``conv`` rows.  The reads are planned (one ``ckpt-save``
        scope, which waits for them); the snapshot is safe to keep across
        ticks."""
        assert self.cache is not None
        slot, cfg = int(slot), self.cfg
        span = attn_mod.kv_span(cfg, self.max_seq)
        shape, dtype = (span, cfg.num_kv_heads, cfg.head_dim), torch_dtype(cfg.dtype)
        layers = [{n: torch.empty(shape, dtype=dtype) for n in ("k", "v")} if kind == "attn"
                  else {n: torch.empty(buf.shape[1:], dtype=buf.dtype)
                        for n, buf in self.cache[li].items()}
                  for li, (kind, _) in enumerate(self.schema)]
        attn = {li: (layers[li]["k"], layers[li]["v"])
                for li, (kind, _) in enumerate(self.schema) if kind == "attn"}
        with sanitizer.allowed("ckpt-save"):
            if attn and slot < self.n_host and self._host_kv:
                for li, (dk, dv) in attn.items():      # the host rows' own KV
                    dk.copy_(self._host_kv[li]["k"][slot].transpose(0, 1))
                    dv.copy_(self._host_kv[li]["v"][slot].transpose(0, 1))
                attn = {}
            for li, (kind, _) in enumerate(self.schema):
                if kind != "attn":
                    for name, t in layers[li].items():
                        t.copy_(self.cache[li][name][slot], non_blocking=True)
            if attn:
                self._kv_rows_to_host(slot, span, attn, None)
            elif self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        return SlotCheckpoint(layers)

    def restore_slot(self, slot: int, ckpt: SlotCheckpoint) -> None:
        """Write a ``checkpoint_slot`` snapshot into batch row ``slot`` (a
        resume): page frames are reserved first (``faults.PageAllocOOM``
        leaves the row untouched and the resume queued), then every layer's
        row is written in place (``ckpt-restore``), so the tensors the
        captured graphs hold keep their addresses.  With the sampler and the
        position restored by the scheduler, decode goes on as if the row had
        never left: no prefill runs."""
        assert self.cache is not None
        slot = int(slot)
        self.reserve_slot_rows([slot])
        with sanitizer.allowed("ckpt-restore"):
            for li, (kind, _) in enumerate(self.schema):
                st = ckpt.layers[li]
                if kind != "attn":
                    for name, t in st.items():
                        self.cache[li][name][slot].copy_(t, non_blocking=True)
                elif self._paged_b():
                    nk, nv = (st[n].to(self.device, non_blocking=True)[None]  # lint: allow[MG105] one upload of a checkpointed row at resume
                              for n in ("k", "v"))
                    self.pages.insert_rows(li, nk, nv, [slot])
                else:
                    self.cache[li]["k"][slot].copy_(st["k"], non_blocking=True)
                    self.cache[li]["v"][slot].copy_(st["v"], non_blocking=True)
                    if slot < self.n_host and li in self._host_kv:
                        self._host_kv[li]["k"][slot].copy_(to_heads(st["k"][None])[0])
                        self._host_kv[li]["v"][slot].copy_(to_heads(st["v"][None])[0])

    def prefill_prefix_hit(self, slot: int, prompt, prefix_kvs, pos0: int) -> torch.Tensor:
        """Admit a prefix-cache hit into batch row ``slot``: the stored
        prefix KV (``read_prefix_rows`` of an earlier row with the same
        first ``pos0`` tokens) goes up, one asynchronous copy a layer, and
        only the suffix ``prompt[pos0:]`` is prefilled, its queries at
        absolute positions ``pos0..`` attending prefix and suffix keys (K4
        with ``q_offset = pos0``).  KV at position p depends only on tokens
        <= p, so the row's KV and logits are what a full prefill computes.
        Each layer is prefill's with ``prefix_kv`` set; the MoE runs at
        capacity ``next_pow2(len(suffix))``, known on the host, so a hit
        makes no capacity probe.  The row's whole KV is written through
        ``_write_cache_rows`` (pages and Mode A/B as in prefill).  The
        launches do not depend on ``pos0``.  Returns the (1, V) last-token
        logits."""
        cfg = self.cfg
        assert self.cache is not None, "init_cache before prefill_prefix_hit"
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        assert 0 < pos0 < len(prompt), (pos0, len(prompt))
        suffix = self._tensor(prompt[pos0:])[None, :]
        S = suffix.shape[1]
        positions = pos0 + torch.arange(S, device=self.device)[None, :]
        # top-k ids are distinct per token, so no expert receives more than
        # S copies: a zero-drop capacity known on the host, without a probe
        cap = W.next_pow2(S)
        rows = np.asarray([slot])
        pairs = getattr(prefix_kvs, "pairs", None)
        x = self.store.base["embed"][suffix]
        for li, (kind, ffn) in enumerate(self.schema):
            assert kind == "attn", "the prefix cache requires an attention-only model"
            p = self.store.acquire(li)
            self.store.prefetch(li + 1)
            kv = (torch.stack([torch.as_tensor(t) for t in prefix_kvs[li]])  # lint: allow[MG105] a hit's stored prefix KV, one asynchronous copy a layer from page-locked memory
                  if pairs is None else pairs[li]).to(self.device, non_blocking=True)
            pkv = (kv[0][None], kv[1][None])
            if ffn == "moe" and self.grouped_prefill:
                x, entry = self._prefill_moe_layer(kind, p, x, positions, None,
                                                   prefix_kv=pkv, cap=cap)
            else:
                x, entry, _ = layer_forward(cfg, kind, ffn, p, x, positions, prefix_kv=pkv)
            self._write_cache_rows(li, kind, entry, rows)
        self.stats.attn_microbatches += 1
        return head(cfg, self.store.base, x[:, -1])

    # -- path selection ---------------------------------------------------
    def fused_eligible(self) -> bool:
        """True when decode takes the fused chunk (a CUDA graph of the tick
        on the card): fused decode on, grouped expert dispatch, and every
        weight resident (a streamed layer keeps the per-module loop: the
        prefetch needs the layer boundary to hide behind, and a graph would
        hold the window's slots at fixed addresses), and no KV page on the
        host (Mode B decodes per module for the same reasons).  The host
        attention rows of omega > 0 run per module beside the graph.  A loop
        engine decodes per module (its stage reads the routing to the host).
        An expert-parallel engine (``sctx``) always decodes per module: its
        collective MoE stage exchanges through the host between the
        attention and the FFN."""
        return (self.fused_decode and self.expert_path == "grouped" and self.sctx is None
                and self.store.fully_resident
                and (self.pages is None or self.pages.fully_resident))

    # -- decode -----------------------------------------------------------
    @hot_path
    def decode_step(self, tokens, pos) -> torch.Tensor:
        """One per-module decode step for all B sequences; returns logits.
        ``pos`` is a scalar or a per-sequence (B,) vector of positions."""
        tokens = self._tensor(tokens)
        n = tokens.shape[0]
        pos_host = self._pos_host(pos, n)
        with sanitizer.decode_region():
            lg = self._decode_rows(tokens, self._tensor(pos), 0, pos_host)
        self._count_module_tick(0, n)
        self._check_pointers()
        return lg

    def _pos_host(self, pos, n: int) -> Optional[np.ndarray]:
        """The rows' positions as a host (n,) vector, where the tick needs
        them on the host (host attention rows or Mode B paging)."""
        if not (self.n_host or self._paged_b()):
            return None
        if torch.is_tensor(pos):
            with sanitizer.allowed("decode-inputs"):
                pos = pos.cpu()
        return np.broadcast_to(np.asarray(pos, np.int64).reshape(-1), (n,)).copy()

    def _segments(self, row0: int, n: int) -> List[Tuple[int, int, bool]]:
        """The attention micro-batches of rows ``[row0, row0 + n)``: ``b_a``
        rows each, one that straddles ``n_host`` split at it, each
        ``(lo, hi, host)`` in batch rows."""
        b_a = max(1, min(self.plan.b_a, n))
        n_host, segs = self.n_host, []
        lo, end = row0, row0 + n
        while lo < end:
            hi = min(end, lo + b_a)
            if lo < n_host < hi:
                hi = n_host
            segs.append((lo, hi, hi <= n_host))
            lo = hi
        return segs

    def _count_module_tick(self, row0: int, n: int) -> None:
        """Per-module accounting of one decode tick over rows ``[row0, row0
        + n)``: one attention launch set per layer and micro-batch, the
        host and device attention tokens, one grouped dispatch per MoE
        layer (the loop stage counts its own launches)."""
        segs = self._segments(row0, n)
        host = sum(hi - lo for lo, hi, h in segs if h)
        self.stats.attn_microbatches += self._n_attn * len(segs)
        self.stats.host_attn_tokens += self._n_attn * host
        self.stats.device_attn_tokens += self._n_attn * (n - host)
        if self.expert_path == "grouped":
            self.stats.expert_launches += len(self._moe_layers)

    @hot_path
    def _decode_rows(self, tokens: torch.Tensor, pos: torch.Tensor, row0: int,
                     pos_host: Optional[np.ndarray] = None) -> torch.Tensor:
        """Per-module decode over batch rows ``[row0, row0 + n)``: every
        module of one tick, in order (the fused tick captures exactly this:
        with every weight resident the store's calls do nothing on the
        device).  ``pos_host`` mirrors ``pos`` on the host where host rows
        or Mode B pages need it.  A streamed layer's prefetch of layer ``li
        + 1`` (weights, and host KV frames) goes out after its mixer, before
        its FFN; a predictively streamed MoE layer makes the tick's one
        planned host read of that layer."""
        cfg = self.cfg
        x = self.store.base["embed"][tokens]
        # only device rows read the streamed host frames
        device_rows = self.pages is not None and row0 + tokens.shape[0] > self.n_host
        for li, (kind, ffn) in enumerate(self.schema):
            predictive = (ffn == "moe" and self.expert_path == "grouped"
                          and self.store.streams_experts(li))
            p = self.store.acquire(li, experts=not predictive)
            if kind == "attn":
                x = x + self._attention_stage(li, p, x, pos, row0, pos_host)
            else:
                x = x + self._ssm_stage(li, p, x, row0)
            self.store.prefetch(li + 1)     # before the FFN / grouped launch
            if device_rows:
                self.pages.prefetch(li + 1)  # the next layer's host KV frames
            if predictive:
                x = x + self._expert_stage_predictive(li, x)
            elif ffn == "moe" and self.expert_path == "loop":
                x = x + self._expert_stage_loop(p, x)
            elif ffn == "moe":
                x = x + self._expert_stage_grouped(li, p, x)
            elif cfg.d_ff > 0 and "ffn" in p:
                x = x + ffn_apply(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))
        return head(cfg, self.store.base, x)

    # -- module stages ---------------------------------------------------
    @hot_path
    def _attention_stage(self, li, p, x, pos, row0: int = 0,
                         pos_host: Optional[np.ndarray] = None) -> torch.Tensor:
        """Micro-batched attention over rows ``[row0, row0 + n)`` with the
        omega split (``_segments``): a host micro-batch runs the host
        mechanism, a device one K3 on its rows of the cache in place, or
        under Mode B paging K3p over the pool and the layer's streamed host
        frames.  Those are acquired once for the layer, before any host
        micro-batch writes a host frame: a write after the acquire leaves
        the prefetched copy in use (the device rows read only their own
        frames), one before it would stale the copy and fetch it again."""
        n = x.shape[0]
        posv = pos.reshape(-1).expand(n) if pos.numel() == 1 else pos
        segs = self._segments(row0, n)
        window = None
        if self._paged_b() and not all(host for _, _, host in segs):
            window = self.pages.acquire(li)
        outs = []
        for lo, hi, host in segs:
            a, b = lo - row0, hi - row0
            h = rms_norm(x[a:b, None, :], p["norm1"], self.cfg.norm_eps)
            if host:
                y = self._host_rows(li, p, h, posv[a:b], pos_host[a:b], lo, hi)
            elif window is not None:
                y = self._paged_rows(li, p, h, posv[a:b], pos_host[a:b], lo, hi, window)
            else:
                k, v = self.cache[li]["k"], self.cache[li]["v"]
                y, _ = attn_mod.attn_decode(self.cfg, p["attn"], h,
                                            {"k": k[lo:hi], "v": v[lo:hi]}, posv[a:b])
                y = y[:, 0]
            outs.append(y)
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _planned_host(self, *ts: torch.Tensor, tag: str) -> List[torch.Tensor]:
        """``ts`` (each with the same first dimension) on the host in one
        planned read, an ``allowed(tag)`` scope counted in
        ``stats.planned_reads``."""
        n = ts[0].shape[0]
        packed = torch.cat([t.reshape(n, -1) for t in ts], dim=1)
        with sanitizer.allowed(tag):
            host = packed.cpu()
        self.stats.planned_reads += 1
        out, c = [], 0
        for t in ts:
            w = t[0].numel()
            out.append(host[:, c:c + w].reshape(t.shape))
            c += w
        return out

    def _host_attend(self, p, q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     pos_np: np.ndarray, heads: bool = False) -> torch.Tensor:
        """The host mechanism on host tensors (``heads``: the KV already in
        its layout), then the output up by one copy from page-locked memory
        (the staging buffer's last upload finished before this layer's
        planned read returned) and ``wo`` on the device."""
        cfg = self.cfg
        n = q.shape[0]
        t0 = time.perf_counter()
        attend = host_decode_attention_heads if heads else host_decode_attention
        out = attend(q, kc, vc, pos_np)                         # (n, H, hd) f32
        self.stats.host_attn_s += time.perf_counter() - t0
        dtype = p["attn"]["wo"].dtype
        if self.device.type == "cuda":
            width = cfg.num_heads * cfg.head_dim
            stage = self._host_bufs["out"].tensor.view(dtype)[:n * width].view(n, width)
            stage.copy_(out.reshape(n, width))
            o = stage.to(self.device, non_blocking=True)  # lint: allow[MG105] the host rows' attention output, up from page-locked memory
        else:
            o = out.reshape(n, -1).to(dtype)
        return o @ p["attn"]["wo"]

    @hot_path
    def _host_rows(self, li, p, h, posv, pos_np, lo: int, hi: int) -> torch.Tensor:
        """A host micro-batch, rows ``[lo, hi)``: projections and rope on the
        device, q / k_new / v_new down in one planned read, the slot written
        into the host-resident KV (the host rows' buffer, or the rows'
        pages read by ``KVPageTable.read_rows`` under Mode B), the host
        mechanism, ``wo`` on the device.  Under Mode B the written slot is
        mirrored into whichever tier holds its page.  Its host reads are
        ``paged-host-rows`` scopes."""
        cfg = self.cfg
        q, k, v = attn_mod.decode_qkv(cfg, p["attn"], h, posv)
        qh, kh, vh = self._planned_host(q[:, 0], k[:, 0], v[:, 0], tag="paged-host-rows")
        rows = np.arange(lo, hi)
        if not self._paged_b():
            kc, vc = self._host_kv[li]["k"], self._host_kv[li]["v"]
            slot = torch.as_tensor(attn_mod.decode_slot(cfg, pos_np, kc.shape[2]))
            kc[torch.as_tensor(rows), :, slot] = round_bf16(kh.float())
            vc[torch.as_tensor(rows), :, slot] = round_bf16(vh.float())
            return self._host_attend(p, qh, kc[lo:hi], vc[lo:hi], pos_np, heads=True)
        pages = self.pages
        span = pages.span
        if pages.device_frames_of(rows, span):
            with sanitizer.allowed("paged-host-rows"):
                kc, vc = pages.read_rows(li, rows, span)
            self.stats.planned_reads += 1
        else:
            kc, vc = pages.read_rows(li, rows, span)
        slot = attn_mod.decode_slot(cfg, pos_np, span)
        kc[torch.arange(hi - lo), torch.as_tensor(slot)] = kh
        vc[torch.arange(hi - lo), torch.as_tensor(slot)] = vh
        y = self._host_attend(p, qh, kc, vc, pos_np)
        tg = pages.slot_targets(rows, slot)
        on_host = torch.as_tensor(tg.host_i)
        pages.write_host_slots(li, tg.host_flat, kh[on_host], vh[on_host])
        if tg.pool_i.size:                   # a host row spilled onto the pool
            sel = self._tensor(tg.pool_i)
            self._scatter_slots(pages.pool_k[li], pages.pool_v[li], tg.pool_flat,
                                k[sel, 0], v[sel, 0])
        return y

    def _scatter_slots(self, bk: torch.Tensor, bv: torch.Tensor, flat: np.ndarray,
                       k: torch.Tensor, v: torch.Tensor) -> None:
        """Write rows k[j], v[j] (K, hd) into slots ``flat[j]`` of the frame
        buffers bk/bv (F, pt, K, hd), in place on the device."""
        idx = self._tensor(flat)
        bk.view((-1,) + tuple(bk.shape[2:])).index_copy_(0, idx, k)
        bv.view((-1,) + tuple(bv.shape[2:])).index_copy_(0, idx, v)

    @hot_path
    def _paged_rows(self, li, p, h, posv, pos_np, lo: int, hi: int, window) -> torch.Tensor:
        """A Mode B device micro-batch, rows ``[lo, hi)``: projections and
        rope, k_new / v_new written into the device buffer that holds the
        written page this tick (its pool frame, or the window's copy of its
        host frame), one K3p launch through the page table, ``wo``; a slot
        whose page is host-side is then mirrored to the host pool, its
        values down in one planned read."""
        cfg, pages = self.cfg, self.pages
        span = pages.span
        ek, ev = window
        q, k, v = attn_mod.decode_qkv(cfg, p["attn"], h, posv)
        rows = np.arange(lo, hi)
        tg = pages.slot_targets(rows, attn_mod.decode_slot(cfg, pos_np, span))
        if tg.pool_i.size:
            sel = self._tensor(tg.pool_i)
            self._scatter_slots(pages.pool_k[li], pages.pool_v[li], tg.pool_flat,
                                k[sel, 0], v[sel, 0])
        if tg.host_i.size:
            sel = self._tensor(tg.host_i)
            self._scatter_slots(ek, ev, tg.host_flat, k[sel, 0], v[sel, 0])
        frames = self._tensor(pages.gather_indices(rows), torch.int32)
        o = ops.decode_attention_paged(q[:, 0].contiguous(), pages.pool_k[li],
                                       pages.pool_v[li], ek, ev, frames, posv, span)
        y = o.reshape(hi - lo, cfg.num_heads * cfg.head_dim) @ p["attn"]["wo"]
        if tg.host_i.size:
            kh, vh = self._planned_host(k[sel, 0], v[sel, 0], tag="paged-host-writeback")
            pages.write_host_slots(li, tg.host_flat, kh, vh)
        return y

    @hot_path
    def _ssm_stage(self, li, p, x, row0: int = 0) -> torch.Tensor:
        """SSM decode over rows ``[row0, row0 + n)`` in one launch set (not
        micro-batched: the state is O(1) per row); ``ssm_decode`` writes the
        rows of the layer's ``h`` and ``conv`` buffers in place."""
        cfg = self.cfg
        rows = slice(row0, row0 + x.shape[0])
        state = {"h": self.cache[li]["h"][rows], "conv": self.cache[li]["conv"][rows]}
        h = rms_norm(x[:, None, :], p["norm1"], cfg.norm_eps)
        y, _ = ssm_mod.ssm_decode(cfg, p["ssm"], h, state)
        return y[:, 0]

    @hot_path
    def _expert_stage_grouped(self, li, p, x) -> torch.Tensor:
        """One grouped-dispatch launch for the whole MoE stage; the kept,
        dropped and load counters stay on device.  An expert-parallel engine
        runs the same stage through the collective dispatch
        (``distributed.ep_engine``); the counters keep one meaning."""
        cfg = self.cfg
        moe = p["moe"]
        if self.sctx is not None:
            y, kept, dropped, load, nbytes = ep_expert_stage(self, li, p, x)
            self.stats.a2a_bytes += nbytes
            self.stats.collective_dispatches += 1
        else:
            h = rms_norm(x, p["norm2"], cfg.norm_eps)
            gates, idx, _ = moe_mod.route(cfg, moe["router"], h)
            y, kept, dropped, load = moe_mod.grouped_dispatch(
                cfg, h, gates, idx, moe["experts_w_gate"], moe["experts_w_up"],
                moe["experts_w_down"], self._expert_capacity(x.shape[0]),
            )
        j = self._moe_index[li]
        self._kept_dev += kept
        self._dropped_dev[j] += dropped
        self._load_dev[j] += load
        return y

    def _expert_stage_loop(self, p, x) -> torch.Tensor:
        """The reference's sequential per-expert loop, kept as the oracle:
        norm2 and route on the device, the (T, k) expert ids and gates read
        to the host in one planned read (``expert-loop-oracle``), then for
        each expert and each chunk of ``b_e`` of its rows one product chain
        ``silu(h @ wg) * (h @ wu) @ wd`` in the activations' dtype (plain
        ``torch.matmul``, no kernel), added into the rows weighted by their
        gates.  Counts one expert launch and its rows per chunk."""
        cfg = self.cfg
        moe = p["moe"]
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        gates, idx, _ = moe_mod.route(cfg, moe["router"], h)
        k = idx.shape[1]
        packed = torch.cat([idx.to(torch.float32), gates], dim=1)   # ids exact in f32
        with sanitizer.allowed("expert-loop-oracle"):
            host = packed.cpu().numpy()
        self.stats.planned_reads += 1
        idx_np, gates_np = host[:, :k].astype(np.int64), host[:, k:]
        y = torch.zeros_like(x)
        b_e = max(1, self.plan.b_e)
        for e in range(cfg.num_experts):
            rows, which = np.nonzero(idx_np == e)
            if rows.size == 0:
                continue
            w = gates_np[rows, which]
            wg, wu, wd = (moe[name][e] for name in
                          ("experts_w_gate", "experts_w_up", "experts_w_down"))
            for lo in range(0, rows.size, b_e):
                chunk = rows[lo:lo + b_e]
                r = self._tensor(chunk)
                g = self._tensor(w[lo:lo + b_e], torch.float32)
                hc = h[r]
                ye = (torch.nn.functional.silu(hc @ wg) * (hc @ wu)) @ wd
                y[r] += ye * g[:, None].to(ye.dtype)
                self.stats.expert_launches += 1
                self.stats.expert_tokens += chunk.size
        return y

    def _next_streamed_moe(self, li: int) -> int:
        """The next MoE layer (wrapping) whose experts stream one by one:
        what layer ``li`` predicts for.  Its router is resident."""
        streamed = [m for m in self._moe_layers if self.store.streams_experts(m)]
        return streamed[(streamed.index(li) + 1) % len(streamed)]

    @hot_path
    def _expert_stage_predictive(self, li, x) -> torch.Tensor:
        """The MoE stage of a predictively streamed layer: route this layer
        and predict the next streamed one, read back one packed int32
        vector -- the (E,) routed-copy counts, then the khat predicted ids
        (the planned read, one per layer and tick) -- assemble the stacks
        of the experts used, prefetch the predicted set for the next layer,
        then the grouped FFN.  The FFN consumes the true routing, so the
        output equals the whole-stack path's whatever was predicted."""
        cfg, store = self.cfg, self.store
        E = cfg.num_experts
        shared = store.moe_shared(li)
        nli = self._next_streamed_moe(li)
        khat = store.predict_topk
        h = rms_norm(x, shared["norm2"], cfg.norm_eps)
        gates, idx, _ = moe_mod.route(cfg, shared["router"], h)
        used = torch.zeros((E,), dtype=torch.int32, device=x.device)
        used.scatter_add_(0, idx.reshape(-1), torch.ones_like(idx.reshape(-1),
                                                              dtype=torch.int32))
        pred = moe_mod.predict_experts(cfg, store.moe_shared(nli)["router"], x, khat)
        packed = torch.cat([used, pred])
        with sanitizer.allowed("expert-prefetch"):
            packed_np = packed.cpu().numpy()  # lint: allow[MG101] the one planned read of a predictively streamed layer a tick: its used and predicted experts
        self.stats.planned_reads += 1
        ids = np.nonzero(packed_np[:E])[0]
        if self.predictor is not None:
            pred_np = np.asarray(list(self.predictor(nli, khat)), np.int64)  # lint: allow[MG101] the test predictor's host ids, no tensor
        else:
            pred_np = packed_np[E:]
        wg, wu, wd = store.acquire_experts(li, ids)
        store.prefetch_experts(nli, pred_np)
        y, kept, dropped, load = moe_mod.grouped_dispatch(
            cfg, h, gates, idx, wg, wu, wd, self._expert_capacity(x.shape[0]))
        j = self._moe_index[li]
        self._kept_dev += kept
        self._dropped_dev[j] += dropped
        self._load_dev[j] += load
        return y

    # -- chunked decode ---------------------------------------------------
    def decode_chunk(self, tokens, pos, sampler: BatchSampler, T: int,
                     live=None) -> torch.Tensor:
        """``T`` decode ticks for the full batch, sampled per slot; returns
        the ``(B, T)`` token matrix (column t is tick t's tokens, fed back
        as tick t+1's input).

        The fused chunk when ``fused_eligible()`` (on the card: T replays
        of the tick's CUDA graph, no host read between them), else T
        per-module ticks; both give the same tokens.  With omega > 0 and a
        contiguous cache the host rows ``[0, n_host)`` run their T ticks
        per module first, then the device rows replay the fused graph (or,
        per module, run their T ticks); all rows run together per module
        when every row is a host row, or under Mode B paging.  ``live`` (B,)
        bool marks rows owned by unfinished requests: dead rows hold their
        stale token and position, like per-tick stepping.  Positions are
        clamped at ``max_seq - 1``.  The chunk runs in a sanitizer
        ``decode_region``; under ``sanitize(pointers=True)`` it ends with the
        pointer check."""
        B = tokens.shape[0] if torch.is_tensor(tokens) else len(tokens)
        if torch.is_tensor(pos):
            with sanitizer.allowed("decode-inputs"):
                pos = pos.cpu()
        pos_np = np.asarray(pos, np.int64).reshape(-1)
        if pos_np.size == 1:
            pos_np = np.full(B, pos_np[0], np.int64)
        if not torch.is_tensor(tokens):
            tokens = np.asarray(tokens).reshape(-1)
        if live is not None:
            live = np.asarray(live, bool).reshape(-1)
        with sanitizer.decode_region():
            out = self._decode_chunk_guarded(tokens, pos_np, sampler, T, live)
        self._check_pointers()
        return out

    @hot_path
    def _decode_chunk_guarded(self, tokens, pos_np: np.ndarray, sampler: BatchSampler,
                              T: int, live=None) -> torch.Tensor:
        B = pos_np.size
        n_host, fused = self.n_host, self.fused_eligible() and self.cache is not None
        if fused and not n_host:
            return self._fused_chunk(tokens, pos_np, sampler, T, live)
        toks = self._tensor(tokens)
        if 0 < n_host < B and self.store.fully_resident and not self._paged_b():
            # the rows split as the fused chunk splits them, fused or not, so
            # the per-module oracle's modules see the fused chunk's shapes
            host = self._chunk_rows_per_module(toks, pos_np, sampler, T, 0, n_host, live)
            if fused:
                dev = self._fused_chunk(toks[n_host:], pos_np[n_host:], sampler, T,
                                        None if live is None else live[n_host:],
                                        row0=n_host)
            else:
                dev = self._chunk_rows_per_module(toks, pos_np, sampler, T, n_host, B, live)
            return torch.cat([host, dev], dim=0)
        return self._chunk_rows_per_module(toks, pos_np, sampler, T, 0, B, live)

    @hot_path
    def _chunk_rows_per_module(self, tokens, pos_np: np.ndarray, sampler,
                               T: int, lo: int, hi: int,
                               live=None) -> torch.Tensor:
        """``T`` per-module ticks over rows ``[lo, hi)`` (the oracle of the
        fused chunk).  Positions advance on the host (``pos_np`` is the
        batch's (B,) numpy mirror) and go up once per tick as one (n,)
        vector."""
        slots = np.arange(lo, hi)
        cur = tokens[lo:hi]
        pos_rows = pos_np[lo:hi]
        adv = None if live is None else live[lo:hi].astype(np.int64)
        lv = None if adv is None else self._tensor(adv.astype(bool), torch.bool)
        cap = self.max_seq - 1
        cols = []
        host_pos = self.n_host > 0 or self._paged_b()
        for t in range(T):
            pt = np.minimum(pos_rows + (t if adv is None else t * adv), cap)
            lg = self._decode_rows(cur, self._tensor(pt), lo, pt if host_pos else None)
            self._count_module_tick(lo, hi - lo)
            sampled = sampler.sample(lg, slots)
            cols.append(sampled)
            cur = sampled if lv is None else torch.where(lv, sampled, cur)
        return torch.stack(cols, dim=1)

    @hot_path
    def _fused_chunk(self, tokens, pos_np: np.ndarray, sampler: BatchSampler,
                     T: int, live=None, row0: int = 0) -> torch.Tensor:
        """The fused chunk over the B rows ``[row0, row0 + B)``: the carry
        goes up in one copy, the tick runs T times (graph replays on the
        card), the sampler advances T steps on the host, and the (B, T)
        tokens come back as one tensor.  Accounting as the JAX package's
        fused chunk: one dispatch, T ticks, a decode retrace per new (B,
        row0, T, ...) key, and per tick one grouped dispatch per MoE layer
        and B attention tokens per attention layer."""
        B = pos_np.size
        idx = np.arange(row0, row0 + B)
        keys, steps, temps, topks = sampler.state(idx)
        use_topk = bool(np.any(topks > 0))
        greedy_only = not bool(np.any(temps > 0))
        capacity, cap = self._expert_capacity(B), self.max_seq - 1
        ref_key = (B, row0, T, capacity, cap, use_topk, greedy_only)
        if ref_key not in self._fused_keys:
            self._fused_keys.add(ref_key)
            self.stats.decode_retraces += 1
        c = self._carry(B, T)
        host = np.zeros((B, 8), np.int64)
        if not torch.is_tensor(tokens):
            host[:, 0] = tokens
        host[:, 1] = pos_np
        host[:, 2] = 1 if live is None else live
        host[:, 3], host[:, 4], host[:, 5:7] = steps, topks, keys
        c.state.copy_(torch.from_numpy(host), non_blocking=True)
        if torch.is_tensor(tokens):
            c.state[:, 0].copy_(tokens.reshape(-1))
        if not greedy_only:
            c.temps.copy_(torch.from_numpy(temps), non_blocking=True)
        if self.device.type == "cuda":
            graph, launches = self._graph(
                (B, row0, capacity, cap, use_topk, greedy_only), c)
            for _ in range(T):
                graph.replay()
            build.add_launches(launches, T)
        else:
            for _ in range(T):
                self._fused_tick(c, cap, use_topk, greedy_only, row0)
        sampler.advance(idx, T)
        self.stats.fused_dispatches += 1
        self.stats.fused_ticks += T
        self.stats.expert_launches += T * len(self._moe_layers)
        self.stats.device_attn_tokens += T * self._n_attn * B
        return c.out[:, :T].clone()

    @hot_path
    def _fused_tick(self, c: _Carry, cap: int, use_topk: bool, greedy_only: bool,
                    row0: int = 0) -> None:
        """One decode tick on the carry ``c`` of rows ``[row0, row0 + n)``, in
        place: the per-module modules (``_decode_rows``), then
        ``sample_tokens`` (argmax when no
        slot samples), then the carry: live rows take their token and
        advance their position, dead rows hold both, every row's token
        index advances, the tokens land in column ``tick`` of ``c.out``.
        The reference's tick (``repro/core/engine.py::_fused_decode_chunk``)."""
        st = c.state
        toks, pos, live, steps, tick = st[:, 0], st[:, 1], st[:, 2], st[:, 3], st[:1, 7]
        lg = self._decode_rows(toks, torch.clamp(pos, max=cap), row0)
        if greedy_only:
            nxt = greedy(lg)
        else:
            nxt = sample_tokens(lg, st[:, 5:7], steps, c.temps, st[:, 4], use_topk)
        c.out.index_copy_(1, tick, nxt[:, None])
        toks.copy_(torch.where(live > 0, nxt, toks))
        pos.add_(live)
        steps.add_(1)
        tick.add_(1)

    def _carry(self, B: int, T: int) -> _Carry:
        """The static carry of B rows with room for T columns of tokens; a
        wider one replaces it (and the graphs that held it)."""
        c = self._carries.get(B)
        if c is None or c.out.shape[1] < T:
            if c is not None:
                donation.poison((c.state, c.temps, c.out))
                self._alloc_epoch += 1
            c = self._carries[B] = _Carry.zeros(B, max(T, self.max_seq), self.device)
            self._drop_graphs([k for k in self._graphs if k[0] == B])
        return c

    def _graph(self, key: Tuple, c: _Carry):
        """The CUDA graph of one tick for ``key`` (B rows from row ``row0``,
        expert capacity, position cap, top-k, greedy only) and the kernel
        launches it makes, captured at its first use.  It holds views of
        the cache rows ``[row0, row0 + B)`` at fixed addresses.

        First a warm-up tick runs eagerly on scratch copies of everything a
        tick writes (``_scratch``), on the capture stream and uncounted, so
        that lazy set-up (library loads, cuBLAS workspaces, kernel
        attributes) happens outside the capture and no served state moves.
        Then the tick is captured -- recorded, not run -- on the real
        carry, cache and counters into the engine's private memory pool
        (``pool_bytes`` in the record: the pool's segments, shared by the
        engine's graphs), through ``CUDAGraph.capture_begin`` rather than
        ``torch.cuda.graph``, which would first empty the allocator's cache
        (slow after a large prefill, and the next prefill refills it).  A
        failed capture raises; nothing falls back to eager launches.  The
        capture synchronises: it is set-up, an ``allowed("graph-capture")``
        scope, and its key joins the registry's ``graph_keys``."""
        rec = self._graphs.get(key)
        if rec is None:
            with sanitizer.allowed("graph-capture"):
                rec = self._capture(key, c)
            self.graph_keys.add(key)
        return rec

    def _capture(self, key: Tuple, c: _Carry):
        B, row0, _, cap, use_topk, greedy_only = key
        dev = self.device
        if self._n_attn:
            reserve_tickets(B * self.cfg.num_kv_heads, dev)
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), build.launches_held(), self._scratch(c) as sc:
            self._fused_tick(sc, cap, use_topk, greedy_only, row0)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if not self._graphs:          # a pool no live graph holds may be released
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with build.launches_held() as launches, torch.cuda.stream(stream):
            graph.capture_begin(pool=self._pool)
            try:
                self._fused_tick(c, cap, use_topk, greedy_only, row0)
            except BaseException:
                with contextlib.suppress(RuntimeError):   # the tick's error, not
                    graph.capture_end()                   # the aborted capture's
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        pool_bytes = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                         if tuple(seg.get("segment_pool_id", ())) == tuple(self._pool))
        self.graph_captures.append({
            "key": {"B": B, "n_host": row0, "capacity": key[2], "pos_cap": cap,
                    "use_topk": use_topk, "greedy_only": greedy_only},
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_bytes": pool_bytes, "launches_per_replay": dict(launches)})
        rec = self._graphs[key] = (graph, launches)
        return rec

    @contextlib.contextmanager
    def _scratch(self, c: _Carry) -> Iterator[_Carry]:
        """Swap in zeroed scratch copies of what a tick writes -- the cache
        (one buffer set per layer shape, shared by the layers of that
        shape), the drop and load counters -- and yield a copy of the carry,
        so a warm-up tick leaves the served state as it was."""
        saved = (self.cache, self._kept_dev, self._dropped_dev, self._load_dev)
        shared: Dict[Tuple, Dict[str, torch.Tensor]] = {}

        def scratch(layer):
            shape = tuple((k, tuple(v.shape)) for k, v in sorted(layer.items()))
            if shape not in shared:
                shared[shape] = {k: torch.zeros_like(v) for k, v in layer.items()}
            return shared[shape]

        self.cache = [scratch(layer) for layer in saved[0]]
        self._kept_dev, self._dropped_dev, self._load_dev = (
            torch.zeros_like(t) for t in saved[1:])
        try:
            yield c.clone()
        finally:
            self.cache, self._kept_dev, self._dropped_dev, self._load_dev = saved

    @hot_path
    def decode_step_sampled(self, tokens, pos, sampler: BatchSampler,
                            slots=None) -> torch.Tensor:
        """One decode tick plus per-slot sampling on the device: the fused
        chunk with T = 1 when eligible, else ``decode_step`` and
        ``sampler.sample``.  Returns the (B,) next tokens."""
        if slots is None and self.fused_eligible() and self.cache is not None:
            return self.decode_chunk(tokens, pos, sampler, 1)[:, 0]
        return sampler.sample(self.decode_step(tokens, pos), slots)

    # -- generation -------------------------------------------------------
    def generate(self, tokens, decode_len: int, frontend_emb=None, lengths=None,
                 sampling=None, chunk: Optional[int] = None) -> torch.Tensor:
        """Generation -- greedy by default (the paper's strategy, §B); pass
        ``sampling`` (``serving.sampling.SamplingParams``) for seeded
        temperature / top-k decoding, each row's index folded into its key.
        ``lengths`` (B,) generates from a ragged right-padded batch, each
        sequence at its own positions.  Decode runs in chunks of ``chunk``
        ticks (default: the plan's ``decode_chunk``), fused when eligible.
        ``frontend_emb`` (B, F, D) replaces the prompts' first F positions'
        embeddings.  Returns (B, decode_len) tokens on the device."""
        B, S = tokens.shape
        sampler = BatchSampler.uniform(B, sampling)
        logits = self.prefill(tokens, frontend_emb, lengths=lengths)
        cols = [sampler.sample(logits)]
        base = (np.full(B, S, np.int64) if lengths is None
                else np.asarray(lengths, np.int64))
        step = max(1, chunk if chunk is not None else self.plan.decode_chunk)
        t, total = 0, decode_len - 1
        while t < total:
            Tc = min(step, total - t)
            mat = self.decode_chunk(cols[-1], base + t, sampler, Tc)
            cols.extend(mat[:, j] for j in range(Tc))
            t += Tc
        result = torch.stack(cols, dim=1)
        self.sync_stats()
        return result
