"""Request-lifecycle serving: one step-driven core under both schedulers.

``Server`` is the serving facade over ``ModuleBatchingEngine`` +
``ParamStore``: requests are submitted (``submit(Request) ->
RequestHandle``), become admissible at their ``arrival_s`` offset on a
virtual clock keyed off wall time, and are driven by ``step()`` -- one
module-batched decode tick that admits due arrivals, decodes every live
slot, samples each slot, and evicts/recycles finished sequences.  ``run()``
loops ``step()`` (sleeping through idle gaps until the next arrival) and
returns the ``ServeReport``.

The two scheduler modes are admission policies over that single core:

Each step decodes one chunk of ``T`` ticks (``_chunk_T``): the engine's
fused chunk when it is eligible -- on the card, T replays of the tick's CUDA
graph -- with one token read per chunk.  ``T`` is capped by
``ServeConfig.decode_chunk`` (or the plan's) and clamped to the shortest
remaining decode, so every finish lands on a chunk boundary.

* ``static`` -- the paper's offline protocol (§5.1): requests are admitted
  in waves, a new wave only once the previous one has fully drained; every
  wave slot keeps stepping until the wave's slowest member finishes (early
  finishers are counted in ``wasted_slot_steps``).
* ``continuous`` -- in-flight batching: a finished sequence's slot and KV
  rows are evicted at once and the freed slot is recycled by prefilling the
  next due request into it; with ``ServeConfig.hw`` set, admission is gated
  by the Eq. 2 host KV budget (counted in ``admission_deferrals``).

Both modes give identical tokens per request when the plan's expert
capacity ``b_e`` admits every routed copy.  Per-request latencies
(``queue_wait_s``, ``ttft_s``, ``tpot_s``) are measured on the virtual
clock.

``ServeConfig.kv_page_tokens`` pages the KV cache (``serving.cache``) and
``device_kv_gb`` caps its device pool, the rest of the frames living in
page-locked host memory (Mode B); each admitted slot's frames are reserved
before its prefill, and the Eq. 2 admission charge is page-rounded.  The
plan's omega sends the first ``round(omega * B)`` slots' attention to the
host CPU.  ``prefix_cache`` (with paging) admits a request whose
page-aligned prompt prefix was seen before by copying the stored prefix KV
into its row and prefilling only the suffix (``serving.cache.PrefixStore``);
``replan_skew`` re-derives the decode capacity ``b_e`` from the measured
routing every 8 decode steps when the hottest expert's share drifts.

Fault tolerance (``repro_torch.faults``, the reference's semantics): the
server arms its ``ServeConfig.faults`` plan around every step, so the copy,
page and preemption seams draw from one schedule.  A page-frame OOM at
admission walks the degradation ladder (defer, demote device frames, halve
the chunk cap for 16 steps); ``preempt(handle)`` (continuous scheduler)
moves a running request to a host checkpoint and resumes it into a free
slot with no prefill; recovery is counted in the report.  Unarmed, the
served path is the same as without the package.  Replica failover is the
distributed slice of the port (``distributed.replicas.ReplicaServer``).
"""
from __future__ import annotations

import heapq
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch import faults
from repro_torch.analysis import runtime as sanitizer
from repro_torch.analysis.markers import hot_path
from repro_torch.analysis.spans import span
from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import Plan
from repro_torch.core.hardware import HardwareProfile
from repro_torch.device import resolve_device
from repro_torch.serving.sampling import BatchSampler, SamplingParams
from repro_torch.serving.weights import ParamStore


# ---------------------------------------------------------------------------
# Requests, configs, results
# ---------------------------------------------------------------------------
@dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    decode_len: int
    arrival_s: float = 0.0        # admissible-from offset on the virtual clock
    sampling: Optional[SamplingParams] = None   # None = greedy


@dataclass(frozen=True)
class ServeConfig:
    """Scheduling-side knobs, frozen.  ``decode_len`` is the fallback for
    requests whose own field is zero/None; ``hw`` enables Eq. 2
    memory-gated admission in the continuous scheduler.  ``from_plan``
    sizes ``max_batch``/``max_seq`` with the planner up front.
    ``kv_page_tokens > 0`` pages the KV cache; ``device_kv_gb`` caps the
    device page pool (None: every frame on the device); ``prefix_cache``
    (which needs paging) reuses shared prompt prefixes.  ``replan_skew``
    re-plans ``b_e`` online whenever the hottest expert's measured share
    drifts by more than it (absolute share), sized for an expected drop
    rate of ``replan_drop_target``; None disables re-planning.  ``faults``
    is a fault-injection schedule (a ``faults.FaultPlan``, ``FaultSpec`` or
    spec string such as ``"seed=0,transfer=0.05,oom=0.1,preempt=8"``); None
    leaves any ambient ``REPRO_FAULTS`` plan in charge.  ``sctx`` makes the
    server one rank of an expert-parallel group: every rank serves the same
    requests, its MoE decode stage is collective, and rank 0's clock decides
    every rank's admissions."""

    scheduler: str = "static"
    decode_len: int = 32
    max_seq: Optional[int] = None
    max_prompt_len: Optional[int] = None
    pad_id: int = 0
    eos_id: Optional[int] = None
    expert_path: str = "grouped"         # MoE decode stage: grouped | loop
    grouped_prefill: bool = True         # False: the exact dense-combine
    #                                      prefill MoE (no capacity probe)
    hw: Optional[HardwareProfile] = None
    max_batch: Optional[int] = None      # engine slots (None = sized at the
    #                                      first step from the submitted queue)
    plan: Optional[Plan] = None          # planner-produced Plan (from_plan)
    kv_page_tokens: int = 0
    device_kv_gb: Optional[float] = None
    prefix_cache: bool = False
    replan_skew: Optional[float] = None
    replan_drop_target: float = 0.01
    faults: Optional[object] = None
    decode_chunk: Optional[int] = None   # fused chunk T cap (None = plan's)
    sctx: Optional[object] = None        # sharding.specs.ShardCtx naming a
    #   torch.distributed group: the engine is one rank of an expert-parallel
    #   group (distributed.ep_engine); None = single-device
    ep_chunks: int = 1                   # pipeline chunks of the a2a MoE stage
    #   (chunk k+1's exchange is posted before chunk k's FFN); 1 = one chunk

    def __post_init__(self) -> None:
        assert self.scheduler in ("static", "continuous"), self.scheduler
        assert self.expert_path in ("grouped", "loop"), self.expert_path
        assert self.kv_page_tokens >= 0, self.kv_page_tokens
        if self.prefix_cache:
            assert self.kv_page_tokens > 0, (
                "prefix_cache requires paging (kv_page_tokens > 0)"
            )
        if self.max_batch is not None:
            assert self.max_batch >= 1, self.max_batch

    @classmethod
    def from_plan(cls, cfg: ModelConfig, hw: HardwareProfile, ctx: int = 512,
                  scheduler: str = "continuous", B: Optional[int] = None,
                  **overrides) -> "ServeConfig":
        """Run ``planner.search_decode(cfg, hw, ctx)`` and pin ``max_batch``
        to the plan's B, ``max_seq`` to ``ctx`` and ``hw`` for gated
        admission; the Plan rides along in ``.plan``."""
        from repro_torch.core.planner import search_decode

        plan = search_decode(cfg, hw, ctx, B=B, scheduler=scheduler,
                             decode_len=overrides.get("decode_len")).plan
        kw = dict(scheduler=scheduler, max_seq=ctx, max_batch=plan.B,
                  hw=hw, plan=plan)
        kw.update(overrides)
        return cls(**kw)


@dataclass(frozen=True)
class StreamConfig:
    """Weight-residency knobs for the ``ParamStore`` the server builds
    (ignored when a built ``store`` is passed)."""

    stream_weights: bool = False
    resident_bytes: Optional[float] = None
    prefetch: bool = True
    predict_topk: Optional[int] = None   # per-expert predictive streaming
    #   (None = follow the plan's predict_topk; 0 forces whole-stack)
    lru_bytes: Optional[float] = None    # hot-expert device LRU budget
    #   (None = the residency plan's spare bytes)


@dataclass
class BatchResult:
    tokens: np.ndarray            # (B, decode_len) raw batch tokens (static)
    prefill_s: float
    decode_s: float
    expert_tokens_dropped: int = 0   # routed copies over the b_e capacity


@dataclass
class RequestResult:
    index: int                    # position in the input request list
    tokens: np.ndarray            # (n,) generated tokens (<= decode_len; EOS cut)
    latency_s: float              # admission -> last token (incl. its prefill)
    decode_steps: int             # decode steps while this request was live
    arrival_s: float = 0.0        # admissible-from offset (virtual clock)
    queue_wait_s: float = 0.0     # arrival -> admission
    ttft_s: float = 0.0           # arrival -> first token
    tpot_s: float = 0.0           # mean per-token latency after the first


@dataclass
class ServeReport:
    results: List[BatchResult] = field(default_factory=list)
    request_results: List[RequestResult] = field(default_factory=list)
    scheduler: str = "static"
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_slot_steps: int = 0    # decode steps x batch slots executed
    wasted_slot_steps: int = 0    # slot-steps spent on finished/empty slots
    admission_deferrals: int = 0  # admissions blocked by the Eq. 2 KV budget
    prefill_tokens: int = 0       # token-positions computed in prefill (the
    #                               suffix only, for a prefix-cache hit)
    prefix_hits: int = 0          # admissions served from the prefix cache
    prefix_misses: int = 0        # eligible admissions that prefilled cold
    capacity_replans: int = 0     # online b_e re-plans on measured skew drift
    # fault recovery (repro_torch.faults): every recovery is counted
    transfer_retries: int = 0     # injected copy failures recovered by retry
    transfer_timeouts: int = 0    # dead copies recovered by a demand re-fetch
    preemptions: int = 0          # running requests moved to host checkpoints
    resumes: int = 0              # checkpoints resumed (no prefill)
    degrade_deferrals: int = 0    # admissions deferred by a page-frame OOM
    page_demotions: int = 0       # device page frames demoted to the host tier
    chunk_shrinks: int = 0        # decode-chunk cap halvings under pressure
    checkpoint_bytes: int = 0     # host bytes of the preemption checkpoints
    checkpoint_s: float = 0.0     # host wall of the checkpoints (reads waited for)
    restore_s: float = 0.0        # host wall of the resumes (writes queued)
    admission_waves: List[Tuple[int, List[int]]] = field(default_factory=list)
    #                               (decode tick, request indices) a prefill wave
    weight_htod_bytes: int = 0    # streamed weight bytes copied host->device
    kv_htod_bytes: int = 0        # host KV-page bytes copied host->device
    kv_dtoh_bytes: int = 0        # KV-page bytes written to the host tier
    host_attn_tokens: int = 0     # decode rows x attention layers on the host
    a2a_bytes: int = 0            # bytes the expert-parallel MoE stage
    #                               exchanged (a2a dispatch + return)
    collective_dispatches: int = 0  # expert-parallel MoE stages run
    clock_broadcasts: int = 0     # rank 0's clock broadcast to the group (a step)
    failovers: int = 0            # dead replicas failed over (ReplicaServer)
    requeued_requests: int = 0    # requests requeued onto surviving replicas
    prefetch_wait_s: float = 0.0  # compute stream's wait on weight copies
    expert_pred_hits: int = 0     # expert was staged by the l+1 prediction
    expert_pred_misses: int = 0   # fetched on demand (mispredicted or cold)
    expert_lru_hits: int = 0      # served from the hot-expert device LRU
    _expert_dropped: int = 0      # drops counted outside BatchResults
    expert_dropped_by_layer: Optional[np.ndarray] = None  # (n_moe,) drops
    expert_load: Optional[np.ndarray] = None  # (n_moe, E) routed-copy hist

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def htod_gb(self) -> float:
        """Streamed weight traffic in GB (0 when everything is resident)."""
        return self.weight_htod_bytes / 1e9

    @property
    def a2a_gb(self) -> float:
        """Expert-parallel all-to-all traffic in GB (0 without a group)."""
        return self.a2a_bytes / 1e9

    @property
    def kv_htod_gb(self) -> float:
        """Host KV-page traffic in GB (0 without a host tier)."""
        return self.kv_htod_bytes / 1e9

    @property
    def kv_dtoh_gb(self) -> float:
        """KV-page traffic to the host tier in GB (0 without one)."""
        return self.kv_dtoh_bytes / 1e9

    @property
    def prefix_hit_rate(self) -> float:
        n = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / n if n else 0.0

    @property
    def pred_hit_rate(self) -> float:
        """Share of the decode stage's expert fetches that the prediction
        had already issued."""
        n = self.expert_pred_hits + self.expert_pred_misses
        return self.expert_pred_hits / n if n else 0.0

    @property
    def lru_hit_rate(self) -> float:
        """Share of the decode stage's expert uses served from the LRU."""
        n = self.expert_pred_hits + self.expert_pred_misses + self.expert_lru_hits
        return self.expert_lru_hits / n if n else 0.0

    @property
    def decode_tokens(self) -> int:
        """Valid generated tokens (per-request decode_len / EOS honored)."""
        return sum(r.tokens.size for r in self.request_results)

    @property
    def expert_tokens_dropped(self) -> int:
        return self._expert_dropped + sum(
            r.expert_tokens_dropped for r in self.results
        )

    @property
    def routing_skew(self) -> float:
        """Hottest expert's share of routed copies as a multiple of the
        balanced share ``1/E`` (0.0 when nothing was measured)."""
        if self.expert_load is None:
            return 0.0
        per_expert = self.expert_load.sum(axis=0)
        total = per_expert.sum()
        if total <= 0:
            return 0.0
        return float(per_expert.max() / total * per_expert.size)

    @property
    def decode_throughput(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s > 0 else 0.0

    @property
    def prefill_throughput(self) -> float:
        return self.prefill_tokens / self.prefill_s if self.prefill_s > 0 else 0.0

    @property
    def occupancy(self) -> float:
        """Fraction of executed decode slot-steps that produced live tokens."""
        if self.decode_slot_steps == 0:
            return 1.0
        return 1.0 - self.wasted_slot_steps / self.decode_slot_steps

    @property
    def mean_latency_s(self) -> float:
        rr = self.request_results
        return sum(r.latency_s for r in rr) / len(rr) if rr else 0.0

    @property
    def mean_queue_wait_s(self) -> float:
        rr = self.request_results
        return sum(r.queue_wait_s for r in rr) / len(rr) if rr else 0.0

    @property
    def mean_ttft_s(self) -> float:
        rr = self.request_results
        return sum(r.ttft_s for r in rr) / len(rr) if rr else 0.0

    @property
    def mean_tpot_s(self) -> float:
        rr = self.request_results
        return sum(r.tpot_s for r in rr) / len(rr) if rr else 0.0

    def ttft_percentile(self, q: float) -> float:
        rr = self.request_results
        return float(np.percentile([r.ttft_s for r in rr], q)) if rr else 0.0

    def tpot_percentile(self, q: float) -> float:
        rr = self.request_results
        return float(np.percentile([r.tpot_s for r in rr], q)) if rr else 0.0


def pad_requests(requests, pad_id: int = 0,
                 max_prompt_len: Optional[int] = None):
    """Right-pad a request chunk to its longest prompt.  Returns
    ``(tokens (B, S), lengths (B,))``; the lengths make padding exact."""
    prompts = []
    for r in requests:
        p = np.asarray(r.prompt, np.int32).reshape(-1)
        if max_prompt_len is not None:
            p = p[:max_prompt_len]
        prompts.append(p)
    lengths = np.asarray([len(p) for p in prompts], np.int32)
    S = max(1, int(lengths.max())) if prompts else 1
    out = np.full((len(requests), S), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, : len(p)] = p
    return out, lengths


# ---------------------------------------------------------------------------
# Request lifecycle
# ---------------------------------------------------------------------------
class RequestHandle:
    """A submitted request's live view: status, the token stream as it is
    produced, and the timing marks the metrics derive from.  Pass
    ``on_token=`` to ``Server.submit`` for a per-token callback, or iterate
    ``handle.stream()``, which drives ``Server.step()``.

    The handle holds its ``Server`` by a weak reference: the server lists
    its handles, so a strong one would make a cycle that keeps the engine's
    cache alive after ``del server`` until the cycle collector runs.  A
    finished handle keeps its tokens and ``result()`` without the server."""

    def __init__(self, server: "Server", index: int, request: Request,
                 prompt: np.ndarray, decode_len: int,
                 on_token: Optional[Callable] = None) -> None:
        self._server = weakref.ref(server)
        self.index = index
        self.request = request
        self.prompt = prompt              # truncated to max_prompt_len
        self.decode_len = decode_len      # resolved fallback applied
        self.sampling = request.sampling
        self.arrival_s = float(request.arrival_s or 0.0)
        self.on_token = on_token
        self.status = "queued"            # queued -> running -> finished,
        #                                   running <-> preempted
        self.tokens: List[int] = []
        self.admit_s = float("nan")
        self.first_token_s = float("nan")
        self.finish_s = float("nan")
        self.decode_steps = 0

    @property
    def finished(self) -> bool:
        return self.status == "finished"

    def _emit(self, token: int) -> None:
        self.tokens.append(token)
        if self.on_token is not None:
            self.on_token(self, token)

    def stream(self) -> Iterator[int]:
        """Yield tokens as they are produced, driving the server forward."""
        sent = 0
        while True:
            while sent < len(self.tokens):
                yield self.tokens[sent]
                sent += 1
            if self.finished:
                return
            server = self._server()
            if server is None:
                raise RuntimeError(
                    f"request {self.index} is {self.status} and its Server "
                    f"is gone: keep the Server alive until it finishes")
            server._wait_for_arrival()
            server.step()
            del server

    def result(self) -> RequestResult:
        assert self.finished, f"request {self.index} is {self.status}"
        n = len(self.tokens)
        return RequestResult(
            index=self.index,
            tokens=np.asarray(self.tokens, np.int32),
            latency_s=self.finish_s - self.admit_s,
            decode_steps=self.decode_steps,
            arrival_s=self.arrival_s,
            queue_wait_s=self.admit_s - self.arrival_s,
            ttft_s=self.first_token_s - self.arrival_s,
            tpot_s=(self.finish_s - self.first_token_s) / max(1, n - 1),
        )


# ---------------------------------------------------------------------------
# The server
# ---------------------------------------------------------------------------
class Server:
    """Facade over ``ModuleBatchingEngine`` + ``ParamStore``: submit
    requests, drive them with ``step()`` / ``run()``, read the report.

    The engine (and its ``plan.B``-slot cache) is built lazily at the first
    step, sized ``min(plan.B, submitted requests)`` unless
    ``ServeConfig.max_batch`` pins it.  ``device`` is where the engine runs
    (``cuda`` by default; raises without CUDA).  With a built ``store``
    (e.g. ``ParamStore.seeded`` for a model larger than the card),
    ``params`` may be None."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict,
        plan: Optional[Plan] = None,
        serve: ServeConfig = ServeConfig(),
        stream: StreamConfig = StreamConfig(),
        store: Optional[ParamStore] = None,
        device="cuda",
    ) -> None:
        if plan is None:
            plan = serve.plan
        assert plan is not None, (
            "pass a Plan, or a ServeConfig built by ServeConfig.from_plan"
        )
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.plan = plan
        self.serve = serve
        self.stream = stream
        self.report = ServeReport(scheduler=serve.scheduler)
        self._store = store
        # the prefix cache (paging on; attention-only, no sliding window: SSM
        # state and ring alignment make a prefix non-transplantable, so an
        # unsupported model serves without it)
        self._prefix = None
        cc = self._cache_config()
        if cc is not None and cc.prefix_cache:
            from repro_torch.serving.cache import PrefixStore

            if PrefixStore.supported(cfg):
                self._prefix = PrefixStore(cc.page_tokens)
        # online capacity re-plan: the hottest expert's share at the last
        # (re-)plan (None until the first measurement) and the step count
        self._replan_share: Optional[float] = None
        self._replan_ticks = 0
        self._engine = None               # ModuleBatchingEngine, built lazily
        self._sampler: Optional[BatchSampler] = None
        self._handles: List[RequestHandle] = []
        self._pending: List = []          # heap of (arrival_s, index, handle)
        self._t0: Optional[float] = None
        self._max_seq: Optional[int] = serve.max_seq
        self._seen: Dict[str, float] = {}   # engine counters already drained
        # Eq. 2 admission budget (continuous): every in-flight sequence's
        # offloaded KV at its FULL prompt+decode extent must fit m_c - S_Model
        self._kv_budget = (
            None if serve.hw is None or serve.scheduler != "continuous"
            else _host_kv_budget(cfg, serve.hw)
        )
        self._kv_need: Dict[int, float] = {}
        self._live_kv = 0.0
        # slot state (allocated with the engine)
        self._b = 0
        self._free: deque = deque()
        self._slot_handle: List[Optional[RequestHandle]] = []
        self._cur: Optional[np.ndarray] = None
        self._pos: Optional[np.ndarray] = None
        self._wave: Optional[Dict] = None     # static policy's in-flight wave
        # fault tolerance: the plan armed around every step; preempted
        # requests wait in _ckpts (FIFO) for a slot
        self._faults = faults.resolve(serve.faults)
        self._ckpts: deque = deque()          # host checkpoints of requests
        self._ticks = 0                       # decode ticks run (virtual clock)
        self._preempt_due_at: Optional[int] = None   # next injected preemption
        self._pressure = 0                    # consecutive page-OOM events
        self._shrink_cap: Optional[int] = None   # degraded decode-chunk cap
        self._shrink_ticks = 0                # steps the shrink stays on
        # an expert-parallel rank: the admission clock is rank 0's, broadcast
        # once a step (None: this process's own clock)
        self._group = serve.sctx is not None and serve.sctx.model_size > 1
        self._shared_now: Optional[float] = None

    # -- lifecycle: submit -------------------------------------------------
    def submit(self, request: Request,
               on_token: Optional[Callable] = None) -> RequestHandle:
        """Queue a request; it becomes admissible at ``request.arrival_s``.

        Raises ``ValueError`` for a request that could never be served
        (prompt+decode beyond ``max_seq``, or KV beyond the Eq. 2 budget)
        before touching any server state."""
        serve = self.serve
        prompt = np.asarray(request.prompt, np.int32).reshape(-1)
        if serve.max_prompt_len is not None:
            prompt = prompt[: serve.max_prompt_len]
        dec = max(1, int(request.decode_len or serve.decode_len))
        i = len(self._handles)
        arrival = float(request.arrival_s or 0.0)
        if not np.isfinite(arrival) or arrival < 0:
            raise ValueError(
                f"request {i}: arrival_s must be finite and >= 0, "
                f"got {request.arrival_s!r}"
            )
        limit = self._max_seq
        if limit is not None and len(prompt) + dec > limit:
            raise ValueError(
                f"request {i}: prompt length {len(prompt)} + decode_len "
                f"{dec} exceeds the engine's max_seq={limit}; pass "
                f"max_prompt_len to truncate long prompts"
            )
        if self._kv_budget is not None:
            # the paged cache allocates whole pages: charge the page-rounded
            # extent
            need = W.kv_bytes_per_seq(self.cfg, len(prompt) + dec,
                                      page_tokens=serve.kv_page_tokens)
            if need > self._kv_budget:
                raise ValueError(
                    f"request {i}: KV bytes {need:.3e} can never fit the "
                    f"Eq. 2 host budget {self._kv_budget:.3e}"
                )
            self._kv_need[i] = need
        h = RequestHandle(self, i, request, prompt, dec, on_token)
        self._handles.append(h)
        heapq.heappush(self._pending, (h.arrival_s, i, h))
        return h

    # -- clock -------------------------------------------------------------
    def _now(self) -> float:
        """Virtual clock: seconds since the first step."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def _decision_now(self) -> float:
        """The clock admission decisions read: this process's virtual clock,
        or on an expert-parallel group the step's broadcast of rank 0's, so
        that every rank admits the same requests at the same step."""
        return self._now() if self._shared_now is None else self._shared_now

    def _sync_clock(self) -> None:
        """On an expert-parallel group: rank 0's clock, once a step, outside
        any decode region (a planned collective, ``ep-clock``, counted in
        ``clock_broadcasts``)."""
        if self._group:
            from repro_torch.distributed.ep_engine import broadcast_clock

            self._shared_now = broadcast_clock(self.serve.sctx, self._now())
            self.report.clock_broadcasts += 1

    @property
    def next_arrival_s(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def _wait_for_arrival(self) -> None:
        """Sleep until the next queued arrival when nothing is live."""
        if self._any_live() or not self._pending:
            return
        dt = self.next_arrival_s - self._now()
        if dt > 0:
            time.sleep(min(dt, 0.05))

    # -- engine ------------------------------------------------------------
    def _ensure_engine(self) -> None:
        if self._engine is not None:
            return
        from repro_torch.core.engine import ModuleBatchingEngine

        if self._store is None:
            st = self.stream
            self._store = ParamStore.build(
                self.cfg, self.params, self.plan,
                stream_weights=st.stream_weights, resident_bytes=st.resident_bytes,
                prefetch=st.prefetch, predict_topk=st.predict_topk,
                lru_bytes=st.lru_bytes, device=self.device,
            )
        if self.serve.max_batch is not None:
            self._b = max(1, min(self.plan.B, int(self.serve.max_batch)))
        else:
            self._b = max(1, min(self.plan.B, len(self._handles) or 1))
        if self._max_seq is None:
            self._max_seq = max(
                len(h.prompt) + h.decode_len for h in self._handles
            )
        self._engine = ModuleBatchingEngine(
            self.cfg, self.params, self.plan, max_seq=self._max_seq,
            expert_path=self.serve.expert_path,
            grouped_prefill=self.serve.grouped_prefill, store=self._store,
            cache_config=self._cache_config(),
            device=self.device,
            sctx=self.serve.sctx, ep_chunks=self.serve.ep_chunks,
        )
        self._engine.init_cache(self._b)
        self._sampler = BatchSampler(self._b)
        self._free = deque(range(self._b))
        self._slot_handle = [None] * self._b
        self._cur = np.zeros(self._b, np.int32)
        self._pos = np.zeros(self._b, np.int64)

    def _cache_config(self):
        """The ``CacheConfig`` of the serve knobs (None: contiguous)."""
        if self.serve.kv_page_tokens <= 0:
            return None
        from repro_torch.serving.cache import CacheConfig

        budget = (None if self.serve.device_kv_gb is None
                  else float(self.serve.device_kv_gb) * 1e9)
        return CacheConfig(page_tokens=self.serve.kv_page_tokens, device_pool_bytes=budget,
                           prefix_cache=self.serve.prefix_cache)

    # engine counters the report folds as deltas since the last drain
    _FOLDED = ("weight_htod_bytes", "prefetch_wait_s", "expert_pred_hits",
               "expert_pred_misses", "expert_lru_hits", "kv_htod_bytes",
               "kv_dtoh_bytes", "host_attn_tokens", "transfer_retries",
               "transfer_timeouts", "a2a_bytes", "collective_dispatches")

    def _drain_engine_stats(self, planned: bool = False) -> int:
        """Fold the engine's cumulative counters into the report (deltas
        since the last drain); returns the expert-drop delta.  ``planned``:
        the engine's read is a planned, counted one (between decode steps)."""
        if self._engine is None:
            return 0
        st = self._engine.sync_stats(planned=planned)
        seen = self._seen
        d_drop = st.expert_tokens_dropped - seen.get("drop", 0)
        seen["drop"] = st.expert_tokens_dropped
        for name in self._FOLDED:
            now = getattr(st, name)
            setattr(self.report, name, getattr(self.report, name) + now
                    - seen.get(name, 0))
            seen[name] = now
        if st.expert_tokens_dropped_by_layer is not None:
            self.report.expert_dropped_by_layer = (
                st.expert_tokens_dropped_by_layer.copy()
            )
            self.report.expert_load = st.expert_load.copy()
        return d_drop

    def _maybe_replan(self) -> None:
        """Online imbalance-aware capacity re-plan: when the hottest
        expert's measured share has drifted more than ``replan_skew`` since
        the last (re-)plan, re-derive ``b_e`` from the measured per-expert
        load (``planner.capacity_for_load``) and push it into the engine
        (``set_expert_capacity``: the next fused chunk captures one graph).
        Checked every 8 decode steps; the counters come down in one planned
        read, so the check is no hidden sync."""
        self._replan_ticks += 1
        if self._replan_ticks % 8:
            return
        self.report._expert_dropped += self._drain_engine_stats(planned=True)
        if self.report.expert_load is None:
            return
        per_expert = self.report.expert_load.sum(axis=0)
        total = per_expert.sum()
        if total <= 0:
            return
        share = float(per_expert.max() / total)
        if self._replan_share is None:
            self._replan_share = share       # baseline, no re-plan yet
            return
        if abs(share - self._replan_share) <= self.serve.replan_skew:
            return
        from repro_torch.core.planner import capacity_for_load

        b_e = capacity_for_load(per_expert, self._b, self.cfg.experts_per_token,
                                max_drop_rate=self.serve.replan_drop_target)
        self._engine.set_expert_capacity(b_e)
        self._replan_share = share
        self.report.capacity_replans += 1

    # -- the step-driven core ---------------------------------------------
    def _any_live(self) -> bool:
        return any(h is not None for h in self._slot_handle)

    def has_work(self) -> bool:
        return self._any_live() or bool(self._pending) or bool(self._ckpts)

    def step(self) -> bool:
        """One scheduler tick: admit due arrivals (policy-dependent), run
        one module-batched decode step over every slot, sample each live
        slot, finish/evict/recycle.  Returns True while work remains (live
        slots, queued requests or preempted checkpoints).  The tick runs
        with the server's fault plan armed (a pass-through to the ambient
        ``REPRO_FAULTS`` plan when ``ServeConfig.faults`` is None)."""
        if not self.has_work():
            return False
        self._ensure_engine()
        self._sync_clock()
        with faults.armed(self._faults):
            self._maybe_preempt()
            self._admit()
            if self._any_live():
                self._decode_tick(self._chunk_T())
                if self.serve.replan_skew is not None:
                    self._maybe_replan()
        return self.has_work()

    def run(self, until_idle: bool = True) -> ServeReport:
        """Drive ``step()`` to completion and return the report.
        ``until_idle=False`` stops at the first moment nothing is live or
        due instead of sleeping for future arrivals."""
        while self.step():
            if not self._any_live() and self._pending:
                if not until_idle and self.next_arrival_s > self._decision_now():
                    break
                self._wait_for_arrival()
        return self.finalize()

    def finalize(self) -> ServeReport:
        """Drain engine counters and order results; idempotent."""
        self.report._expert_dropped += self._drain_engine_stats()
        if self._prefix is not None:
            self.report.prefix_hits = self._prefix.hits
            self.report.prefix_misses = self._prefix.misses
        self.report.request_results.sort(key=lambda r: r.index)
        return self.report

    # -- admission policies ------------------------------------------------
    def _pop_due(self, now: float) -> Optional[RequestHandle]:
        """Pop the queue head if it has arrived (FIFO in arrival order)."""
        if self._pending and self._pending[0][0] <= now:
            return heapq.heappop(self._pending)[2]
        return None

    def _admit(self) -> None:
        if self.serve.scheduler == "static":
            self._admit_static()
        else:
            self._admit_continuous()

    def _admit_static(self) -> None:
        """Admit-in-waves: a new wave only once the previous wave has fully
        drained; the wave takes every due request up to B slots."""
        if self._wave is not None:
            return
        now = self._decision_now()
        handles: List[RequestHandle] = []
        while len(handles) < self._b:
            h = self._pop_due(now)
            if h is None:
                break
            # frames before prefill: an OOM (real or injected) requeues the
            # head and degrades instead of failing mid-prefill
            try:
                self._engine.reserve_slot_rows([len(handles)])
            except faults.PageAllocOOM as err:
                heapq.heappush(self._pending, (h.arrival_s, h.index, h))
                self._degrade_on_oom(err)
                break
            self._pressure = 0
            handles.append(h)
        if not handles:
            return
        slots = list(range(len(handles)))
        self._wave = {
            "slots": slots, "handles": handles,
            "rows": [[] for _ in slots], "done": [False] * len(slots),
            "ticks": 0, "prefill_s": 0.0, "decode_s": 0.0,
        }
        self._prefill_wave(handles, slots)
        if all(self._wave["done"]):
            self._close_wave()

    def _admit_continuous(self) -> None:
        """Admit/evict: prefill due requests into freed slots (one batched
        prefill per admission wave; loop until stable).  With an Eq. 2
        budget the queue head WAITS while its KV bytes don't fit (FIFO).
        Preempted checkpoints resume first (they were admitted before
        anything still queued)."""
        now = self._decision_now()
        self._resume_checkpoints()
        blocked = False
        while not blocked and self._free and self._pending and self._pending[0][0] <= now:
            slots, handles = [], []
            while self._free and self._pending and self._pending[0][0] <= now:
                i = self._pending[0][1]
                if (self._kv_budget is not None
                        and self._live_kv + self._kv_need[i] > self._kv_budget):
                    break              # head waits for an eviction
                h = heapq.heappop(self._pending)[2]
                s = self._free.popleft()
                # frames before prefill: an OOM (real or injected) puts the
                # head back and degrades instead of failing mid-prefill
                try:
                    self._engine.reserve_slot_rows([s])
                except faults.PageAllocOOM as err:
                    self._free.appendleft(s)
                    heapq.heappush(self._pending, (h.arrival_s, h.index, h))
                    self._degrade_on_oom(err)
                    blocked = True
                    break
                self._pressure = 0
                slots.append(s)
                handles.append(h)
                if self._kv_budget is not None:
                    self._live_kv += self._kv_need[i]
            if not handles:
                break
            self._prefill_wave(handles, slots)
        # counted once per admission attempt: the head is due but blocked by
        # memory despite a free slot
        if (self._kv_budget is not None and self._free and self._pending
                and self._pending[0][0] <= now
                and self._live_kv + self._kv_need[self._pending[0][1]]
                > self._kv_budget):
            self.report.admission_deferrals += 1

    # -- fault tolerance: preempt / checkpoint / resume --------------------
    def preempt(self, handle: RequestHandle) -> bool:
        """Move a running request to a host checkpoint (its KV and state
        rows, current token and position; the sampler restores from the
        handle).  Its slot, page frames and sampler slot are freed; the
        checkpoint resumes into a free slot with no prefill, and since a
        slot's t-th token depends only on (logits, seed, t), the resumed
        stream is the one an unpreempted run gives.  Continuous scheduler
        only (a static wave drains in place).  False when the request is not
        running."""
        assert self.serve.scheduler == "continuous", (
            "preemption is a continuous-scheduler policy")
        if handle.status != "running":
            return False
        self._preempt_slot(self._slot_handle.index(handle))
        return True

    def _preempt_slot(self, s: int) -> None:
        h = self._slot_handle[s]
        t0 = time.perf_counter()
        state = self._engine.checkpoint_slot(s)
        self.report.checkpoint_s += time.perf_counter() - t0
        self.report.checkpoint_bytes += state.nbytes
        ckpt = {"handle": h, "state": state, "cur": int(self._cur[s]), "pos": int(self._pos[s])}
        h.status = "preempted"
        if self._kv_budget is not None:
            self._live_kv -= self._kv_need[h.index]
        self._slot_handle[s] = None
        self._sampler.clear_slot(s)
        self._engine.evict_slots([s])
        self._free.append(s)
        self._ckpts.append(ckpt)
        self.report.preemptions += 1
        faults.note("preempt")

    def _resume_checkpoints(self) -> None:
        """Resume preempted checkpoints (FIFO) into free slots: the rows are
        written back (``engine.restore_slot``), the sampler slot is re-armed
        at the token index already emitted, the token and position are
        restored.  No prefill runs.  A page OOM leaves the checkpoint
        queued and degrades."""
        while self._ckpts and self._free:
            h = self._ckpts[0]["handle"]
            if (self._kv_budget is not None
                    and self._live_kv + self._kv_need[h.index] > self._kv_budget):
                break
            s = self._free[0]
            t0 = time.perf_counter()
            try:
                self._engine.restore_slot(s, self._ckpts[0]["state"])
            except faults.PageAllocOOM as err:
                self._degrade_on_oom(err)
                break
            self.report.restore_s += time.perf_counter() - t0
            self._pressure = 0
            ckpt = self._ckpts.popleft()
            self._free.popleft()
            self._sampler.set_slot(s, h.sampling)
            self._sampler.advance([s], len(h.tokens))
            self._slot_handle[s] = h
            self._cur[s] = ckpt["cur"]
            self._pos[s] = ckpt["pos"]
            if self._kv_budget is not None:
                self._live_kv += self._kv_need[h.index]
            h.status = "running"
            self.report.resumes += 1
            faults.note("resume")

    def _maybe_preempt(self) -> None:
        """Injected preemption: every ``spec.preempt_every`` decode ticks,
        preempt the running request in the lowest slot (continuous only).
        The checkpoint resumes at the next admission and the tick clock
        advances only while decoding, so every cycle decodes."""
        if self.serve.scheduler != "continuous":
            return
        fp = faults.current()
        if fp is None or fp.spec.preempt_every <= 0:
            return
        if self._preempt_due_at is None:
            self._preempt_due_at = fp.spec.preempt_every
        if self._ticks < self._preempt_due_at:
            return
        victims = [s for s in range(self._b) if self._slot_handle[s] is not None
                   and not self._slot_handle[s].finished]
        if not victims:
            return
        self._preempt_due_at = self._ticks + fp.spec.preempt_every
        fp.note("injected:preempt")
        self._preempt_slot(min(victims))

    def _degrade_on_oom(self, err: Exception) -> None:
        """The memory-pressure ladder, escalating with consecutive OOMs: (1)
        defer the admission (the caller put the request back); (2) demote
        live device page frames to the host tier; (3) halve the decode-chunk
        cap for 16 steps.  Re-raises only when nothing can ever free a frame:
        no fault plan armed and nothing live."""
        if faults.current() is None and not self._any_live():
            raise err
        self._pressure += 1
        self.report.degrade_deferrals += 1
        faults.note("recovered:admission-deferral")
        pages = self._engine.pages
        if self._pressure >= 2 and pages is not None:
            self.report.page_demotions += pages.demote_device_frames(pages.pages_per_seq)
        if self._pressure >= 3:
            cap = int(self.serve.decode_chunk or getattr(self.plan, "decode_chunk", 1) or 1)
            base = self._shrink_cap if self._shrink_cap is not None else cap
            self._shrink_cap = max(1, base // 2)
            self._shrink_ticks = 16
            self.report.chunk_shrinks += 1
            faults.note("recovered:chunk-shrink")

    # -- shared prefill / decode / finish ----------------------------------
    def _prefill_wave(self, handles: List[RequestHandle],
                      slots: List[int]) -> None:
        """One batched prefill of ``handles`` into ``slots``: writes their
        KV rows, arms their sampler slots, and emits each request's FIRST
        token (sampled from the prefill logits).

        With the prefix cache on, the wave is partitioned: hits are admitted
        one at a time through ``engine.prefill_prefix_hit`` (the stored
        prefix KV is copied in and only the suffix is computed), misses take
        the batched prefill and then store their prefix rows (one capture
        per prefix not yet stored).  Tokens are the same either way."""
        engine, sampler, prefix = self._engine, self._sampler, self._prefix
        with span("serve.prefill"):
            t0 = self._now()
            self.report.admission_waves.append((self._ticks, [h.index for h in handles]))
            hits, misses, miss_slots = [], list(handles), list(slots)
            if prefix is not None:
                misses, miss_slots = [], []
                for h, s in zip(handles, slots):
                    kp = prefix.key(h.prompt)
                    kvs = None if kp is None else prefix.get(kp[0])
                    if kvs is not None:
                        hits.append((h, s, kp[1], kvs))
                    else:
                        misses.append(h)
                        miss_slots.append(s)
            for h, s in zip(handles, slots):
                sampler.set_slot(s, h.sampling)
            tok0: Dict[int, int] = {}
            if misses:
                self.report.prefill_tokens += sum(len(h.prompt) for h in misses)
                ptoks, lens = pad_requests(misses, self.serve.pad_id)
                lg = engine.prefill_slots(ptoks, miss_slots, lengths=lens)
                tok0.update(zip(miss_slots, sampler.sample(lg, miss_slots).cpu().tolist()))
                if prefix is not None:
                    for h, s in zip(misses, miss_slots):
                        kp = prefix.key(h.prompt)
                        if kp is not None and not prefix.touch(kp[0]):
                            prefix.put(kp[0], engine.read_prefix_rows(s, kp[1]))
            for h, s, pspan, kvs in hits:
                self.report.prefill_tokens += len(h.prompt) - pspan
                lg = engine.prefill_prefix_hit(s, h.prompt, kvs, pspan)
                tok0[s] = int(sampler.sample(lg, [s]).cpu()[0])
            now = self._now()
        self.report.prefill_s += now - t0
        if self._wave is not None:
            self._wave["prefill_s"] += now - t0
        eos = self.serve.eos_id
        for h, s in zip(handles, slots):
            tk = tok0[s]
            self._slot_handle[s] = h
            self._pos[s] = len(h.prompt)
            self._cur[s] = tk
            h.status = "running"
            h.admit_s = t0
            h.first_token_s = now
            h._emit(tk)
            if self._wave is not None:
                self._wave["rows"][s] = [tk]
            if h.decode_len <= 1 or (eos is not None and tk == eos):
                self._finish_slot(s, now)

    def _chunk_T(self) -> int:
        """Decode ticks to run this step as ONE fused chunk.

        When no admission or eviction can fall due mid-chunk, ``T`` decode
        ticks cost one chunk (``engine.decode_chunk``: T graph replays and
        one token read) instead of ``T``.  ``T`` is capped by the
        ``ServeConfig.decode_chunk`` override or the plan's
        ``decode_chunk``, and clamped to the SHORTEST remaining decode
        among unfinished slots, so every finish lands exactly at a chunk
        boundary (timestamps, eviction and §5.1 waste accounting are
        tick-identical to per-tick stepping).  1 when: an ``eos_id`` is set
        (finishes are unpredictable), the engine is not fused-eligible, or
        -- continuous mode -- a queued request could be admitted into a
        free slot mid-chunk."""
        cap = self.serve.decode_chunk or getattr(self.plan, "decode_chunk", 1)
        if self._shrink_ticks > 0:
            # the ladder's third stage: finer chunks recycle frames sooner,
            # back to the configured cap after _shrink_ticks steps
            cap = min(int(cap), self._shrink_cap)
            self._shrink_ticks -= 1
            if self._shrink_ticks == 0:
                self._shrink_cap = None
        fp = faults.current()
        if (fp is not None and fp.spec.preempt_every > 0
                and self.serve.scheduler == "continuous"):
            # an injected preemption lands on a chunk boundary: T stops at
            # the next one (chunking only; the tokens are unchanged)
            due = (self._preempt_due_at if self._preempt_due_at is not None
                   else fp.spec.preempt_every)
            if due > self._ticks:
                cap = min(int(cap), due - self._ticks)
        if cap <= 1 or self.serve.eos_id is not None:
            return 1
        if not self._engine.fused_eligible():
            return 1
        if self._wave is not None:
            rem = [h.decode_len - len(h.tokens)
                   for h, d in zip(self._wave["handles"], self._wave["done"])
                   if not d]
        else:
            if (self._pending or self._ckpts) and self._free:
                return 1               # a due arrival or a resume could admit
            rem = [h.decode_len - len(h.tokens)
                   for h in self._slot_handle
                   if h is not None and not h.finished]
        if not rem:
            return 1
        return max(1, min(int(cap), min(rem)))

    @hot_path
    def _decode_tick(self, T: int = 1) -> None:
        """``T`` module-batched decode ticks over the full engine batch, one
        chunk (the fused chunk when the engine is eligible); live slots
        emit their tokens tick by tick, finishers are handed to the
        policy's finish path.  One token read per chunk."""
        engine, sampler = self._engine, self._sampler
        wave = self._wave
        # rows the scheduler advances each tick: wave slots (finished members
        # keep stepping until the drain) or handle-owning slots
        live = np.zeros(self._b, bool)
        if wave is not None:
            live[wave["slots"]] = True
        else:
            live[[s for s in range(self._b)
                  if self._slot_handle[s] is not None]] = True
        with span("serve.decode"):
            t0 = self._now()
            toks = engine.decode_chunk(self._cur, self._pos, sampler, T, live=live)
            with sanitizer.allowed("token-readback"):
                mat = toks.cpu().numpy()  # lint: allow[MG101] the one planned token read a chunk
            now = self._now()
        self._ticks += T
        self.report.decode_s += now - t0
        if wave is not None:
            wave["decode_s"] += now - t0
        counted = len(wave["slots"]) if wave is not None else self._b
        eos = self.serve.eos_id
        for t in range(T):
            nxt = mat[:, t]
            live_s = [s for s in range(self._b)
                      if self._slot_handle[s] is not None
                      and not self._slot_handle[s].finished]
            self.report.decode_slot_steps += counted
            self.report.wasted_slot_steps += counted - len(live_s)
            for s in live_s:
                h = self._slot_handle[s]
                tk = int(nxt[s])
                h._emit(tk)
                if len(h.tokens) >= h.decode_len or (
                        eos is not None and tk == eos):
                    self._finish_slot(s, now)
            if wave is not None:
                wave["ticks"] += 1
                for s in wave["slots"]:
                    wave["rows"][s].append(int(nxt[s]))
                    self._cur[s] = nxt[s]
                    self._pos[s] += 1
                if all(wave["done"]):
                    self._close_wave()
                    break
            else:
                for s in range(self._b):
                    if self._slot_handle[s] is not None:
                        self._cur[s] = nxt[s]
                        self._pos[s] += 1

    def _finish_slot(self, s: int, now: float) -> None:
        h = self._slot_handle[s]
        h.status = "finished"
        h.finish_s = now
        if self._wave is not None:                      # static: keep the
            self._wave["done"][self._wave["slots"].index(s)] = True
            return                                      # slot until drain
        h.decode_steps = len(h.tokens) - 1
        self.report.request_results.append(h.result())
        if self._kv_budget is not None:
            self._live_kv -= self._kv_need[h.index]
        self._slot_handle[s] = None
        self._sampler.clear_slot(s)
        self._engine.evict_slots([s])
        self._free.append(s)

    def _close_wave(self) -> None:
        """Static wave drained: record its BatchResult and per-request
        results, then free the slots."""
        wave, self._wave = self._wave, None
        ticks = wave["ticks"]
        for h, s in zip(wave["handles"], wave["slots"]):
            h.decode_steps = ticks
            self.report.request_results.append(h.result())
            self._slot_handle[s] = None
            self._sampler.clear_slot(s)
        self._engine.evict_slots(wave["slots"])
        self._free = deque(range(self._b))
        mat = np.asarray([wave["rows"][s] for s in wave["slots"]], np.int64)
        self.report.results.append(BatchResult(
            mat, wave["prefill_s"], wave["decode_s"],
            self._drain_engine_stats(),
        ))


def _host_kv_budget(cfg: ModelConfig, hw: HardwareProfile) -> float:
    from repro_torch.core.planner import host_kv_budget

    return host_kv_budget(cfg, hw)
