"""Data-parallel replica serving: one arrival queue over N ``Server``s.

``ReplicaServer`` fans submitted requests across independent ``Server``
replicas — each replica owns its engine, KV cache and virtual clock (the
data-parallel axis of a ``--mesh dp,ep`` deployment; each replica's engine
may itself be expert-parallel via ``ServeConfig.sctx``).  The prefix cache
is SHARED across replicas (one ``PrefixStore`` of host page rows, so a
prompt prefilled on replica 0 is a prefix hit on replica 1) while KV stays
per-replica.

Routing is pluggable: ``'round-robin'``, ``'least-loaded'`` (fewest
outstanding decode tokens, the default), or any callable
``(servers, request) -> replica index``.

The merged report sums work counters across replicas and takes the
parallel wall-clock (max of the per-replica phase times) — replicas run
concurrently in a real deployment, sequentially interleaved here on one
host, so per-replica reports carry the honest individual timings.

The replicas share ``params``: weights are never written, so N replicas
on one device hold one copy of them beside N engines, caches and graphs.
``device`` is every replica's (``cuda`` unless the caller asks for the
CPU).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import Callable, List, Union

import numpy as np

from repro_torch import faults
from repro_torch.serving.server import (
    Request,
    RequestHandle,
    ServeConfig,
    ServeReport,
    Server,
    StreamConfig,
)

ROUTING_POLICIES = ("round-robin", "least-loaded")


@dataclass
class ReplicaReport:
    """``merged`` carries the fleet view; ``per_replica`` the honest
    individual reports (their own clocks and counters)."""

    merged: ServeReport
    per_replica: List[ServeReport]


class ReplicaServer:
    """Facade matching the ``Server`` submit/run surface over N replicas."""

    def __init__(
        self,
        cfg,
        params,
        n_replicas: int,
        plan=None,
        serve: ServeConfig = ServeConfig(),
        stream: StreamConfig = StreamConfig(),
        policy: Union[str, Callable] = "least-loaded",
        device="cuda",
    ) -> None:
        assert n_replicas >= 1, n_replicas
        if isinstance(policy, str) and policy not in ROUTING_POLICIES:
            raise ValueError(
                f"unknown routing policy {policy!r}; pick one of "
                f"{ROUTING_POLICIES} or pass a callable"
            )
        self.policy = policy
        # ONE resolved fault plan shared by the fleet and every replica
        # (one ledger; the kill schedule is consulted on the fleet's step
        # clock, the stream/page/preempt seams on each replica's)
        self._faults = faults.resolve(serve.faults)
        if self._faults is not None:
            serve = replace(serve, faults=self._faults)
        self.servers = [
            Server(cfg, params, plan, serve, stream, device=device)
            for _ in range(n_replicas)
        ]
        # shared prefix keys, per-replica KV: every replica consults one
        # PrefixStore (host page rows), so replica 1 hits what replica 0
        # prefilled; the device page pools stay replica-local
        if self.servers[0]._prefix is not None:
            for s in self.servers[1:]:
                s._prefix = self.servers[0]._prefix
        self._rr = 0
        self._routes: List[tuple] = []    # global index -> (replica, local)
        # failover state: dead replicas never step again; their unfinished
        # requests are resubmitted from scratch onto survivors (the
        # sampling determinism contract makes the regenerated streams
        # token-identical) and the routes remapped
        self._dead: set = set()
        self._steps = 0                   # fleet step clock (kill schedule)
        self.failovers = 0
        self.requeued = 0

    # -- routing -----------------------------------------------------------
    def _alive(self) -> List[int]:
        return [i for i in range(len(self.servers)) if i not in self._dead]

    def _outstanding(self, server: Server) -> int:
        """Decode tokens still owed by a replica's unfinished requests —
        the least-loaded signal."""
        return sum(h.decode_len for h in server._handles if not h.finished)

    def _pick(self, request: Request) -> int:
        alive = self._alive()
        if callable(self.policy):
            i = int(self.policy(self.servers, request)) % len(self.servers)
            if i in self._dead:
                i = alive[i % len(alive)]
            return i
        if self.policy == "round-robin":
            i = alive[self._rr % len(alive)]
            self._rr += 1
            return i
        loads = [self._outstanding(self.servers[i]) for i in alive]
        return alive[int(np.argmin(loads))]

    # -- Server-shaped surface --------------------------------------------
    def submit(self, request: Request,
               on_token=None) -> RequestHandle:
        i = self._pick(request)
        h = self.servers[i].submit(request, on_token)
        self._routes.append((i, h.index))
        return h

    def has_work(self) -> bool:
        return any(self.servers[i].has_work() for i in self._alive())

    def step(self) -> bool:
        """One interleaved tick: every live replica with work steps once.

        Failure detection: an injected kill (the fault plan's
        ``kill=R@N`` schedule, on this fleet step clock) or a replica
        whose step escapes with a ``faults.FaultError`` (recovery
        exhausted — e.g. ``StreamTimeoutError``) declares the replica
        dead; its unfinished requests fail over to survivors.  Any other
        exception type propagates — bugs abort loudly, they are not
        absorbed by failover."""
        self._steps += 1
        fp = self._faults if self._faults is not None else faults.current()
        for i in self._alive():
            s = self.servers[i]
            if fp is not None and fp.kill_due(i, self._steps):
                self._kill(i)
                continue
            if s.has_work():
                try:
                    s.step()
                except faults.FaultError:
                    self._kill(i)
        return self.has_work()

    def _kill(self, i: int) -> None:
        """Declare replica ``i`` dead and fail over: its unfinished
        requests (queued, running, or preempted — their KV is lost with
        the replica) are resubmitted from scratch onto survivors, and the
        global routes remapped so the merged report carries the
        survivor's token-identical regenerated results.  Requests the
        replica already finished keep their results.  Streaming callbacks
        on failed-over requests re-fire from the first token
        (at-least-once delivery)."""
        self._dead.add(i)
        alive = self._alive()
        if not alive:
            raise faults.FaultError(
                f"replica {i} died with no survivors to fail over to"
            )
        self.failovers += 1
        faults_local = self._faults
        if faults_local is not None:
            faults_local.note("failover")
        back = {(ri, local): g for g, (ri, local) in enumerate(self._routes)}
        for h in self.servers[i]._handles:
            if h.finished:
                continue
            j = alive[self._rr % len(alive)]
            self._rr += 1
            nh = self.servers[j].submit(
                Request(h.prompt, h.decode_len, arrival_s=h.arrival_s,
                        sampling=h.sampling),
                on_token=h.on_token,
            )
            self._routes[back[(i, h.index)]] = (j, nh.index)
            self.requeued += 1
            if faults_local is not None:
                faults_local.note("failover-requeue")
        # the dead replica never steps again — drop its queue/checkpoints
        # so fleet-level idle checks don't see phantom work
        self.servers[i]._pending.clear()
        self.servers[i]._ckpts.clear()

    def _wait_for_arrival(self) -> None:
        waits = [
            s.next_arrival_s - s._now()
            for s in (self.servers[i] for i in self._alive())
            if s._pending and not s._any_live()
        ]
        if waits:
            dt = min(waits)
            if dt > 0:
                time.sleep(min(dt, 0.05))

    def run(self, until_idle: bool = True) -> ReplicaReport:
        while self.step():
            alive = [self.servers[i] for i in self._alive()]
            if (not any(s._any_live() for s in alive)
                    and any(s._pending for s in alive)):
                if not until_idle:
                    break
                self._wait_for_arrival()
        return self.finalize()

    def finalize(self) -> ReplicaReport:
        reports = [s.finalize() for s in self.servers]
        return ReplicaReport(self._merge(reports), reports)

    # -- merging -----------------------------------------------------------
    def _merge(self, reports: List[ServeReport]) -> ServeReport:
        m = ServeReport(scheduler=reports[0].scheduler)
        # parallel wall-clock: replicas run concurrently in deployment, so
        # the fleet phase time is the slowest replica's, while work
        # counters (tokens, bytes, slot-steps) sum
        m.prefill_s = max(r.prefill_s for r in reports)
        m.decode_s = max(r.decode_s for r in reports)
        for r in reports:
            m.results.extend(r.results)
            m.decode_slot_steps += r.decode_slot_steps
            m.wasted_slot_steps += r.wasted_slot_steps
            m.weight_htod_bytes += r.weight_htod_bytes
            m.prefetch_wait_s += r.prefetch_wait_s
            m.admission_deferrals += r.admission_deferrals
            m.kv_htod_bytes += r.kv_htod_bytes
            m.kv_dtoh_bytes += r.kv_dtoh_bytes
            m.prefill_tokens += r.prefill_tokens
            m.host_attn_tokens += r.host_attn_tokens
            m._expert_dropped += r._expert_dropped
            m.expert_pred_hits += r.expert_pred_hits
            m.expert_pred_misses += r.expert_pred_misses
            m.expert_lru_hits += r.expert_lru_hits
            m.capacity_replans += r.capacity_replans
            m.a2a_bytes += r.a2a_bytes
            m.collective_dispatches += r.collective_dispatches
            m.transfer_retries += r.transfer_retries
            m.transfer_timeouts += r.transfer_timeouts
            m.preemptions += r.preemptions
            m.resumes += r.resumes
            m.degrade_deferrals += r.degrade_deferrals
            m.page_demotions += r.page_demotions
            m.chunk_shrinks += r.chunk_shrinks
            m.checkpoint_bytes += r.checkpoint_bytes
            m.checkpoint_s += r.checkpoint_s
            m.restore_s += r.restore_s
            m.clock_broadcasts += r.clock_broadcasts
            if r.expert_load is not None:
                if m.expert_load is None:
                    m.expert_load = r.expert_load.copy()
                    m.expert_dropped_by_layer = (
                        r.expert_dropped_by_layer.copy()
                    )
                else:
                    m.expert_load += r.expert_load
                    m.expert_dropped_by_layer += r.expert_dropped_by_layer
        # one shared PrefixStore means each replica reported the SAME
        # store counters — take them once, don't sum
        shared = (len(self.servers) > 1
                  and self.servers[0]._prefix is not None
                  and all(s._prefix is self.servers[0]._prefix
                          for s in self.servers))
        if shared:
            m.prefix_hits = reports[0].prefix_hits
            m.prefix_misses = reports[0].prefix_misses
        else:
            m.prefix_hits = sum(r.prefix_hits for r in reports)
            m.prefix_misses = sum(r.prefix_misses for r in reports)
        # request results re-indexed to global submission order
        by_replica = [
            {rr.index: rr for rr in r.request_results} for r in reports
        ]
        for g, (i, local) in enumerate(self._routes):
            rr = by_replica[i].get(local)
            if rr is not None:
                m.request_results.append(replace(rr, index=g))
        m.request_results.sort(key=lambda r: r.index)
        # fleet-level failover accounting (replicas can't see it)
        m.failovers = self.failovers
        m.requeued_requests = self.requeued
        return m
