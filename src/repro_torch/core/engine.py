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

Prefill is layer-major: each layer's weights are acquired once and reused
by every ``b_a`` micro-batch, and a grouped-prefill MoE layer is split into
a mixer+route launch and a grouped-FFN launch whose capacity is the next
power of two over the micro-batch's measured max expert load (one planned
host read per layer and micro-batch), so no routed copy drops at prefill.
Only positions below each row's length are routed there.

Cache ownership: the engine owns the per-layer KV buffers and SSM states;
decode, prefill insertion and eviction write them in place and their
``data_ptr()``s never change.  Callers never keep a reference across a tick.

Out of the port so far, each raising ``NotImplementedError`` that names its
slice: the fused decode chunk (a CUDA graph), host attention (omega > 0),
weight streaming, paged KV, and the loop expert path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import Plan
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import ffn_apply, init_layer_cache, layer_forward, mixer_forward
from repro_torch.models.layers import rms_norm
from repro_torch.models.model import head
from repro_torch.serving.kvcache import evict_rows, insert_prefill_rows
from repro_torch.serving.sampling import BatchSampler
from repro_torch.serving.weights import ParamStore

HOST_ATTENTION_SLICE = "host attention (omega > 0) is the host-attention slice of the port"
LOOP_SLICE = "the 'loop' expert path is not ported; use expert_path='grouped'"
PAGING_SLICE = "paged KV caches are the paging slice of the port"


@dataclass
class EngineStats:
    attn_microbatches: int = 0
    expert_launches: int = 0             # grouped: one per MoE layer per step
    expert_tokens: int = 0               # routed token-copies processed
    expert_tokens_dropped: int = 0       # routed copies over the b_e capacity
    device_attn_tokens: int = 0
    expert_tokens_dropped_by_layer: Optional[np.ndarray] = None
    #                                      (n_moe,) int64 per-MoE-layer drops
    expert_load: Optional[np.ndarray] = None
    #                                      (n_moe, E) int64 routed-copy
    #                                      histogram (pre-capacity)


class ModuleBatchingEngine:
    """Executes a batching ``Plan`` over a real model on ``device``.

    ``expert_path='grouped'`` is the only MoE stage of this slice: one
    grouped-dispatch launch per MoE layer with capacity ``plan.b_e``;
    prefill shares the grouped dispatch at a zero-drop capacity.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params: Dict,
        plan: Plan,
        max_seq: int = 512,
        expert_path: str = "grouped",
        store: Optional[ParamStore] = None,
        stream_weights: bool = False,
        resident_bytes: Optional[float] = None,
        cache_config=None,
        device="cuda",
    ) -> None:
        if expert_path != "grouped":
            raise NotImplementedError(LOOP_SLICE)
        if plan.omega > 0:
            raise NotImplementedError(HOST_ATTENTION_SLICE)
        if cache_config is not None:
            raise NotImplementedError(PAGING_SLICE)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.plan = plan
        self.max_seq = max_seq
        if store is None:
            store = ParamStore.build(
                cfg, params, plan, stream_weights=stream_weights,
                resident_bytes=resident_bytes, device=self.device,
            )
        self.store = store
        self.schema = store.schema                  # [(kind, ffn)] per layer
        self.cache: Optional[List[Dict[str, torch.Tensor]]] = None
        self.stats = EngineStats()
        # device-side counters, folded into `stats` by sync_stats(): drops and
        # routed-load histograms accumulate per MoE layer without a host sync
        self._moe_layers = [li for li, (_, f) in enumerate(self.schema)
                            if f == "moe"]
        self._moe_index = {li: j for j, li in enumerate(self._moe_layers)}
        self._reset_device_counters()

    def _reset_device_counters(self) -> None:
        dev, n_moe = self.device, len(self._moe_layers)
        E = max(1, self.cfg.num_experts)
        self._kept_dev = torch.zeros((), dtype=torch.int32, device=dev)
        self._dropped_dev = torch.zeros((n_moe,), dtype=torch.int32, device=dev)
        self._load_dev = torch.zeros((n_moe, E), dtype=torch.int32, device=dev)

    def _expert_capacity(self, batch: int) -> int:
        """Per-expert capacity C: the plan's b_e, clamped to the most tokens
        one expert can receive (top-k ids are distinct per token)."""
        return max(1, min(self.plan.b_e, batch))

    def sync_stats(self) -> EngineStats:
        """Materialize the device-side expert counters (one host sync)."""
        self.stats.expert_tokens += int(self._kept_dev)
        n_moe = len(self._moe_layers)
        if n_moe:
            dropped = self._dropped_dev.cpu().numpy().astype(np.int64)
            load = self._load_dev.cpu().numpy().astype(np.int64)
            self.stats.expert_tokens_dropped += int(dropped.sum())
            if self.stats.expert_tokens_dropped_by_layer is None:
                self.stats.expert_tokens_dropped_by_layer = np.zeros(n_moe, np.int64)
                self.stats.expert_load = np.zeros_like(load)
            self.stats.expert_tokens_dropped_by_layer += dropped
            self.stats.expert_load += load
        self._reset_device_counters()
        return self.stats

    # -- cache management ---------------------------------------------
    def init_cache(self, batch: int) -> None:
        self.cache = [init_layer_cache(self.cfg, kind, batch, self.max_seq,
                                       self.device)
                      for kind, _ in self.schema]

    def evict_slots(self, rows) -> None:
        """Recycle batch slots: zero their rows in every layer, in place."""
        assert self.cache is not None
        evict_rows(self.cache, rows)

    # -- phases ---------------------------------------------------------
    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(device=self.device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def prefill(self, tokens, lengths=None) -> torch.Tensor:
        """Prefill a fresh batch (micro-batched by b_a), filling the engine
        cache.  Returns the last-token logits (B, V).  ``lengths`` (B,)
        makes a ragged right-padded batch exact."""
        B = tokens.shape[0]
        self.init_cache(B)
        return self.prefill_slots(tokens, np.arange(B), lengths=lengths)

    def prefill_slots(self, tokens, rows, lengths=None) -> torch.Tensor:
        """Prefill ``tokens`` (n, S) into existing batch rows ``rows`` (n,).

        Layer-major module batching: layers in the outer loop (weights
        acquired once per layer), ``b_a`` micro-batches in the inner loop.
        Also the continuous scheduler's admission path: newcomers overwrite
        their slots' cache rows; every other slot is untouched.  Returns the
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
        for li, (kind, ffn) in enumerate(self.schema):
            p = self.store.acquire(li)
            outs = []
            for j, ((lo, hi), x) in enumerate(zip(spans, xs)):
                ln = None if lengths is None else lengths[lo:hi]
                if ffn == "moe":
                    x, entry = self._prefill_moe_layer(kind, p, x, positions, ln,
                                                       live[j])
                else:
                    x, entry, _ = layer_forward(cfg, kind, ffn, p, x, positions, ln)
                insert_prefill_rows(cfg, self.cache[li], entry, rows[lo:hi])
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

    def _prefill_moe_layer(self, kind, p, x, positions, lengths, live=None):
        """A grouped-prefill MoE layer as two launches: mixer (attention or
        SSM, by ``kind``) + route, then
        the grouped FFN at capacity ``next_pow2(max expert load)`` -- zero
        drops, and the same output as any capacity >= that load.

        Only the positions in ``live`` (those below ``lengths``) are routed:
        padded positions are never read, and since their attention rows are
        zeros they would all route to the same experts and inflate the
        capacity probe.  Their MoE output is zero."""
        cfg = self.cfg
        y, entry = mixer_forward(cfg, kind, p, x, positions, lengths)
        x = x + y
        B, S, D = x.shape
        xt = rms_norm(x, p["norm2"], cfg.norm_eps).reshape(-1, D)
        if live is not None:
            xt = xt.index_select(0, live)
        moe = p["moe"]
        gates, idx, _ = moe_mod.route(cfg, moe["router"], xt)
        load = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        cap = W.next_pow2(int(load.max()))           # the planned capacity probe
        y, _, _, _ = moe_mod.grouped_dispatch(
            cfg, xt, gates, idx, moe["experts_w_gate"], moe["experts_w_up"],
            moe["experts_w_down"], cap,
        )
        if live is not None:
            y = torch.zeros((B * S, D), dtype=y.dtype,
                            device=y.device).index_copy_(0, live, y)
        return x + y.reshape(B, S, D).to(x.dtype), entry

    # -- path selection ---------------------------------------------------
    def fused_eligible(self) -> bool:
        """The fused one-launch decode chunk (a CUDA graph over the T-tick
        loop) is the fused-decode slice; every decode here is per-module."""
        return False

    # -- decode -----------------------------------------------------------
    def decode_step(self, tokens, pos) -> torch.Tensor:
        """One per-module decode step for all B sequences; returns logits.
        ``pos`` is a scalar or a per-sequence (B,) vector of positions."""
        return self._decode_rows(self._tensor(tokens), self._tensor(pos), 0)

    def _decode_rows(self, tokens: torch.Tensor, pos: torch.Tensor,
                     row0: int) -> torch.Tensor:
        """Per-module decode over batch rows ``[row0, row0 + n)``."""
        cfg = self.cfg
        x = self.store.base["embed"][tokens]
        for li, (kind, ffn) in enumerate(self.schema):
            p = self.store.acquire(li)
            if kind == "attn":
                x = x + self._attention_stage(li, p, x, pos, row0)
            else:
                x = x + self._ssm_stage(li, p, x, row0)
            if ffn == "moe":
                x = x + self._expert_stage_grouped(li, p, x)
            elif cfg.d_ff > 0 and "ffn" in p:
                x = x + ffn_apply(p["ffn"], rms_norm(x, p["norm2"], cfg.norm_eps))
        return head(cfg, self.store.base, x)

    # -- module stages ---------------------------------------------------
    def _attention_stage(self, li, p, x, pos, row0: int = 0) -> torch.Tensor:
        """Micro-batched device attention over rows ``[row0, row0 + n)``;
        each micro-batch updates its own rows of the cache in place."""
        cfg, plan = self.cfg, self.plan
        n = x.shape[0]
        posv = pos.reshape(-1).expand(n) if pos.numel() == 1 else pos
        b_a = max(1, min(plan.b_a, n))
        k, v = self.cache[li]["k"], self.cache[li]["v"]
        outs = []
        for lo in range(0, n, b_a):
            hi = min(n, lo + b_a)
            h = rms_norm(x[lo:hi, None, :], p["norm1"], cfg.norm_eps)
            rows = slice(row0 + lo, row0 + hi)
            y, _ = attn_mod.attn_decode(cfg, p["attn"], h,
                                        {"k": k[rows], "v": v[rows]}, posv[lo:hi])
            outs.append(y[:, 0])
            self.stats.attn_microbatches += 1
            self.stats.device_attn_tokens += hi - lo
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

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

    def _expert_stage_grouped(self, li, p, x) -> torch.Tensor:
        """One grouped-dispatch launch for the whole MoE stage; the kept,
        dropped and load counters stay on device."""
        cfg = self.cfg
        moe = p["moe"]
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        gates, idx, _ = moe_mod.route(cfg, moe["router"], h)
        y, kept, dropped, load = moe_mod.grouped_dispatch(
            cfg, h, gates, idx, moe["experts_w_gate"], moe["experts_w_up"],
            moe["experts_w_down"], self._expert_capacity(x.shape[0]),
        )
        self.stats.expert_launches += 1
        j = self._moe_index[li]
        self._kept_dev += kept
        self._dropped_dev[j] += dropped
        self._load_dev[j] += load
        return y

    # -- chunked decode ---------------------------------------------------
    def decode_chunk(self, tokens, pos, sampler: BatchSampler, T: int,
                     live=None) -> torch.Tensor:
        """``T`` decode ticks for the full batch, sampled per slot; returns
        the ``(B, T)`` token matrix (column t is tick t's tokens).  Every
        tick runs the per-module path (``fused_eligible()`` is False).
        ``live`` (B,) bool marks rows owned by unfinished requests: dead rows
        hold their stale token and position, like per-tick stepping.
        Positions are clamped at ``max_seq - 1``."""
        tokens = self._tensor(tokens)
        B = tokens.shape[0]
        pos_np = np.asarray(pos.cpu() if torch.is_tensor(pos) else pos,
                            np.int64).reshape(-1)
        if pos_np.size == 1:
            pos_np = np.full(B, pos_np[0], np.int64)
        return self._chunk_rows_per_module(tokens, pos_np, sampler, T, 0, B, live)

    def _chunk_rows_per_module(self, tokens, pos_np: np.ndarray, sampler,
                               T: int, lo: int, hi: int,
                               live=None) -> torch.Tensor:
        """``T`` per-module ticks over rows ``[lo, hi)``.  Positions advance
        on the host (``pos_np`` is the batch's (B,) numpy mirror) and go up
        once per tick as one (n,) vector."""
        slots = np.arange(lo, hi)
        cur = tokens[lo:hi]
        pos_rows = pos_np[lo:hi]
        adv = None if live is None else np.asarray(live, np.int64)[lo:hi]
        lv = None if adv is None else self._tensor(adv.astype(bool), torch.bool)
        cap = self.max_seq - 1
        cols = []
        for t in range(T):
            pt = np.minimum(pos_rows + (t if adv is None else t * adv), cap)
            lg = self._decode_rows(cur, self._tensor(pt), lo)
            sampled = sampler.sample(lg, slots)
            cols.append(sampled)
            cur = sampled if lv is None else torch.where(lv, sampled, cur)
        return torch.stack(cols, dim=1)

    # -- generation -------------------------------------------------------
    def generate(self, tokens, decode_len: int, lengths=None, sampling=None,
                 chunk: Optional[int] = None) -> torch.Tensor:
        """Greedy generation (the paper's strategy, §B).  ``lengths`` (B,)
        generates from a ragged right-padded batch, each sequence at its own
        positions.  Returns (B, decode_len) tokens on the device."""
        B, S = tokens.shape
        sampler = BatchSampler.uniform(B, sampling)
        logits = self.prefill(tokens, lengths=lengths)
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
