"""Batching-strategy search (paper §4.3–4.4, Eq. 1–3).

Enumerates candidate configurations over the Table-2 variables
(B, b_a, b_e, ω, S_Expert, S_Params), discards those violating the host
(Eq. 2) and device (Eq. 3) memory constraints, estimates each survivor's
runtime with the DAG critical-path model, and returns the throughput-
maximizing plan.  Prefill and decode are searched separately
(P-D disaggregation); following the paper, decode fixes B to the host-memory
maximum.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.dag_builder import (
    PhaseEstimate,
    Plan,
    estimate_decode,
    estimate_prefill,
)
from repro_torch.core.hardware import HardwareProfile


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------
def host_batch_limit(cfg: ModelConfig, hw: HardwareProfile, ctx: int) -> int:
    """Eq. 2: S_KV-CPU(B) + S_Model <= m_c."""
    free = hw.host_mem_bytes - W.model_bytes(cfg)
    if free <= 0:
        return 0
    per_seq = W.kv_bytes_per_seq(cfg, ctx)
    if per_seq <= 0:
        return 1 << 20                      # SSM: state is tiny
    return max(0, int(free / per_seq))


def host_kv_budget(cfg: ModelConfig, hw: HardwareProfile) -> float:
    """Eq. 2's free host bytes for offloaded KV/state: m_c - S_Model
    (clamped at 0).  The continuous scheduler admits a request only while
    the KV bytes of every in-flight sequence (at its full prompt+decode
    extent) fit here."""
    return max(0.0, hw.host_mem_bytes - W.model_bytes(cfg))


def select_residency(
    cfg: ModelConfig, hw: HardwareProfile, plan: Plan, ctx: int, phase: str
) -> Optional[Plan]:
    """Realize S_Params/S_Expert for a candidate plan (Table 2 -> policy).

    ``s_params``/``s_expert`` are no longer free variables of the estimate:
    given the non-weight device footprint of Eq. 3, either the whole model
    fits in the spare bytes (fully resident, no stream buffer) or the spare
    is split into a double-buffered stream window
    (``workload.stream_buffer_bytes``) plus a greedily-filled resident set
    (``workload.plan_residency`` — the exact set the executor's ParamStore
    pins).  Returns None when not even the always-resident base weights and
    one stream window fit.

    ``plan.predict_topk > 0`` sizes the stream-window slot by the EXPECTED
    predicted-expert set (k-hat experts per MoE layer) instead of the
    worst-layer whole stack — the bytes that frees are greedily re-pinned
    by ``plan_residency`` as extra resident modules, and whatever the
    greedy fill still leaves over becomes the store's hot-expert LRU
    budget (``ResidencyPlan.spare_bytes``).
    """
    footprint = device_memory_used(
        cfg, replace(plan, s_params=0.0, s_expert=0.0), ctx, phase
    )
    spare = hw.device_mem_bytes - footprint
    if spare <= 0:
        return None
    mb = W.model_bytes(cfg)
    if mb <= spare:
        return replace(plan, s_params=float(mb), s_expert=0.0)
    s_expert = W.stream_buffer_bytes(
        cfg, depth=2, predict_topk=getattr(plan, "predict_topk", 0)
    )
    rp = W.plan_residency(cfg, spare - s_expert)
    if rp.resident_bytes + s_expert > spare:
        return None                         # base weights + window don't fit
    return replace(plan, s_params=rp.resident_bytes, s_expert=s_expert)


def default_predict_topk(cfg: ModelConfig) -> int:
    """Default predicted-set size k-hat for predictive expert streaming:
    twice the routed top-k (headroom for batch diversity — different rows
    route to different experts), clamped to the expert count.  0 for
    non-MoE configs (prediction is meaningless without experts)."""
    if not cfg.has_moe:
        return 0
    return min(cfg.num_experts, max(2, 2 * cfg.experts_per_token))


def capacity_for_load(
    load: Iterable[float], B: int, k: int, max_drop_rate: float = 0.0
) -> int:
    """Smallest per-expert capacity ``b_e`` whose EXPECTED drop rate under
    the measured routing distribution stays within ``max_drop_rate``.

    ``load`` is a per-expert routed-copy histogram (the device-side
    accumulation ``EngineStats.expert_load`` drains — any non-negative
    weights work; only the shares matter).  A decode step routes ``B * k``
    copies; expert *e* expects ``n_e = B * k * share_e`` of them and drops
    ``max(0, n_e - C)`` beyond capacity ``C``.  This replaces the uniform-
    routing assumption of the a-priori ``b_e`` grid: under skew the hot
    expert's share — not ``k/E`` — is what sizes the dispatch buffer.

    Binary-searches C in ``[1, B]`` (a single expert can receive at most
    one copy per token).  ``max_drop_rate=0`` returns the zero-expected-
    drop capacity, i.e. the measured-max expert share of a step."""
    shares = [max(0.0, float(x)) for x in load]
    total = sum(shares)
    copies = float(max(1, B) * max(1, k))
    if total <= 0.0:
        return max(1, min(B, -(-int(copies) // max(1, len(shares) or 1))))
    exp = [s / total * copies for s in shares]
    budget = max_drop_rate * copies

    def dropped(C: int) -> float:
        return sum(max(0.0, n - C) for n in exp)

    lo, hi = 1, max(1, B)
    while lo < hi:
        mid = (lo + hi) // 2
        if dropped(mid) <= budget:
            hi = mid
        else:
            lo = mid + 1
    return lo


def select_decode_chunk(
    plan: Plan,
    mean_decode_len: int,
    scheduler: str = "continuous",
    arrival_rate: float = 0.0,
    step_time_s: Optional[float] = None,
    cap: int = 64,
) -> int:
    """Plan the fused decode chunk ``T`` from the admission cadence.

    The fused engine generates ``T`` tokens per device dispatch, but the
    scheduler can only admit/evict at chunk boundaries — so ``T`` must stay
    below the expected number of decode ticks between scheduling events:

    * ``continuous`` — a slot frees roughly every ``mean_decode_len / B``
      ticks (evictions are the admission opportunities);
    * ``static`` — nothing is admitted mid-wave, so the cadence is the wave
      itself (``mean_decode_len`` ticks);
    * an open-loop arrival stream at ``arrival_rate`` req/s delivers a new
      request every ``1 / (rate * step_time_s)`` ticks (when ``step_time_s``
      is known, e.g. from the DAG estimate's ``t_model``).

    Returns the largest power of two no larger than the tightest cadence,
    clamped to ``[1, cap]``.  ``T`` only affects scheduling granularity,
    never tokens — the engine's fused chunk is token-identical to per-tick
    decode at any ``T``.
    """
    if scheduler == "static":
        cadence = float(max(1, mean_decode_len))
    else:
        cadence = mean_decode_len / max(1, plan.B)
    if arrival_rate > 0 and step_time_s:
        cadence = min(cadence, 1.0 / (arrival_rate * step_time_s))
    T = 1
    while T * 2 <= min(cadence, float(cap)):
        T *= 2
    return T


def device_memory_used(
    cfg: ModelConfig, plan: Plan, ctx: int, phase: str
) -> float:
    """LHS of Eq. 3."""
    s_dense = W.dense_module_bytes_per_layer(cfg)
    kv_gpu = plan.b_a * min(ctx, cfg.sliding_window or ctx) * \
        W.kv_bytes_per_token_layer(cfg) if cfg.has_attention else 0.0
    if phase == "decode":
        s_is = W.intermediate_bytes_decode(cfg, plan.b_a, ctx)
    else:
        s_is = W.intermediate_bytes_prefill(cfg, plan.b_a, ctx)
    # accumulated hidden states for the expert stage + the grouped-dispatch
    # (E, C, D) capacity buffer.  At decode C = b_e (clamped to the tokens
    # that exist); at prefill the engine sizes C to the next power-of-two
    # bucket over the micro-batch's MEASURED per-expert routed load (zero
    # drops still guaranteed — the bucket is >= the max load), so Eq. 3
    # charges the expected bucket: the balanced per-expert share with the
    # config's capacity-factor headroom, pow2-rounded, capped at the full
    # micro-batch token count (the worst-case bucket under total skew).
    tokens = plan.B * (ctx if phase == "prefill" else 1)
    s_is += tokens * 2 * cfg.d_model * W.BYTES
    if cfg.has_moe:
        if phase == "prefill":
            mb_tokens = max(1, min(plan.b_a * ctx, tokens))
            per_e = -(-mb_tokens * cfg.experts_per_token
                      // max(cfg.num_experts, 1))
            cap = min(mb_tokens,
                      W.next_pow2(int(per_e * cfg.capacity_factor) + 1))
        else:
            cap = max(1, min(plan.b_e, tokens))
        s_is += W.expert_buffer_bytes(cfg, cap)
    # paged KV: the device page pool (+1 null write-sink frame) is a
    # standing Eq. 3 charge on top of the per-launch gather working set
    kv_pool = 0.0
    if plan.kv_page_tokens > 0 and plan.kv_device_pages > 0:
        kv_pool = (plan.kv_device_pages + 1) * W.kv_page_frame_bytes(
            cfg, plan.kv_page_tokens
        )
    return plan.s_params + plan.s_expert + s_dense + kv_gpu + s_is + kv_pool


def device_memory_ok(
    cfg: ModelConfig, hw: HardwareProfile, plan: Plan, ctx: int, phase: str
) -> bool:
    return device_memory_used(cfg, plan, ctx, phase) <= hw.device_mem_bytes


def kv_device_pool_frames(
    cfg: ModelConfig, hw: HardwareProfile, plan: Plan, ctx: int,
    page_tokens: int,
) -> int:
    """Size the paged KV device pool from the Eq. 3 spare: how many page
    frames fit on device AFTER the plan's weights, stream window, dispatch
    buffers and activations are charged.  The remainder of the batch's
    frames live on the host tier (Mode B — streamed like expert weights).
    Returns 0 when nothing is spare (every frame host-side)."""
    assert page_tokens > 0
    base = replace(plan, kv_page_tokens=0, kv_device_pages=0)
    spare = hw.device_mem_bytes - device_memory_used(
        cfg, base, ctx, plan.phase
    )
    fb = W.kv_page_frame_bytes(cfg, page_tokens)
    if fb <= 0 or spare <= fb:              # +1 null frame must fit too
        return 0
    return int(spare // fb) - 1


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------
def _pow2_grid(lo: int, hi: int) -> List[int]:
    out, v = [], lo
    while v < hi:
        out.append(v)
        v *= 2
    out.append(hi)
    return sorted(set(out))


@dataclass
class SearchResult:
    plan: Plan
    estimate: PhaseEstimate
    evaluated: int


def search_decode(
    cfg: ModelConfig,
    hw: HardwareProfile,
    ctx: int,
    B: Optional[int] = None,
    omega_grid: Optional[Iterable[float]] = None,
    use_cpu_attention: bool = True,
    decode_len: Optional[int] = None,
    arrival_rate: float = 0.0,
    scheduler: str = "continuous",
    expert_load: Optional[Iterable[float]] = None,
    max_drop_rate: float = 0.01,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> SearchResult:
    """``expert_load`` (a per-expert routed-copy histogram, e.g. a drained
    ``EngineStats.expert_load`` row or its layer sum) replaces the uniform-
    routing ``b_e`` grid with ``capacity_for_load`` capacities at a few
    drop-rate targets around ``max_drop_rate`` — the measured-skew search.
    Candidates also enumerate ``predict_topk`` in {0, default} so the cost
    model can trade whole-stack streaming against predictive per-expert
    prefetch (smaller stream window, more resident bytes, k-hat experts of
    htod per MoE layer instead of E).

    ``mesh_shape=(dp, ep)`` plans one expert-parallel replica: the decode
    DAG shards experts E/ep per rank with an all-to-all exchange per MoE
    layer (``hw.a2a_time``), and the search additionally picks the
    pipeline chunk count (``plan.ep_chunks`` in {1, 2, 4, 8}) that
    minimizes the exposed a2a time against the per-chunk dispatch
    overhead it buys."""
    B_max = host_batch_limit(cfg, hw, ctx)
    if B_max == 0:
        raise ValueError(f"{cfg.name} does not fit in host memory")
    B = min(B or B_max, B_max)
    if omega_grid is None:
        omega_grid = [i / 10 for i in range(11)] if use_cpu_attention else [0.0]
    # DeepSeek-style latent/up-projected KV makes host attention unprofitable
    # (paper §5.3 sets w=0 for DeepSeek); attention-free archs have no split.
    if not cfg.has_attention:
        omega_grid = [0.0]

    best: Optional[Tuple[float, Plan, PhaseEstimate]] = None
    n_eval = 0
    # B starts at the host-memory maximum (the paper's choice).  Under the
    # REALIZABLE residency policy a plan must also fit its grouped dispatch
    # buffer + stream window + base weights on device — at small contexts
    # the host-max B can make that impossible, so B is halved until a
    # realizable plan exists (the old free-variable search would return
    # plans the engine could not execute).
    B_try = B
    while best is None and B_try >= 1:
        # b_e is the per-expert capacity of the (E, C, D) dispatch buffer:
        # enumerate headroom factors over the balanced per-expert load
        # (never below it — under-provisioning trades dropped tokens for
        # speed, which the throughput objective cannot see), clamped to B
        # (the most tokens one expert can receive per decode step).
        if cfg.has_moe:
            if expert_load is not None:
                # measured-skew capacities: the drop-rate-constrained
                # search over the observed routing distribution, bracketed
                # with zero-drop and a looser target so the throughput
                # objective can trade buffer bytes against drops
                b_e_grid = sorted({
                    capacity_for_load(expert_load, B_try,
                                      cfg.experts_per_token, eps)
                    for eps in (0.0, max_drop_rate, 4 * max_drop_rate)
                })
            else:
                per_e = max(
                    1, -(-B_try * cfg.experts_per_token
                         // max(cfg.num_experts, 1))
                )
                b_e_grid = sorted(
                    {max(1, min(B_try, int(per_e * f)))
                     for f in (1.0, 1.25, 1.5, 2.0)}
                )
            pt_grid = sorted({0, default_predict_topk(cfg)})
        else:
            b_e_grid = [1]
            pt_grid = [0]
        for b_a in _pow2_grid(32, max(32, B_try)):
            for b_e in b_e_grid:
                for omega in omega_grid:
                    for pt in pt_grid:
                        plan = select_residency(
                            cfg, hw,
                            Plan(B=B_try, b_a=b_a, b_e=b_e, omega=omega,
                                 phase="decode", predict_topk=pt),
                            ctx, "decode",
                        )
                        if plan is None or not device_memory_ok(
                            cfg, hw, plan, ctx, "decode"
                        ):
                            continue
                        # prediction only matters when experts stream
                        if pt and W.plan_residency(
                            cfg, plan.s_params
                        ).fully_resident:
                            continue
                        est = estimate_decode(cfg, hw, plan, ctx,
                                              mesh_shape=mesh_shape)
                        n_eval += 1
                        if best is None or est.throughput > best[0]:
                            best = (est.throughput, plan, est)
        B_try //= 2
    assert best is not None, "no feasible decode plan"
    plan, est = best[1], best[2]
    # expert-parallel pipelining: with a mesh, re-estimate the winning plan
    # at each chunk count — more chunks hide more a2a wire time behind the
    # previous chunk's expert GEMMs but pay extra dispatch launches, so the
    # optimum is workload-dependent (EPS-MoE-style schedule search)
    if mesh_shape is not None and mesh_shape[1] > 1 and cfg.has_moe:
        chunk_best: Optional[Tuple[float, Plan, PhaseEstimate]] = None
        for chunks in (1, 2, 4, 8):
            if chunks > max(1, plan.B):
                continue
            cand = replace(plan, ep_chunks=chunks)
            ce = estimate_decode(cfg, hw, cand, ctx, mesh_shape=mesh_shape)
            n_eval += 1
            if chunk_best is None or ce.throughput > chunk_best[0]:
                chunk_best = (ce.throughput, cand, ce)
        if chunk_best is not None:
            plan, est = chunk_best[1], chunk_best[2]
    # realized workload prior for the fused chunk: the caller's mean decode
    # length if known, else a coarse quarter-context default
    mean_dec = decode_len if decode_len else max(1, ctx // 4)
    plan = replace(plan, decode_chunk=select_decode_chunk(
        plan, mean_dec, scheduler=scheduler, arrival_rate=arrival_rate,
        step_time_s=est.t_model,
    ))
    return SearchResult(plan, est, n_eval)


def search_prefill(
    cfg: ModelConfig,
    hw: HardwareProfile,
    seq: int,
    B: Optional[int] = None,
) -> SearchResult:
    B_max = host_batch_limit(cfg, hw, seq)
    B = min(B or B_max, B_max)
    best: Optional[Tuple[float, Plan, PhaseEstimate]] = None
    n_eval = 0
    for B_try in _pow2_grid(8, max(8, B)):
        for b_a in _pow2_grid(1, B_try):
            # prefill capacity: the balanced per-expert share of the B*seq
            # token wave with the config's capacity factor as headroom
            T = B_try * seq
            if cfg.has_moe:
                per_e = T * cfg.experts_per_token / max(cfg.num_experts, 1)
                b_e = max(1, min(T, int(per_e * cfg.capacity_factor) + 1))
            else:
                b_e = 1
            plan = select_residency(
                cfg, hw,
                Plan(B=B_try, b_a=b_a, b_e=b_e, omega=0.0, phase="prefill"),
                seq, "prefill",
            )
            if plan is None or not device_memory_ok(
                cfg, hw, plan, seq, "prefill"
            ):
                continue
            est = estimate_prefill(cfg, hw, plan, seq)
            n_eval += 1
            if best is None or est.throughput > best[0]:
                best = (est.throughput, plan, est)
    assert best is not None, f"no feasible prefill plan for {cfg.name}"
    return SearchResult(best[1], best[2], n_eval)
