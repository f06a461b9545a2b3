"""Build MoE-offloading job DAGs (paper Fig. 6) and estimate phase runtimes.

One DAG is built per *distinct layer type* (attention+MoE, attention+dense,
SSM+MoE, ...) and the model time sums layer-type times weighted by their
census — matching the paper's per-layer DAG with P-D disaggregation
(separate DAG classes for prefill and decode).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import workload as W
from repro_torch.core.dag import JobDag
from repro_torch.core.hardware import HardwareProfile


@dataclass(frozen=True)
class Plan:
    """A module-based batching strategy (the search variables of Table 2)."""

    B: int                 # accumulated batch (sequences) at the MoE stage
    b_a: int               # attention micro-batch (sequences)
    b_e: int               # per-expert token capacity C of the grouped
    #                        (E, C, D) dispatch buffer; routed copies beyond
    #                        it are dropped (engine counts them in stats)
    omega: float = 0.0     # fraction of attention computed on the host CPU
    s_expert: float = 0.0  # reserved expert prefetch buffer (bytes)
    s_params: float = 0.0  # model weights cached resident on device (bytes)
    phase: str = "decode"
    kv_on_gpu: bool = False     # baselines keep the KV cache device-resident
    weight_reuse: int = 1       # FlexGen-style rounds reusing fetched weights
    decode_chunk: int = 8       # fused decode chunk T: tokens generated per
    #                             device dispatch when the engine's fused path
    #                             is eligible (planner.select_decode_chunk
    #                             sizes it from the admission cadence; the
    #                             scheduler further clamps it to the shortest
    #                             live request so no eviction is due mid-chunk)
    kv_page_tokens: int = 0     # paged tiered KV cache: tokens per page frame
    #                             (0 = legacy contiguous buffers)
    kv_device_pages: int = 0    # device page-pool frames the plan reserves
    #                             (planner.kv_device_pool_frames sizes it from
    #                             the Eq. 3 spare; 0 with paging on = Mode A,
    #                             everything device-resident)
    predict_topk: int = 0       # predictive per-expert streaming: k-hat
    #                             experts staged per streamed MoE layer from
    #                             layer l's gate-logit prediction (0 = whole-
    #                             stack staging).  Sizes the stream-window
    #                             slot and the expected expert htod per layer;
    #                             mispredictions demand-fetch, so correctness
    #                             never depends on it
    ep_chunks: int = 1          # expert-parallel pipeline chunks: the decode
    #                             batch splits into this many independent
    #                             all-to-all+FFN stages so chunk k+1's
    #                             dispatch overlaps chunk k's expert GEMMs
    #                             (distributed.ep_engine; 1 = serial a2a).
    #                             Purely a schedule knob — tokens identical

    def describe(self) -> str:
        out = (
            f"phase={self.phase} B={self.B} b_a={self.b_a} b_e={self.b_e} "
            f"w={self.omega:.1f} S_exp={self.s_expert/1e9:.1f}GB "
            f"S_par={self.s_params/1e9:.1f}GB reuse={self.weight_reuse} "
            f"T={self.decode_chunk}"
        )
        if self.kv_page_tokens:
            out += (f" pages={self.kv_page_tokens}tok"
                    f"x{self.kv_device_pages}dev")
        if self.predict_topk:
            out += f" pred_k={self.predict_topk}"
        if self.ep_chunks > 1:
            out += f" ep_chunks={self.ep_chunks}"
        return out


@dataclass
class PhaseEstimate:
    throughput: float            # tokens/s
    t_model: float               # seconds per full model pass
    tokens: float                # tokens produced/consumed per pass
    htod_bytes: float
    dtoh_bytes: float
    layer_times: Dict[str, float] = field(default_factory=dict)
    critical: List[str] = field(default_factory=list)


def _miss_fractions(cfg: ModelConfig, plan: Plan) -> Dict[str, float]:
    """Per-module-class htod miss fractions under the REALIZED resident set.

    ``plan.s_params`` is no longer a scalar discount applied uniformly: the
    greedy residency policy (``workload.plan_residency`` — the same one the
    executor's ``ParamStore`` pins weights with) decides which concrete
    modules live on device, and each weight class is charged only for its
    non-resident layers.  ``weight_reuse`` (FlexGen-style rounds) divides
    the miss as before.
    """
    rp = W.plan_residency(cfg, plan.s_params if plan.s_params > 0 else 0.0)
    reuse = max(plan.weight_reuse, 1)

    def frac(flags) -> float:
        flags = list(flags)
        if not flags:
            return 0.0
        return sum(not f for f in flags) / len(flags) / reuse

    attn_f = [rp.mixer_resident[i] for i in range(cfg.num_layers)
              if cfg.layer_kind(i) == "attn"]
    ssm_f = [rp.mixer_resident[i] for i in range(cfg.num_layers)
             if cfg.layer_kind(i) == "ssm"]
    moe_f = [rp.ffn_resident[i] for i in range(cfg.num_layers)
             if cfg.ffn_kind(i) == "moe"]
    dense_f = [rp.ffn_resident[i] for i in range(cfg.num_layers)
               if cfg.ffn_kind(i) == "dense" and cfg.d_ff > 0]
    return {
        "attn": frac(attn_f),
        "ssm": frac(ssm_f),
        "moe": frac(moe_f),
        "dense": frac(dense_f),
    }


# ---------------------------------------------------------------------------
# Decode-phase layer DAG
# ---------------------------------------------------------------------------
def build_decode_layer_dag(
    cfg: ModelConfig,
    hw: HardwareProfile,
    plan: Plan,
    ctx: int,
    kind: str,
    ffn: str,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> JobDag:
    dag = JobDag()
    B = plan.B
    miss = _miss_fractions(cfg, plan)
    # expert-parallel mesh (dp, ep): one replica's DAG with experts sharded
    # E/ep per rank — ranks run their local experts concurrently, so the
    # gpu channel only serializes ONE rank's expert share, and an a2a
    # exchange precedes the expert GEMMs (distributed.ep_engine)
    ep = max(1, mesh_shape[1]) if mesh_shape else 1

    # ---- sequence mixer ----
    if kind == "attn":
        w_bytes = W.attn_weight_bytes(cfg) * miss["attn"]
        cp_w = dag.add("attn_weights_htod", "htod", w_bytes / hw.htod_bw)
        n_gpu = int(round(B * (1.0 - plan.omega)))
        n_cpu = B - n_gpu
        pre = dag.add(
            "pre_attn",
            "gpu",
            hw.gemm_time(
                B * W.pre_attn_flops(cfg),
                0.0,
                B * 3 * cfg.d_model * W.BYTES,
                B,
            ),
            deps=[cp_w],
        )
        done_attn: List[int] = []
        if n_cpu:
            qd = dag.add(
                "qkv_dtoh",
                "dtoh",
                n_cpu * 3 * cfg.num_heads * cfg.head_dim * W.BYTES / hw.dtoh_bw,
                deps=[pre],
            )
            cpu = dag.add(
                "cpu_self_attn",
                "cpu",
                hw.cpu_attn_time(
                    n_cpu * W.attn_mech_flops_decode(cfg, ctx),
                    n_cpu * ctx * W.kv_bytes_per_token_layer(cfg),
                ),
                deps=[qd],
            )
            back = dag.add(
                "attn_out_htod",
                "htod",
                n_cpu * cfg.num_heads * cfg.head_dim * W.BYTES / hw.htod_bw,
                deps=[cpu],
            )
            done_attn.append(back)
        if n_gpu:
            b_a = max(1, min(plan.b_a, n_gpu))
            n_micro = -(-n_gpu // b_a)
            span = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
            for m in range(n_micro):
                rows = min(b_a, n_gpu - m * b_a)
                kv_bytes = rows * span * W.kv_bytes_per_token_layer(cfg)
                deps = [pre]
                if not plan.kv_on_gpu:
                    deps.append(
                        dag.add(f"kv_fetch[{m}]", "htod", kv_bytes / hw.htod_bw)
                    )
                g = dag.add(
                    f"gpu_self_attn[{m}]",
                    "gpu",
                    hw.gemm_time(
                        rows * W.attn_mech_flops_decode(cfg, ctx),
                        0.0,
                        kv_bytes,
                        rows,
                    ),
                    deps=deps,
                )
                done_attn.append(g)
        post = dag.add(
            "post_attn",
            "gpu",
            hw.gemm_time(
                B * W.post_attn_flops(cfg), 0.0,
                B * 2 * cfg.d_model * W.BYTES, B,
            ),
            deps=done_attn or [pre],
        )
        dag.add(
            "kv_append_dtoh",
            "dtoh",
            B * W.kv_bytes_per_token_layer(cfg) / hw.dtoh_bw,
            deps=[post],
        )
        mixer_done = post
    else:  # SSM layer: dense module, state stays on device/host
        w_bytes = W.ssm_weight_bytes(cfg) * miss["ssm"]
        cp_w = dag.add("ssm_weights_htod", "htod", w_bytes / hw.htod_bw)
        mixer_done = dag.add(
            "ssm_step",
            "gpu",
            hw.gemm_time(
                B * W.ssm_flops_per_token(cfg),
                0.0,
                B * 4 * cfg.d_model * W.BYTES,
                B,
            ),
            deps=[cp_w],
        )

    # ---- FFN stage ----
    if ffn == "moe":
        router = dag.add(
            "router",
            "gpu",
            hw.gemm_time(B * W.router_flops(cfg), 0.0, 0.0, B),
            deps=[mixer_done],
        )
        tokens_per_expert = B * cfg.experts_per_token / cfg.num_experts
        # grouped dispatch: one launch per expert's share of the (E, C, D)
        # buffer — no b_e chunk loop (engine §4.2 path).  Padded capacity
        # slots cost FLOPs too, so a plan with a real capacity constraint
        # (cap < B) is charged for all cap rows; cap >= B means no buffer
        # constraint and degenerates to gather-exact execution (the loop /
        # baseline systems), charged for the routed tokens only.
        cap = max(1, min(plan.b_e, B))
        rows = float(cap) if cap < B else tokens_per_expert
        e_bytes = W.expert_weight_bytes(cfg) * miss["moe"]
        # predictive per-expert prefetch: only ~k-hat experts move per
        # streamed MoE layer (the predicted set; hits cost nothing extra,
        # mispredictions swap one expert for another — expected traffic is
        # the predicted-set size either way), so the per-expert htod charge
        # scales by k-hat/E instead of each expert paying its full miss
        if plan.predict_topk and cfg.num_experts:
            e_bytes *= min(1.0, plan.predict_topk / cfg.num_experts)
        ffn_deps = [router]
        e_local = cfg.num_experts
        if ep > 1:
            # dispatch + return all-to-all: total payload matches
            # distributed.a2a_bytes_per_stage (copies x ranks x (2 rows of
            # activations + routing meta)); with ep_chunks pipeline chunks
            # only the first chunk's exchange is exposed — the rest overlap
            # the previous chunk's expert GEMMs — but every extra chunk
            # pays its own dispatch launch on the critical path
            copies = B * cfg.experts_per_token
            a2a_total = copies * ep * (2 * cfg.d_model * 4 + 4)
            chunks = max(1, plan.ep_chunks)
            exposed = (hw.a2a_time(a2a_total / chunks, ep)
                       + (chunks - 1) * hw.launch_overhead_s)
            ffn_deps.append(dag.add("moe_a2a", "comm", exposed, deps=[router]))
            e_local = max(1, cfg.num_experts // ep)
        for e in range(e_local):
            cp = dag.add(f"expert_w[{e}]", "htod", e_bytes / hw.htod_bw)
            dag.add(
                f"expert[{e}]",
                "gpu",
                hw.gemm_time(
                    rows * W.expert_flops_per_token(cfg),
                    0.0,
                    rows * 2 * cfg.d_model * W.BYTES,
                    int(max(rows, 1)),
                ),
                deps=[cp] + ffn_deps,
            )
    elif cfg.d_ff > 0:
        w_bytes = W.dense_ffn_weight_bytes(cfg) * miss["dense"]
        cp = dag.add("ffn_w_htod", "htod", w_bytes / hw.htod_bw)
        dag.add(
            "dense_ffn",
            "gpu",
            hw.gemm_time(
                B * W.dense_ffn_flops(cfg),
                0.0,
                B * 2 * cfg.d_model * W.BYTES,
                B,
            ),
            deps=[cp, mixer_done],
        )
    return dag


# ---------------------------------------------------------------------------
# Prefill-phase layer DAG (no KV fetch; GPU-only compute — paper §5.3)
# ---------------------------------------------------------------------------
def build_prefill_layer_dag(
    cfg: ModelConfig,
    hw: HardwareProfile,
    plan: Plan,
    seq: int,
    kind: str,
    ffn: str,
) -> JobDag:
    dag = JobDag()
    B = plan.B
    T = B * seq
    miss = _miss_fractions(cfg, plan)

    if kind == "attn":
        w_bytes = W.attn_weight_bytes(cfg) * miss["attn"]
        cp_w = dag.add("attn_weights_htod", "htod", w_bytes / hw.htod_bw)
        b_a = max(1, min(plan.b_a, B))
        n_micro = -(-B // b_a)
        outs = []
        for m in range(n_micro):
            rows = min(b_a, B - m * b_a)
            g = dag.add(
                f"attn_block[{m}]",
                "gpu",
                hw.gemm_time(
                    rows * (seq * (W.pre_attn_flops(cfg) + W.post_attn_flops(cfg))
                            + W.attn_mech_flops_prefill(cfg, seq)),
                    0.0,
                    rows * seq * 4 * cfg.d_model * W.BYTES,
                    rows * seq,
                ),
                deps=[cp_w],
            )
            outs.append(g)
        dag.add(
            "kv_append_dtoh",
            "dtoh",
            T * W.kv_bytes_per_token_layer(cfg) / hw.dtoh_bw,
            deps=outs,
        )
        mixer_done = outs[-1]
    else:
        w_bytes = W.ssm_weight_bytes(cfg) * miss["ssm"]
        cp_w = dag.add("ssm_weights_htod", "htod", w_bytes / hw.htod_bw)
        mixer_done = dag.add(
            "ssm_scan",
            "gpu",
            hw.gemm_time(
                T * W.ssm_flops_per_token(cfg),
                0.0,
                T * 4 * cfg.d_model * W.BYTES,
                T,
            ),
            deps=[cp_w],
        )

    if ffn == "moe":
        router = dag.add(
            "router", "gpu",
            hw.gemm_time(T * W.router_flops(cfg), 0.0, 0.0, T),
            deps=[mixer_done],
        )
        tokens_per_expert = T * cfg.experts_per_token / cfg.num_experts
        # capacity rows are computed (zero-padded or not); cap >= T means
        # no capacity constraint (gather-exact), as in the decode DAG
        cap = max(1, min(plan.b_e, T))
        rows = float(cap) if cap < T else tokens_per_expert
        e_bytes = W.expert_weight_bytes(cfg) * miss["moe"]
        for e in range(cfg.num_experts):
            cp = dag.add(f"expert_w[{e}]", "htod", e_bytes / hw.htod_bw)
            dag.add(
                f"expert[{e}]",
                "gpu",
                hw.gemm_time(
                    rows * W.expert_flops_per_token(cfg),
                    0.0,
                    rows * 2 * cfg.d_model * W.BYTES,
                    int(max(rows, 1)),
                ),
                deps=[cp, router],
            )
    elif cfg.d_ff > 0:
        w_bytes = W.dense_ffn_weight_bytes(cfg) * miss["dense"]
        cp = dag.add("ffn_w_htod", "htod", w_bytes / hw.htod_bw)
        dag.add(
            "dense_ffn",
            "gpu",
            hw.gemm_time(
                T * W.dense_ffn_flops(cfg),
                0.0,
                T * 2 * cfg.d_model * W.BYTES,
                T,
            ),
            deps=[cp, mixer_done],
        )
    return dag


# ---------------------------------------------------------------------------
# Model-level estimates
# ---------------------------------------------------------------------------
def _layer_types(cfg: ModelConfig) -> Dict[Tuple[str, str], int]:
    types: Dict[Tuple[str, str], int] = {}
    for i in range(cfg.num_layers):
        key = (cfg.layer_kind(i), cfg.ffn_kind(i))
        types[key] = types.get(key, 0) + 1
    return types


def estimate_decode(
    cfg: ModelConfig, hw: HardwareProfile, plan: Plan, ctx: int,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> PhaseEstimate:
    t_model = 0.0
    htod = dtoh = 0.0
    layer_times: Dict[str, float] = {}
    critical: List[str] = []
    for (kind, ffn), count in _layer_types(cfg).items():
        dag = build_decode_layer_dag(cfg, hw, plan, ctx, kind, ffn,
                                     mesh_shape=mesh_shape)
        t = dag.earliest_finish()
        layer_times[f"{kind}+{ffn}"] = t
        t_model += t * count
        busy = dag.channel_busy()
        htod += busy["htod"] * hw.htod_bw * count
        dtoh += busy["dtoh"] * hw.dtoh_bw * count
        if not critical:
            critical = dag.critical_path()
    # lm_head (+ final norm) on device
    t_model += hw.gemm_time(
        plan.B * W.lm_head_flops(cfg), 0.0,
        plan.B * cfg.vocab_size * W.BYTES, plan.B,
    )
    tp = plan.B / t_model if t_model > 0 else 0.0
    return PhaseEstimate(tp, t_model, plan.B, htod, dtoh, layer_times, critical)


def estimate_prefill(
    cfg: ModelConfig, hw: HardwareProfile, plan: Plan, seq: int
) -> PhaseEstimate:
    t_model = 0.0
    htod = dtoh = 0.0
    layer_times: Dict[str, float] = {}
    critical: List[str] = []
    for (kind, ffn), count in _layer_types(cfg).items():
        dag = build_prefill_layer_dag(cfg, hw, plan, seq, kind, ffn)
        t = dag.earliest_finish()
        layer_times[f"{kind}+{ffn}"] = t
        t_model += t * count
        busy = dag.channel_busy()
        htod += busy["htod"] * hw.htod_bw * count
        dtoh += busy["dtoh"] * hw.dtoh_bw * count
        if not critical:
            critical = dag.critical_path()
    tokens = plan.B * seq
    t_model += hw.gemm_time(
        plan.B * W.lm_head_flops(cfg), 0.0,
        plan.B * cfg.vocab_size * W.BYTES, plan.B,
    )
    tp = tokens / t_model if t_model > 0 else 0.0
    return PhaseEstimate(tp, t_model, tokens, htod, dtoh, layer_times, critical)
