"""Analytic per-module workload model (FLOPs / bytes / memory).

These are the "profiled" quantities of the paper's scheduler (§B: modules
are profiled offline across batch sizes).  With no physical GPU in this
container, profiling is replaced by closed-form counts derived from the
architecture — the same quantities the paper's profiler measures.

All byte figures assume the config dtype (bf16 = 2 bytes).  ``ctx`` is the
context length visible to attention at decode time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig

BYTES = 2  # bf16


def dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if "16" in cfg.dtype else 4


# ---------------------------------------------------------------------------
# Per-layer weight sizes
# ---------------------------------------------------------------------------
def attn_weight_bytes(cfg: ModelConfig) -> float:
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    return (cfg.d_model * q + 2 * cfg.d_model * kv + q * cfg.d_model) * BYTES


def expert_weight_bytes(cfg: ModelConfig) -> float:
    """One expert's weights."""
    return 3 * cfg.d_model * cfg.moe_d_ff * BYTES


def expert_buffer_bytes(cfg: ModelConfig, capacity: int) -> float:
    """Device bytes of the grouped-dispatch buffers at per-expert capacity
    ``C = b_e``: the (E, C, D) token buffer, its (E, C, D) output, and the
    (E, C, F) gate/up intermediates of the grouped FFN (Eq. 3's S_IS term
    for the expert module)."""
    if not cfg.has_moe:
        return 0.0
    e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return e * capacity * (2 * d + 2 * f) * BYTES


def dense_ffn_weight_bytes(cfg: ModelConfig) -> float:
    return 3 * cfg.d_model * cfg.d_ff * BYTES


def moe_layer_weight_bytes(cfg: ModelConfig) -> float:
    """One MoE layer's streamable FFN weights: all expert stacks + the
    router (stored f32).  This is the unit the streamed store fetches —
    the grouped GEMM needs every expert of the layer at once."""
    if not cfg.has_moe:
        return 0.0
    return cfg.num_experts * expert_weight_bytes(cfg) + cfg.d_model * cfg.num_experts * 4


def ssm_weight_bytes(cfg: ModelConfig) -> float:
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    return (d * (2 * di + 2 * ns + nh) + di * d) * BYTES


def model_bytes(cfg: ModelConfig) -> float:
    return cfg.param_counts()["total"] * BYTES


def kv_bytes_per_token_layer(cfg: ModelConfig) -> float:
    """KV-cache bytes appended per token for one attention layer."""
    return 2 * cfg.num_kv_heads * cfg.head_dim * BYTES


def kv_page_frame_bytes(cfg: ModelConfig, page_tokens: int) -> float:
    """Bytes of ONE page frame across every attention layer (K + V):
    the allocation unit of the paged tiered cache
    (``serving.cache.KVPageTable.frame_bytes``)."""
    n_attn = sum(
        1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn"
    )
    return n_attn * page_tokens * kv_bytes_per_token_layer(cfg)


def kv_bytes_per_seq(cfg: ModelConfig, ctx: int, page_tokens: int = 0) -> float:
    """Full KV cache of one sequence across all attention layers.

    ``page_tokens > 0`` rounds each attention span UP to whole pages — the
    paged cache allocates frame-granular, so admission must charge the
    rounded extent (a 17-token span holds a 32-token page at
    ``page_tokens=32``)."""
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "attn":
            span = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
            if page_tokens > 0:
                span = -(-span // page_tokens) * page_tokens
            total += span * kv_bytes_per_token_layer(cfg)
    # SSM layers carry an O(1) state instead
    for i in range(cfg.num_layers):
        if cfg.layer_kind(i) == "ssm":
            total += (
                cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim * 4
                + cfg.ssm_conv_width * (cfg.ssm_d_inner + 2 * cfg.ssm_state) * BYTES
            )
    return total


# ---------------------------------------------------------------------------
# Per-module FLOPs (per token unless stated)
# ---------------------------------------------------------------------------
def pre_attn_flops(cfg: ModelConfig) -> float:
    q = cfg.num_heads * cfg.head_dim
    kv = cfg.num_kv_heads * cfg.head_dim
    return 2 * cfg.d_model * (q + 2 * kv)


def post_attn_flops(cfg: ModelConfig) -> float:
    return 2 * cfg.num_heads * cfg.head_dim * cfg.d_model


def attn_mech_flops_decode(cfg: ModelConfig, ctx: int) -> float:
    """QK^T + PV for ONE new token against `ctx` cached tokens."""
    span = min(ctx, cfg.sliding_window) if cfg.sliding_window else ctx
    return 4 * cfg.num_heads * cfg.head_dim * span


def attn_mech_flops_prefill(cfg: ModelConfig, seq: int) -> float:
    """Per sequence (causal: ~S^2/2 each for QK^T and PV)."""
    span = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    return 4 * cfg.num_heads * cfg.head_dim * seq * span / 2

def expert_flops_per_token(cfg: ModelConfig) -> float:
    """FLOPs for one token in ONE expert (3 GEMMs, gated FFN)."""
    return 6 * cfg.d_model * cfg.moe_d_ff


def dense_ffn_flops(cfg: ModelConfig) -> float:
    return 6 * cfg.d_model * cfg.d_ff


def router_flops(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model * cfg.num_experts


def ssm_flops_per_token(cfg: ModelConfig) -> float:
    d, di, ns, nh = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_nheads
    proj = 2 * d * (2 * di + 2 * ns + nh) + 2 * di * d
    scan = 6 * di * ns          # state update + readout
    return proj + scan


def lm_head_flops(cfg: ModelConfig) -> float:
    return 2 * cfg.d_model * cfg.vocab_size


# ---------------------------------------------------------------------------
# Layer census
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerCensus:
    n_attn: int
    n_ssm: int
    n_moe: int
    n_dense_ffn: int


def census(cfg: ModelConfig) -> LayerCensus:
    n_attn = sum(1 for i in range(cfg.num_layers) if cfg.layer_kind(i) == "attn")
    n_ssm = cfg.num_layers - n_attn
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe")
    n_dense = sum(
        1
        for i in range(cfg.num_layers)
        if cfg.ffn_kind(i) == "dense" and cfg.d_ff > 0
    )
    return LayerCensus(n_attn, n_ssm, n_moe, n_dense)


def dense_module_bytes_per_layer(cfg: ModelConfig) -> float:
    """Weights of the per-layer *dense* modules (attention / SSM / shared) —
    sizes the paper's single dense-module prefetch buffer (S_Dense)."""
    per = 0.0
    c = census(cfg)
    if c.n_attn:
        per = max(per, attn_weight_bytes(cfg))
    if c.n_ssm:
        per = max(per, ssm_weight_bytes(cfg))
    if c.n_dense_ffn:
        per = max(per, dense_ffn_weight_bytes(cfg))
    return per


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(1, n) — the capacity-bucket rounding
    shared by the planner's prefill Eq. 3 charge and the engine's grouped-
    prefill dispatch buffer (bounded trace-key variety: one bucket per
    doubling, not one per distinct measured load)."""
    p = 1
    while p < n:
        p *= 2
    return p


# ---------------------------------------------------------------------------
# Weight-residency policy (S_Params / S_Expert of Table 2, realized)
# ---------------------------------------------------------------------------
def mixer_weight_bytes(cfg: ModelConfig, kind: str) -> float:
    """Sequence-mixer module weights (norms included) for one layer."""
    norms = 2 * cfg.d_model * BYTES
    if kind == "attn":
        return attn_weight_bytes(cfg) + norms
    return ssm_weight_bytes(cfg) + norms


def ffn_module_weight_bytes(cfg: ModelConfig, ffn: str) -> float:
    """FFN-stage module weights for one layer ('moe' or 'dense')."""
    if ffn == "moe":
        return moe_layer_weight_bytes(cfg)
    return dense_ffn_weight_bytes(cfg) if cfg.d_ff > 0 else 0.0


def base_weight_bytes(cfg: ModelConfig) -> float:
    """Always-resident weights: embedding, final norm, lm_head.  They are
    touched every token (embed/head bracket each step), so the store pins
    them regardless of the budget."""
    per = cfg.vocab_size * cfg.d_model * BYTES
    total = per + cfg.d_model * BYTES
    if not cfg.tie_embeddings:
        total += per
    return total


def stream_module_bytes(cfg: ModelConfig, predict_topk: int = 0) -> float:
    """Largest per-layer streamed working set — sizes ONE slot of the
    device-side stream buffer.  The store stages a whole layer's streamed
    modules together (mixer AND FFN stage when nothing is resident), so a
    slot is charged as the worst single layer's total, not the largest
    individual module.

    ``predict_topk > 0`` models predictive per-expert streaming: only the
    predicted expert set (k-hat experts) is staged per MoE layer instead of
    the whole stack, and the layer's norm2/router are pinned resident by the
    store, so an MoE layer's streamed FFN bytes shrink from
    ``moe_layer_weight_bytes`` to ``k-hat * expert_weight_bytes``.
    Mispredicted experts are fetched on demand through the same window and
    are transient, so they do not grow the steady-state slot."""
    per = 0.0
    for i in range(cfg.num_layers):
        ffn = cfg.ffn_kind(i)
        if ffn == "moe" and predict_topk > 0:
            khat = min(cfg.num_experts, int(predict_topk))
            ffn_bytes = khat * expert_weight_bytes(cfg)
        else:
            ffn_bytes = ffn_module_weight_bytes(cfg, ffn)
        layer = mixer_weight_bytes(cfg, cfg.layer_kind(i)) + ffn_bytes
        per = max(per, layer)
    return per


def stream_buffer_bytes(
    cfg: ModelConfig, depth: int = 2, predict_topk: int = 0
) -> float:
    """Device bytes of the double-buffered weight-stream window (S_Expert):
    ``depth`` slots of the largest streamed module — layer l's working set
    plus layer l+1's in-flight prefetch.  The Eq. 3 sibling of
    ``expert_buffer_bytes`` for weight streaming.  With ``predict_topk``
    set, a slot holds the expected predicted-expert set, not the worst
    whole-layer stack (see ``stream_module_bytes``)."""
    return depth * stream_module_bytes(cfg, predict_topk=predict_topk)


@dataclass(frozen=True)
class ResidencyPlan:
    """Greedy device-residency split of the model weights under a byte
    budget (``Plan.s_params``).  The SAME policy drives the planner's cost
    model (``dag_builder``) and the executor's ``serving.weights.ParamStore``
    — what the planner predicts resident is exactly what the store pins.

    Fill order: base (embed/head/final-norm, always pinned) -> sequence
    mixers + norms in layer order -> dense FFNs -> MoE expert stacks in
    layer order.  Mixers are tiny and touched every layer; expert stacks
    are the bulk and the last to fit (paper Fig. 6: S_Expert streams them).
    """

    base_bytes: float                      # always-resident bytes
    resident_bytes: float                  # realized total incl. base
    mixer_resident: tuple                  # per layer: bool
    ffn_resident: tuple                    # per layer: bool (True if no FFN)
    spare_bytes: float = 0.0               # budget left after greedy fill;
    #                                        the store's hot-expert LRU may
    #                                        promote experts into these bytes

    @property
    def fully_resident(self) -> bool:
        return all(self.mixer_resident) and all(self.ffn_resident)

    def n_streamed(self) -> int:
        return sum(not r for r in self.mixer_resident) + sum(
            not r for r in self.ffn_resident
        )


def plan_residency(cfg: ModelConfig, s_params: Optional[float]) -> ResidencyPlan:
    """Realize ``Plan.s_params`` as a concrete resident set (greedy fill).

    ``s_params=None`` — or any budget >= ``model_bytes`` — means everything
    resident (no streaming): the per-module size formulas are a POLICY, not
    exact array bytes (e.g. the router is stored f32 while ``model_bytes``
    charges every param at ``BYTES``), so without this rule a budget of
    exactly ``model_bytes`` would strand the last greedy module host-side
    and break the planner's fully-resident contract.  The base set is
    pinned even when it exceeds the budget — the executor cannot run
    without embeddings/head on device — so ``resident_bytes`` may exceed a
    tiny ``s_params``.
    """
    L = cfg.num_layers
    if s_params is None or s_params >= model_bytes(cfg):
        return ResidencyPlan(
            base_weight_bytes(cfg), model_bytes(cfg),
            (True,) * L, (True,) * L,
        )
    base = base_weight_bytes(cfg)
    budget = max(0.0, float(s_params) - base)
    mixer = [False] * L
    ffn = [False] * L
    used = base
    # greedy order: mixers, dense FFNs, then expert stacks
    order = (
        [("mixer", i, mixer_weight_bytes(cfg, cfg.layer_kind(i)))
         for i in range(L)]
        + [("ffn", i, ffn_module_weight_bytes(cfg, "dense"))
           for i in range(L) if cfg.ffn_kind(i) == "dense"]
        + [("ffn", i, ffn_module_weight_bytes(cfg, "moe"))
           for i in range(L) if cfg.ffn_kind(i) == "moe"]
    )
    for which, i, nbytes in order:
        if nbytes <= 0.0:                  # no module => trivially resident
            (mixer if which == "mixer" else ffn)[i] = True
            continue
        if nbytes <= budget:
            (mixer if which == "mixer" else ffn)[i] = True
            budget -= nbytes
            used += nbytes
    # layers without an FFN module count as resident
    for i in range(L):
        if cfg.ffn_kind(i) == "dense" and cfg.d_ff <= 0:
            ffn[i] = True
    return ResidencyPlan(base, used, tuple(mixer), tuple(ffn), budget)


# ---------------------------------------------------------------------------
# Intermediate-state sizing (constrains b_a in Eq. 3)
# ---------------------------------------------------------------------------
def intermediate_bytes_decode(cfg: ModelConfig, b_a: int, ctx: int) -> float:
    """Peak activation bytes for an attention micro-batch at decode."""
    h = cfg.num_heads
    hd = cfg.head_dim
    qkv = 3 * h * hd * BYTES
    scores = h * min(ctx, cfg.sliding_window or ctx) * 4      # f32 row
    hidden = 2 * cfg.d_model * BYTES
    return b_a * (qkv + scores + hidden)


def intermediate_bytes_prefill(cfg: ModelConfig, b_a: int, seq: int) -> float:
    """Peak activation bytes for a prefill micro-batch (flash-blocked)."""
    h, hd = cfg.num_heads, cfg.head_dim
    block = 512
    per_tok = (3 * h * hd + 4 * cfg.d_model) * BYTES
    flash = h * block * 4
    return b_a * seq * (per_tok + flash)
