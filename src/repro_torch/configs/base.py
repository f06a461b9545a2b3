"""Configuration system: model architectures and input shapes.

Every assigned architecture registers a ``ModelConfig`` here (full size) and
a reduced ``smoke()`` variant (<=2 layers, d_model<=512, <=4 experts) that is
actually executed on CPU in tests.  The full configs are exercised only via
the dry-run (ShapeDtypeStruct lowering, no allocation).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Optional


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description sufficient to build the model.

    The same dataclass describes dense, MoE, SSM, hybrid, VLM-backbone and
    audio-backbone architectures; unused blocks are disabled with zeros.
    """

    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str                         # citation for the config
    num_layers: int
    d_model: int
    vocab_size: int

    # --- attention ---
    num_heads: int = 0                  # 0 => attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False              # qwen-style
    sliding_window: int = 0             # 0 => full attention
    rope_theta: float = 10_000.0

    # --- dense FFN ---
    d_ff: int = 0                       # 0 => no dense FFN (pure-MoE / pure-SSM layer)

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                   # per-expert hidden dim
    num_shared_experts: int = 0         # DeepSeek/Qwen-style always-on experts
    capacity_factor: float = 1.25
    moe_layer_period: int = 1           # MoE every Nth layer (jamba: 2)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0                  # d_state; 0 => no SSM layers
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # --- hybrid interleave (jamba): 1 attention layer per `attn_period` ---
    attn_period: int = 0                # 0 => homogeneous layers
    attn_offset: int = 0                # index of the attn layer within a period

    # --- modality frontend stub ---
    frontend: Optional[str] = None      # None | 'audio' | 'vision'
    frontend_tokens: int = 0            # prompt positions supplied as embeddings

    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    # ------------------------------------------------------------------
    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.num_heads > 0

    @property
    def has_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0

    @property
    def sub_quadratic(self) -> bool:
        """True when 500k-token decode is feasible (SSM / SWA / hybrid)."""
        if self.arch_type == "ssm":
            return True
        if self.arch_type == "hybrid":
            return True
        return self.sliding_window > 0

    def layer_kind(self, i: int) -> str:
        """'attn' or 'ssm' for layer i (hybrid interleave)."""
        if not self.has_ssm:
            return "attn"
        if not self.has_attention:
            return "ssm"
        assert self.attn_period > 0
        return "attn" if (i % self.attn_period) == self.attn_offset else "ssm"

    def ffn_kind(self, i: int) -> str:
        """'moe' or 'dense' for the FFN of layer i."""
        if not self.has_moe:
            return "dense"
        if (i % self.moe_layer_period) == (self.moe_layer_period - 1):
            return "moe"
        return "dense"

    # ---------------- parameter counting (for roofline 6ND) -----------
    def param_counts(self) -> Dict[str, int]:
        d = self.d_model
        counts: Dict[str, int] = {"embed": self.vocab_size * d}
        attn = moe = dense = ssm = norm = 0
        for i in range(self.num_layers):
            norm += 2 * d
            if self.layer_kind(i) == "attn":
                q = self.num_heads * self.head_dim
                kv = self.num_kv_heads * self.head_dim
                attn += d * q + 2 * d * kv + q * d
            else:
                di, ns = self.ssm_d_inner, self.ssm_state
                nh = self.ssm_nheads
                # in_proj (z, x, B, C, dt) + out_proj + conv + A,D
                attn_free = d * (2 * di + 2 * ns + nh) + di * d
                attn_free += self.ssm_conv_width * (di + 2 * ns) + 2 * nh
                ssm += attn_free
            if self.ffn_kind(i) == "moe":
                moe += self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
                moe += self.num_shared_experts * 3 * d * self.moe_d_ff
            elif self.d_ff:
                dense += 3 * d * self.d_ff
        counts.update(attn=attn, moe=moe, dense_ffn=dense, ssm=ssm, norm=norm)
        if not self.tie_embeddings:
            counts["lm_head"] = self.vocab_size * d
        counts["total"] = sum(counts.values())
        # active params per token (MoE: only routed experts count)
        active = counts["total"] - counts["moe"]
        if self.has_moe:
            n_moe_layers = sum(
                1 for i in range(self.num_layers) if self.ffn_kind(i) == "moe"
            )
            per_layer = (self.experts_per_token + self.num_shared_experts) * (
                3 * self.d_model * self.moe_d_ff
            ) + self.d_model * self.num_experts
            active += n_moe_layers * per_layer
        counts["active"] = active
        return counts


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS = [
    "mamba2-370m",
    "musicgen-medium",
    "olmoe-1b-7b",
    "internvl2-76b",
    "h2o-danube-1.8b",
    "internlm2-1.8b",
    "qwen1.5-4b",
    "qwen2-1.5b",
    "jamba-1.5-large-398b",
    "phi3.5-moe-42b-a6.6b",
    # the paper's own evaluation model family
    "mixtral-8x7b",
]


def register(name: str, full: Callable[[], ModelConfig], smoke: Callable[[], ModelConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def _ensure_loaded() -> None:
    if len(_REGISTRY) >= len(ARCH_IDS):
        return
    for arch in ARCH_IDS:
        mod = arch.replace("-", "_").replace(".", "p")
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    _ensure_loaded()
    return list(ARCH_IDS)


def reduce_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Standard reduction used by the per-arch smoke variants."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(4, cfg.num_heads)) if cfg.num_heads else 0
    num_kv = 0
    if cfg.num_kv_heads:
        # preserve the GQA ratio where possible
        ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
        num_kv = max(1, num_heads // min(ratio, num_heads))
    kw = dict(
        num_layers=2 if not cfg.attn_period else cfg.attn_period,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.num_experts else 0,
        moe_d_ff=min(cfg.moe_d_ff, 128) if cfg.moe_d_ff else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=32,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        frontend_tokens=min(cfg.frontend_tokens, 16) if cfg.frontend else 0,
        name=cfg.name + "-smoke",
    )
    kw.update(overrides)
    return replace(cfg, **kw)
