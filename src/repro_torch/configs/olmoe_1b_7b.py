"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060].

16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        source="arXiv:2409.02060 (OLMoE)",
        num_layers=16,
        d_model=2048,
        vocab_size=50_304,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=0,                  # every FFN is MoE
        num_experts=64,
        experts_per_token=8,
        moe_d_ff=1024,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("olmoe-1b-7b", full, smoke)
