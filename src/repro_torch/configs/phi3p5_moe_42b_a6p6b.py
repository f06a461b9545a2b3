"""phi3.5-moe-42b-a6.6b — 16 experts top-2 [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        arch_type="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct (model card)",
        num_layers=32,
        d_model=4096,
        vocab_size=32_064,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,                  # every FFN is MoE
        num_experts=16,
        experts_per_token=2,
        moe_d_ff=6400,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("phi3.5-moe-42b-a6.6b", full, smoke)
