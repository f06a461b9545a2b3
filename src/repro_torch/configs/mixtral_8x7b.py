"""mixtral-8x7b — the paper's own primary evaluation model [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) expert d_ff=14336 vocab=32000, MoE 8e top-2.
Used to validate EXPERIMENTS.md claims against the paper's tables.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        arch_type="moe",
        source="arXiv:2401.04088 (Mixtral of Experts)",
        num_layers=32,
        d_model=4096,
        vocab_size=32_000,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=0,
        num_experts=8,
        experts_per_token=2,
        moe_d_ff=14_336,
        sliding_window=0,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("mixtral-8x7b", full, smoke)
