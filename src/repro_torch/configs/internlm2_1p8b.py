"""internlm2-1.8b — GQA [arXiv:2403.17297].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        arch_type="dense",
        source="arXiv:2403.17297 (InternLM2)",
        num_layers=24,
        d_model=2048,
        vocab_size=92_544,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("internlm2-1.8b", full, smoke)
