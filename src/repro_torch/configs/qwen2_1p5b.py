"""qwen2-1.5b — GQA, QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        arch_type="dense",
        source="arXiv:2407.10671 (Qwen2)",
        num_layers=28,
        d_model=1536,
        vocab_size=151_936,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("qwen2-1.5b", full, smoke)
