"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        arch_type="dense",
        source="arXiv:2401.16818 (H2O-Danube)",
        num_layers=24,
        d_model=2560,
        vocab_size=32_000,
        num_heads=32,
        num_kv_heads=8,
        head_dim=80,
        d_ff=6912,
        sliding_window=4096,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("h2o-danube-1.8b", full, smoke)
