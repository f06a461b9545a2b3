"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5-0.5B family].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b",
        arch_type="dense",
        source="hf:Qwen/Qwen1.5 (model card)",
        num_layers=40,
        d_model=2560,
        vocab_size=151_936,
        num_heads=20,
        num_kv_heads=20,
        head_dim=128,
        d_ff=6912,
        qkv_bias=True,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("qwen1.5-4b", full, smoke)
