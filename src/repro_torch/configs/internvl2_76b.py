"""internvl2-76b — InternViT + (Llama-3-70B-class) LLM [arXiv:2404.16821].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
vision encoder + MLP projector are a STUB: ``input_specs`` provides
precomputed patch embeddings; we implement the language backbone.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        arch_type="vlm",
        source="arXiv:2404.16821 (InternVL2)",
        num_layers=80,
        d_model=8192,
        vocab_size=128_256,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        rope_theta=500_000.0,
        frontend="vision",
        frontend_tokens=256,     # image patch tokens per sample
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("internvl2-76b", full, smoke)
