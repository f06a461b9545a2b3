"""mamba2-370m — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024 attention-free, vocab=50280, ssm_state=128.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        arch_type="ssm",
        source="arXiv:2405.21060 (Mamba2 / SSD)",
        num_layers=48,
        d_model=1024,
        vocab_size=50_280,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,                 # Mamba2 blocks have no separate FFN
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("mamba2-370m", full, smoke)
