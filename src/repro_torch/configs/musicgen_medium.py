"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048.  The EnCodec
conv/codec frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings of the right shape; we implement the decoder transformer.
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        arch_type="audio",
        source="arXiv:2306.05284 (MusicGen)",
        num_layers=48,
        d_model=1536,
        vocab_size=2048,
        num_heads=24,
        num_kv_heads=24,
        head_dim=64,
        d_ff=6144,
        frontend="audio",
        frontend_tokens=256,    # conditioning frames supplied as embeddings
    )


def smoke() -> ModelConfig:
    return reduce_for_smoke(full())


register("musicgen-medium", full, smoke)
