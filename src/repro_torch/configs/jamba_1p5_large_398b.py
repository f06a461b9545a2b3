"""jamba-1.5-large-398b — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Attention appears once per 8 layers (offset 4); MoE every other layer.
The SSM blocks use our Mamba2/SSD formulation (see DESIGN.md §2: we
standardize all state-space blocks on SSD for a single well-tested kernel).
"""
from repro_torch.configs.base import ModelConfig, reduce_for_smoke, register


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        source="arXiv:2403.19887 (Jamba) / arXiv:2408.12570 (Jamba-1.5)",
        num_layers=72,
        d_model=8192,
        vocab_size=65_536,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24_576,
        num_experts=16,
        experts_per_token=2,
        moe_d_ff=24_576,
        moe_layer_period=2,
        ssm_state=128,
        ssm_headdim=64,
        ssm_expand=2,
        ssm_chunk=256,
        attn_period=8,
        attn_offset=4,
    )


def smoke() -> ModelConfig:
    # one full interleave period (8 layers) at tiny width
    return reduce_for_smoke(full(), num_layers=8)


register("jamba-1.5-large-398b", full, smoke)
