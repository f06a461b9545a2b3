"""The yardstick's arithmetic: the H100's peaks and the work the traffic needs.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit: 989 TFLOP/s
bf16, 3.35 TB/s of HBM3.  Work is counted from the traffic's shapes, the
same whatever implements it: each input byte read once, each output byte
written once, only the positions a request has (no padding, no dead slot).

* Model FLOPs of a token: 2 x the parameters it touches (every attention
  projection, its top-k experts, the router and the LM head; the embedding
  is a lookup) plus its attention over the keys it sees (2 products of
  ``H * hd`` per key).
* Expert FFN (K1 + K2) of one launch over ``n`` tokens: ``6 * n * k * D * F``
  FLOPs; bytes: the weights of each expert the launch routes to (the
  expected number under uniform routing), read once, and the routed copies'
  activations in and out.
* Decode attention (K3) of one token seeing ``s`` keys: its K and V rows,
  read once, and its query in and output out.
* Prefill attention (K4) of a prompt of ``L`` tokens: causal, ``L (L + 1)
  / 2`` (query, key) pairs; bytes: Q, K, V in and O out once.

Imports neither the program nor JAX.
"""
from __future__ import annotations

from bench.spec import Sizes

PEAK_FLOPS = 989e12          # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3, H100 SXM
BF16 = 2


def active_params(sz: Sizes) -> int:
    """Parameters one token touches, with the LM head and without the
    embedding lookup."""
    D, H, K, hd = sz.d_model, sz.n_heads, sz.n_kv_heads, sz.head_dim
    attn = D * H * hd * 2 + D * K * hd * 2
    ffn = sz.top_k * 3 * D * sz.expert_ff + D * sz.n_experts
    return sz.n_layers * (attn + ffn) + D * sz.vocab


def attn_flops(sz: Sizes, keys: int) -> float:
    """One token's attention over ``keys`` keys, every layer."""
    return 4.0 * sz.n_heads * sz.head_dim * keys * sz.n_layers


def prefill_flops(sz: Sizes, L: int) -> float:
    """A prompt of L tokens, causal."""
    return 2.0 * active_params(sz) * L + attn_flops(sz, L * (L + 1) // 2)


def decode_flops(sz: Sizes, keys: int) -> float:
    """One decode token that sees ``keys`` keys."""
    return 2.0 * active_params(sz) + attn_flops(sz, keys)


def experts_touched(sz: Sizes, tokens: int) -> float:
    """Expected experts a launch over ``tokens`` tokens routes to, each
    token picking ``top_k`` distinct of ``n_experts`` uniformly."""
    E, k = sz.n_experts, sz.top_k
    return E * (1.0 - (1.0 - k / E) ** tokens)


def ffn_launch(sz: Sizes, tokens: int):
    """(FLOPs, bytes) of one MoE layer's expert FFN over ``tokens`` tokens."""
    D, F, k = sz.d_model, sz.expert_ff, sz.top_k
    copies = tokens * k
    flops = 6.0 * copies * D * F
    nbytes = experts_touched(sz, tokens) * 3 * D * F * BF16 + 2.0 * copies * D * BF16
    return flops, nbytes


def decode_attn(sz: Sizes, keys: int):
    """(FLOPs, bytes) of one layer's decode attention for one token."""
    H, K, hd = sz.n_heads, sz.n_kv_heads, sz.head_dim
    return 4.0 * H * hd * keys, (2.0 * keys * K * hd + 2.0 * H * hd) * BF16


def prefill_attn(sz: Sizes, L: int):
    """(FLOPs, bytes) of one layer's causal attention over a prompt of L."""
    H, K, hd = sz.n_heads, sz.n_kv_heads, sz.head_dim
    return 4.0 * H * hd * (L * (L + 1) // 2), L * (2.0 * H + 2.0 * K) * hd * BF16


def least_s(flops: float, nbytes: float) -> float:
    """The least time the chip needs for the work: the slower of its two
    roofs."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def model_bytes(sz: Sizes) -> int:
    """The model's bf16 bytes (the router counted in float32)."""
    D, H, K, hd = sz.d_model, sz.n_heads, sz.n_kv_heads, sz.head_dim
    per = (D * H * hd * 2 + D * K * hd * 2) * BF16 + 2 * D * BF16
    per += 3 * sz.n_experts * D * sz.expert_ff * BF16 + D * sz.n_experts * 4
    return sz.n_layers * per + (2 * sz.vocab * D + D) * BF16


def stack_bytes(sz: Sizes) -> int:
    """One layer's expert stacks."""
    return 3 * sz.n_experts * sz.d_model * sz.expert_ff * BF16

