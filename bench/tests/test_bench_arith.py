"""The yardstick's arithmetic against counts made by hand."""
import pytest

from bench import arith, spec

# a tiny model: D 8, H 2 of hd 4, K 1, E 4 top-2, F 6, vocab 10, 2 layers
TINY = spec.Sizes(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, n_experts=4,
                  top_k=2, expert_ff=6, vocab=10, rope_theta=1e4, norm_eps=1e-5)


def _sizes(name):
    return spec.Sizes.of(spec.read_json("configs", name))


def test_active_params_by_hand():
    attn = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8          # wq, wk, wv, wo
    ffn = 2 * (3 * 8 * 6) + 8 * 4                 # two experts' three matrices, router
    assert arith.active_params(TINY) == 2 * (attn + ffn) + 8 * 10


def test_published_active_params():
    assert arith.active_params(_sizes("olmoe-1b-7b")) == pytest.approx(1.18e9, rel=3e-3)
    assert arith.active_params(_sizes("mixtral-8x7b")) == pytest.approx(12.75e9, rel=3e-3)
    assert arith.model_bytes(_sizes("olmoe-1b-7b")) == pytest.approx(13.84e9, rel=2e-3)
    assert arith.model_bytes(_sizes("mixtral-8x7b")) == pytest.approx(93.4e9, rel=2e-3)
    assert arith.stack_bytes(_sizes("mixtral-8x7b")) == 3 * 8 * 4096 * 14336 * 2


def test_token_flops_by_hand():
    p = arith.active_params(TINY)
    # attention: QK and PV, 2 FLOPs a multiply-add, H * hd per key, per layer
    assert arith.decode_flops(TINY, 5) == 2 * p + 2 * 2 * (2 * 4) * 5 * 2
    # a prompt of 3: keys 1 + 2 + 3
    assert arith.prefill_flops(TINY, 3) == 2 * p * 3 + 4 * (2 * 4) * 6 * 2


def test_ffn_launch_by_hand():
    flops, nbytes = arith.ffn_launch(TINY, 1)
    assert flops == 6 * 2 * 8 * 6                 # 2 copies, gate, up and down
    # one token reaches exactly its 2 experts: their weights, 2 copies in and out
    assert nbytes == pytest.approx(2 * 3 * 8 * 6 * 2 + 2 * 2 * 8 * 2)
    assert arith.experts_touched(TINY, 1000) == pytest.approx(4.0)


def test_attention_work_by_hand():
    f, b = arith.decode_attn(TINY, 7)
    assert f == 4 * 2 * 4 * 7
    assert b == (2 * 7 * 1 * 4 + 2 * 2 * 4) * 2   # K and V of 7 keys, q in and out
    f, b = arith.prefill_attn(TINY, 3)
    assert f == 4 * 2 * 4 * 6
    assert b == 3 * (2 * 2 + 2 * 1) * 4 * 2       # Q, K, V in and O out


def test_least_time_is_the_slower_roof():
    assert arith.least_s(989e12, 0.0) == pytest.approx(1.0)
    assert arith.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert arith.least_s(989e12, 6.7e12) == pytest.approx(2.0)
