"""Port kernels: plain versions vs the JAX oracles and Pallas kernels, on
the CPU.  The CUDA kernels against their plain versions are in
tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

RNG = np.random.default_rng(5)
# f32 on both sides: only summation order differs
TOL = 2e-5


def _rand(shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("E,C,D,F", [(2, 8, 64, 32), (3, 5, 48, 40)])
def test_plain_ffn_matches_jax_ref(E, C, D, F):
    x, wg, wu = _rand((E, C, D), 0.3), _rand((E, D, F), 0.05), _rand((E, D, F), 0.05)
    wd = _rand((E, F, D), 0.05)
    want = np.asarray(jref.expert_ffn_ref(*map(jnp.asarray, (x, wg, wu, wd))))
    got = ref.expert_ffn_ref(*map(_t, (x, wg, wu, wd))).numpy()
    assert np.abs(got - want).max() < TOL
    # the public op takes the plain path for CPU tensors
    got_op = ops.grouped_expert_ffn(*map(_t, (x, wg, wu, wd))).numpy()
    assert np.abs(got_op - want).max() < TOL
    w = _rand((E, D, F), 0.05)
    gm = ref.grouped_matmul_ref(_t(x), _t(w)).numpy()
    gm_want = np.asarray(jref.grouped_matmul_ref(jnp.asarray(x), jnp.asarray(w)))
    assert np.abs(gm - gm_want).max() < TOL * D ** 0.5


def test_plain_ffn_matches_pallas_interpret():
    """One tiny shape against the Pallas kernel in interpret mode (C and F
    not tile multiples exercise the JAX wrapper's padding)."""
    E, C, D, F = 2, 10, 128, 96
    x, wg, wu = _rand((E, C, D), 0.3), _rand((E, D, F), 0.05), _rand((E, D, F), 0.05)
    wd = _rand((E, F, D), 0.05)
    want = np.asarray(jops.expert_ffn(*map(jnp.asarray, (x, wg, wu, wd)),
                                      interpret=True))
    got = ops.grouped_expert_ffn(*map(_t, (x, wg, wu, wd))).numpy()
    assert np.abs(got - want).max() < 1e-4     # test_kernels padding-path bound


def test_counts_zero_rows_past_routed_load():
    E, C, D, F = 3, 6, 32, 16
    x, wg, wu = _rand((E, C, D), 0.3), _rand((E, D, F), 0.05), _rand((E, D, F), 0.05)
    wd = _rand((E, F, D), 0.05)
    counts = torch.tensor([0, 2, 6], dtype=torch.int32)
    full = ops.grouped_expert_ffn(*map(_t, (x, wg, wu, wd)))
    cut = ops.grouped_expert_ffn(*map(_t, (x, wg, wu, wd)), counts)
    for e, c in enumerate(counts.tolist()):
        assert torch.equal(cut[e, :c], full[e, :c])
        assert torch.count_nonzero(cut[e, c:]) == 0


@pytest.mark.parametrize("B,H,K,hd,S", [(3, 8, 2, 32, 64), (2, 4, 4, 64, 40)])
def test_plain_decode_attention_per_row_pos(B, H, K, hd, S):
    """Per-row pos == one scalar-pos JAX oracle call per row."""
    q, k, v = _rand((B, H, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    pos = np.array([S - 1, 0, S // 2][:B])
    got = ops.decode_attention(_t(q), _t(k), _t(v), _t(pos)).numpy()
    for b in range(B):
        want = np.asarray(jref.decode_attention_ref(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), int(pos[b])))
        assert np.abs(got[b:b + 1] - want).max() < TOL


def test_plain_decode_attention_matches_pallas_interpret():
    B, H, K, hd, S, pos = 2, 4, 2, 64, 256, 100
    q, k, v = _rand((B, H, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        interpret=True))
    got = ops.decode_attention(_t(q), _t(k), _t(v), pos).numpy()
    assert np.abs(got - want).max() < TOL


def test_plain_decode_attention_poisoned_slots():
    """Slots beyond pos must not contribute (test_kernels.py mask boundary)."""
    B, H, K, hd, S = 2, 4, 2, 64, 128
    q, k, v = _rand((B, H, hd)), _rand((B, S, K, hd)), _rand((B, S, K, hd))
    pos = torch.tensor([100, 17])
    base = ops.decode_attention(_t(q), _t(k), _t(v), pos)
    k2, v2 = k.copy(), v.copy()
    for b, p in enumerate(pos.tolist()):
        k2[b, p + 1:] = 1e4
        v2[b, p + 1:] = -1e4
    poisoned = ops.decode_attention(_t(q), _t(k2), _t(v2), pos)
    assert (base - poisoned).abs().max() < 1e-5


def test_wrappers_reject_unsupported_devices():
    x = torch.zeros((1, 2, 32), device="meta")
    w = torch.zeros((1, 32, 16), device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul(x, w)
