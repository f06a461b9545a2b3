"""K4's plain version (``kernels.ref.flash_attention_ref``, what the port's
``ops.flash_attention`` runs on a CPU tensor) against the JAX package: its
Pallas flash-attention kernel in interpret mode, its oracle, and the
reference model's blocked, sliding-window and masked naive attention.  The
CUDA kernel against this plain version is in tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RNG = np.random.default_rng(12)
# tests/test_kernels.py's TOL: f32 differs by summation order only; bf16
# rounds the output (and, in the reference's naive attention, the
# probabilities) to bf16
TOL = {"float32": 2e-5, "bfloat16": 0.05}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(B, S, H, K, hd, dtype="float32"):
    """numpy f32 inputs, rounded through ``dtype`` so both sides see the
    same values."""
    arrs = [RNG.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd))]
    return [np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32)) for a in arrs]


def _port(q, k, v, dtype="float32", window=0, lengths=None):
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in (q, k, v)]
    lens = None if lengths is None else torch.as_tensor(lengths)
    return ops.flash_attention(*t, window=window, lengths=lens).float().numpy()


def _jax(fn, q, k, v, dtype="float32", **kw):
    args = [jnp.asarray(a, JDT[dtype]) for a in (q, k, v)]
    return np.asarray(fn(*args, **kw).astype(jnp.float32))


def _kv_mask(S, lengths):
    return jnp.arange(S)[None, :] < jnp.asarray(lengths)[:, None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K", [(512, 4, 2), (1024, 2, 2)])
def test_plain_matches_pallas_kernel_and_oracle(S, H, K, dtype):
    """tests/test_kernels.py:98-110's shapes: the Pallas kernel (interpret
    mode, KV heads repeated by the JAX wrapper) and its oracle."""
    q, k, v = _qkv(2, S, H, K, 64, dtype)
    got = _port(q, k, v, dtype)
    pallas = _jax(jops.flash_attention, q, k, v, dtype, interpret=True)
    rep = H // K
    oracle = np.asarray(jref.flash_attention_ref(
        *[jnp.asarray(a, JDT[dtype]) for a in (q, np.repeat(k, rep, 2),
                                                np.repeat(v, rep, 2))]
    ).astype(jnp.float32))
    assert np.abs(got - pallas).max() < TOL[dtype]
    assert np.abs(got - oracle).max() < TOL[dtype]


@pytest.mark.parametrize("case", ["blocked", "swa"])
def test_plain_matches_reference_long_prompt_attention(case):
    """S = 1536, past the reference's naive limit of 1024: its blocked
    attention (q/kv blocks of 512) and its sliding-window attention
    (window 512, q blocks of 512)."""
    S, window = 1536, (512 if case == "swa" else 0)
    q, k, v = _qkv(2, S, 4, 2, 32)
    if case == "blocked":
        want = _jax(jattn.blocked_attention, q, k, v, q_block=512, kv_block=512)
    else:
        want = _jax(jattn.swa_attention, q, k, v, window=window, q_block=512)
    got = _port(q, k, v, window=window)
    assert np.abs(got - want).max() < TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,H,K,window,lengths", [
    (300, 4, 2, 0, [300, 131, 1]),           # ragged, not multiples of 64
    (257, 8, 2, 100, [200, 257, 65, 1]),     # window + lengths + G = 4
    (190, 4, 1, 64, [190, 63]),              # window + lengths, G = 4, short rows
])
def test_plain_matches_masked_naive_on_valid_rows(S, H, K, window, lengths, dtype):
    """The reference's naive attention with ``kv_mask`` (and its window):
    equal on every row below ``lengths[b]``; rows past it are zeros."""
    q, k, v = _qkv(len(lengths), S, H, K, 32, dtype)
    got = _port(q, k, v, dtype, window=window, lengths=lengths)
    want = _jax(jattn.naive_attention, q, k, v, dtype, causal=True, window=window,
                kv_mask=_kv_mask(S, lengths))
    for b, n in enumerate(lengths):
        assert np.abs(got[b, :n] - want[b, :n]).max() < TOL[dtype], (b, n)
        assert not np.any(got[b, n:]), (b, n)


def test_plain_zero_rows_and_poisoned_keys_past_lengths():
    """Rows at or past ``lengths[b]`` are exactly zero, and keys past it
    change no live row even when they hold 1e4."""
    B, S, H, K, hd = 3, 130, 4, 2, 32
    q, k, v = _qkv(B, S, H, K, hd)
    lengths = [130, 70, 1]
    base = _port(q, k, v, lengths=lengths)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lengths):
        assert not np.any(base[b, n:])
        assert np.abs(base[b, :n]).max() > 0
        k2[b, n:] = 1e4
        v2[b, n:] = 1e4
    poisoned = _port(q, k2, v2, lengths=lengths)
    assert np.abs(poisoned - base).max() < 1e-6
    # lengths == S everywhere is the unmasked causal attention
    full = _port(q, k, v, lengths=[S] * B)
    assert np.array_equal(full, _port(q, k, v))


def test_plain_rejects_mismatched_shapes():
    q = torch.zeros((1, 8, 4, 32))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 32)), torch.zeros((1, 8, 3, 32)))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, window=-1)


@pytest.mark.parametrize("S,q_offset,H,K", [(40, 24, 4, 2), (16, 1000, 8, 2), (64, 64, 4, 4),
                                            (1, 37, 2, 1)])
def test_plain_q_offset_matches_reference_and_full_call(S, q_offset, H, K):
    """The suffix prefill of a prefix-cache hit: Sq queries at absolute
    positions q_offset.. against q_offset + Sq keys.  Within 2e-5 of the
    reference's ``naive_attention(causal=True, q_offset=)`` and of the last
    Sq rows of a full causal call over the whole sequence."""
    q, k, v = _qkv(2, q_offset + S, H, K, 32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = ops.flash_attention(t[0][:, q_offset:].contiguous(), t[1], t[2],
                              q_offset=q_offset).numpy()
    want = _jax(jattn.naive_attention, q[:, q_offset:], k, v, causal=True, q_offset=q_offset)
    full = ops.flash_attention(*t).numpy()[:, q_offset:]
    np.testing.assert_allclose(got, want, atol=TOL["float32"])
    np.testing.assert_allclose(got, full, atol=TOL["float32"])


def test_plain_q_offset_with_lengths_and_its_refusals():
    """With ``lengths`` (absolute), query rows at or past them are zeros and
    the live rows equal the full call's; an offset with a window, or keys
    that are not q_offset + Sq long, raise."""
    q, k, v = _qkv(2, 48, 4, 2, 32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    lens = torch.tensor([48, 35])
    got = ops.flash_attention(t[0][:, 30:].contiguous(), t[1], t[2], lengths=lens,
                              q_offset=30).numpy()
    full = _port(q, k, v, lengths=[48, 35])[:, 30:]
    np.testing.assert_allclose(got, full, atol=TOL["float32"])
    assert not got[1, 5:].any()
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(t[0][:, 30:].contiguous(), t[1], t[2], window=16, q_offset=30)
    with pytest.raises(ValueError):
        ops.flash_attention(t[0][:, 30:].contiguous(), t[1], t[2], q_offset=20)
