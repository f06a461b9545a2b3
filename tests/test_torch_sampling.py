"""Port sampling (``repro_torch.serving.{prng,sampling}``) against JAX's
``jax.random`` and the reference ``repro.serving.sampling`` on the CPU.

The port follows the installed jax's threefry with
``jax_threefry_partitionable`` on; every test reads the flag through
``_partitionable``.  Bits and keys must be equal, the Gumbel noise within 2
ulp at the scale max(|g|, 1) (the two frameworks' float32 ``log`` differ in
the last bit, and -log(-log(u)) turns one ulp of the inner log into many
ulps of a result near 0), and the sampled tokens identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.serving import sampling as jsampling  # noqa: E402
from repro_torch.serving import prng  # noqa: E402
from repro_torch.serving import sampling as tsampling  # noqa: E402

SEEDS = [0, 13, 12345, 2**31 - 1]
DATA = [0, 1, 7, 2**31 + 5, 2**32 - 1]


@pytest.fixture
def _partitionable():
    """The port draws the bits of partitionable threefry, the installed
    jax's default; under the other setting the reference's bits differ."""
    assert jax.config.jax_threefry_partitionable, (
        "jax_threefry_partitionable is off: the port follows the partitionable "
        "threefry of jax 0.9, so the reference's random bits would differ")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(_partitionable, seed):
    assert np.array_equal(prng.key_from_seed(seed), np.asarray(jax.random.PRNGKey(seed)))
    base = prng.key_from_seed(seed).astype(np.int64)
    for d in DATA:
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), d))
        assert np.array_equal(prng.fold_in(base, np.int64(d)), want)       # numpy
        got = prng.fold_in(torch.from_numpy(base)[None], torch.tensor([d]))  # torch
        assert np.array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal_jax(_partitionable, seed):
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), d) for d in DATA]
    got = prng.random_bits(torch.stack([_t(k) for k in keys]), 3001).numpy()
    for k, row in zip(keys, got):
        want = np.asarray(jax.random.bits(k, (3001,), jnp.uint32)).astype(np.int64)
        assert np.array_equal(row, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_2_ulp_of_jax(_partitionable, seed):
    keys = [jax.random.fold_in(jax.random.PRNGKey(seed), d) for d in DATA]
    got = prng.gumbel(torch.stack([_t(k) for k in keys]), 20000).numpy()
    for k, row in zip(keys, got):
        want = np.asarray(jax.random.gumbel(k, (20000,), jnp.float32))
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
        assert (np.abs(row - want) <= 2 * ulp).all(), float((np.abs(row - want) / ulp).max())


CASES = {   # (temperature, top_k) of each of 8 slots
    "greedy": [(0.0, 0)] * 8,
    "temperature": [(0.7, 0), (1.0, 0), (1.3, 0), (0.2, 0)] * 2,
    "top_k": [(0.8, 5), (1.0, 1), (1.2, 40), (0.5, 1000)] * 2,
    "mixed": [(0.0, 0), (0.9, 0), (0.8, 7), (0.0, 3), (1.1, 0), (0.6, 2),
              (0.0, 0), (1.0, 50)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_tokens_identical_to_reference(_partitionable, case):
    """The same f32 logits, keys, steps, temperatures and top-ks through
    both packages' ``sample_tokens``, for 6 token indices."""
    rng = np.random.default_rng(5)
    V = 1000
    temps = np.array([t for t, _ in CASES[case]], np.float32)
    topks = np.array([k for _, k in CASES[case]], np.int32)
    keys = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(17), i), np.uint32)
                     for i in range(8)])
    use_topk = bool((topks > 0).any())
    for step in range(6):
        logits = (rng.standard_normal((8, V)) * 3).astype(np.float32)
        steps = np.full(8, step, np.int32) + np.arange(8, dtype=np.int32)
        want = np.asarray(jsampling.sample_tokens(
            jnp.asarray(logits), jnp.asarray(keys), jnp.asarray(steps),
            jnp.asarray(temps), jnp.asarray(topks), use_topk))
        got = tsampling.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(steps.astype(np.int64)), torch.from_numpy(temps),
            torch.from_numpy(topks.astype(np.int64)), use_topk)
        assert np.array_equal(got.numpy(), want)
    if case == "temperature":      # the top-k pass changes nothing without a top-k
        again = tsampling.sample_tokens(
            torch.from_numpy(logits), torch.from_numpy(keys.astype(np.int64)),
            torch.from_numpy(steps.astype(np.int64)), torch.from_numpy(temps),
            torch.from_numpy(topks.astype(np.int64)), True)
        assert np.array_equal(again.numpy(), want)


def test_batch_sampler_matches_reference(_partitionable):
    """Admission with and without a salt, per-slot streams over several
    columns, a column over a subset of slots, eviction, ``state`` and
    ``advance``: the same tokens and the same state as the reference."""
    rng = np.random.default_rng(9)
    V = 500
    params = [None, jsampling.SamplingParams(0.8, 0, 3), jsampling.SamplingParams(1.0, 5, 3),
              jsampling.SamplingParams(0.7, 2, 11), jsampling.SamplingParams(0.0, 4, 1)]
    tparams = [None if p is None else tsampling.SamplingParams(p.temperature, p.top_k, p.seed)
               for p in params]
    js, ts = jsampling.BatchSampler(6), tsampling.BatchSampler(6)
    for i, (jp, tp) in enumerate(zip(params, tparams)):
        js.set_slot(i, jp, salt=i if i % 2 else None)
        ts.set_slot(i, tp, salt=i if i % 2 else None)
    for col in range(5):
        logits = (rng.standard_normal((6, V)) * 2).astype(np.float32)
        slots = None if col != 2 else [1, 3, 4]
        lg = logits if slots is None else logits[slots]
        want = np.asarray(js.sample(jnp.asarray(lg), slots))
        assert np.array_equal(ts.sample(torch.from_numpy(lg), slots).numpy(), want)
        if col == 3:
            js.clear_slot(2)
            ts.clear_slot(2)
    js.advance([0, 1], 3)
    ts.advance([0, 1], 3)
    for a, b in zip(js.state(range(6)), ts.state(range(6))):
        assert np.array_equal(np.asarray(a), np.asarray(b).astype(np.asarray(a).dtype))
    for jp, tp, n in ((None, None, 4), (params[3], tparams[3], 4)):
        ju, tu = jsampling.BatchSampler.uniform(n, jp), tsampling.BatchSampler.uniform(n, tp)
        assert np.array_equal(ju.state(range(n))[0], tu.state(range(n))[0])


def test_greedy_sample_is_first_argmax_and_advances():
    s = tsampling.BatchSampler(3)
    lg = torch.tensor([[0.0, 2.0, 2.0], [5.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert s.sample(lg).tolist() == [1, 0, 2]          # first maximal index
    assert s.state(range(3))[1].tolist() == [1, 1, 1]  # token indices advanced
