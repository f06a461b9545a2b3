"""Host attention (the omega split) in the port against the JAX package on
the CPU, in f32: the §B mechanism against ``repro.core.host_attention``,
the omega engine against the JAX engine, and the fused omega chunk against
the per-module one."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import host_attention as jhost  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.core.engine import ModuleBatchingEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import host_attention as thost  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

B, S, DEC = 4, 12, 6
REL = 1e-4          # logits bound of tests/test_engine.py:47-54


def _setup(arch="mixtral-8x7b"):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,K", [(8, 2), (4, 4)])
def test_host_decode_attention_matches_jax(dtype, H, K):
    """Ragged positions, GQA: every output equals the JAX mechanism's or is
    one bf16 ulp from it, and at least 99% are equal."""
    rng = np.random.default_rng(7)
    Bq, Sk, D = 6, 40, 32
    q = rng.standard_normal((Bq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sk, K, D)).astype(np.float32)
    pos = np.array([39, 0, 17, 5, 31, 22])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(jhost.host_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos)), np.float32)
    got = thost.host_decode_attention(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
                                      torch.from_numpy(v).to(tdt), pos).numpy()
    assert got.dtype == np.float32 and got.shape == (Bq, H, D)
    assert np.array_equal(thost.round_bf16(torch.from_numpy(got)).numpy(), got)
    diff = np.abs(got - want)
    exact = float((diff == 0).mean())
    assert (diff <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
    assert exact >= 0.99, exact


def test_host_decode_attention_masks_past_pos():
    """Slots past a row's position never reach its output."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((3, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((3, 10, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((3, 10, 2, 16)).astype(np.float32))
    pos = np.array([9, 4, 0])
    out = thost.host_decode_attention(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    for b, p in enumerate(pos):
        k2[b, p + 1:] = 1e4
        v2[b, p + 1:] = -1e4
    assert torch.equal(out, thost.host_decode_attention(q, k2, v2, pos))


@pytest.mark.parametrize("omega", [0.25, 0.5, 0.75, 1.0])
def test_omega_engine_matches_jax_engine(omega):
    """The omega split against the JAX engine (one micro-batch of 4 rows,
    split at round(omega * B)): logits within 1e-4 of their scale at every
    decode step (no bf16 rounding of the host mechanism flips at these
    seeds), equal greedy tokens, and the realised split equal to the
    reference's (tests/test_engine.py:158-171)."""
    jcfg, cfg, jp, tp, toks = _setup()
    kw = dict(B=B, b_a=4, b_e=B, omega=omega)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu")
    lj = np.asarray(je.prefill(jnp.asarray(toks)))
    lt = te.prefill(toks).numpy()
    scale = float(np.abs(lj).max())
    assert np.abs(lt - lj).max() / scale < REL
    nxt = lj.argmax(-1)
    for t in range(3):
        lj = np.asarray(je.decode_step(jnp.asarray(nxt), S + t))
        lt = te.decode_step(nxt, S + t).numpy()
        assert np.abs(lt - lj).max() / scale < REL, t
        assert np.array_equal(lt.argmax(-1), lj.argmax(-1))
        nxt = lj.argmax(-1)
    n_attn = sum(1 for kind, _ in te.schema if kind == "attn")
    assert te.stats.host_attn_tokens == je.stats.host_attn_tokens
    assert te.stats.host_attn_tokens == 3 * int(round(omega * B)) * n_attn
    assert te.stats.device_attn_tokens == je.stats.device_attn_tokens
    assert te.stats.attn_microbatches == je.stats.attn_microbatches
    assert te.stats.planned_reads == 3 * n_attn     # one per host micro-batch


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b", "jamba-1.5-large-398b"])
def test_omega_generate_matches_jax_generate(arch):
    """Greedy generate at omega 0.5 with a straddling micro-batch (b_a 3):
    the JAX engine's tokens and realised split."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    kw = dict(B=B, b_a=3, b_e=B, omega=0.5)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu")
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    b = te.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert te.stats.host_attn_tokens == je.stats.host_attn_tokens > 0
    assert te.stats.device_attn_tokens == je.stats.device_attn_tokens


@pytest.mark.parametrize("sampled", [False, True])
def test_fused_omega_chunk_matches_per_module(sampled):
    """omega 0.5: the host rows run per module beside the fused chunk of the
    device rows, and the tokens equal the all-per-module oracle's
    (tests/test_fused_decode.py:90); seeded sampling is a pure function of
    (logits, seed, t), so it too does not depend on a row's path."""
    _, cfg, _, tp, toks = _setup()
    plan = Plan(B=B, b_a=2, b_e=B, omega=0.5, decode_chunk=4)
    sampling = SamplingParams(temperature=0.8, top_k=5, seed=3) if sampled else None
    ref = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu",
                               fused_decode=False)
    want = ref.generate(toks, DEC, sampling=sampling, chunk=1).numpy()
    eng = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu")
    got = eng.generate(toks, DEC, sampling=sampling, chunk=4).numpy()
    assert np.array_equal(want, got)
    assert eng.stats.fused_dispatches > 0 and ref.stats.fused_dispatches == 0
    n_attn = sum(1 for kind, _ in eng.schema if kind == "attn")
    assert eng.stats.host_attn_tokens == ref.stats.host_attn_tokens == 2 * (DEC - 1) * n_attn
    assert eng.stats.device_attn_tokens == ref.stats.device_attn_tokens
    assert eng.stats.planned_reads == ref.stats.planned_reads == (DEC - 1) * n_attn


def test_fused_omega_one_runs_every_row_per_module():
    """omega 1.0: every row is a host row, so the chunk runs per module."""
    _, cfg, _, tp, toks = _setup()
    plan = Plan(B=B, b_a=2, b_e=B, omega=1.0, decode_chunk=4)
    eng = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu")
    ref = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu",
                               fused_decode=False)
    assert np.array_equal(eng.generate(toks, DEC).numpy(), ref.generate(toks, DEC).numpy())
    assert eng.stats.fused_dispatches == 0 and eng.stats.device_attn_tokens == 0


def test_host_rows_kv_lives_on_the_host_and_evicts():
    """Contiguous omega: rows [0, n_host) of each attention layer live in a
    host buffer, in the host mechanism's layout (``to_heads``), that prefill
    fills (equal to the device cache's rows) and eviction zeroes."""
    _, cfg, _, tp, toks = _setup()
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.5),
                               max_seq=S + DEC, device="cpu")
    eng.prefill(toks)
    assert eng.n_host == 2
    for li, kv in eng._host_kv.items():
        assert kv["k"].device.type == "cpu" and kv["k"].shape[0] == 2
        assert torch.equal(kv["k"], thost.to_heads(eng.cache[li]["k"][:2]))
        assert torch.equal(kv["v"], thost.to_heads(eng.cache[li]["v"][:2]))
    eng.evict_slots([1, 3])
    for kv in eng._host_kv.values():
        assert torch.count_nonzero(kv["k"][1]) == 0 and torch.count_nonzero(kv["k"][0]) > 0
