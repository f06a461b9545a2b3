"""The prefix cache and online capacity re-planning in the port against the
JAX package on the CPU, in f32: ``PrefixStore`` keys, LRU and support; the
engine's prefix capture and prefix-hit admission (logits, the written KV
rows and a launch count independent of the prefix length) in Mode A and
Mode B; serving with the prefix cache against cold serving and the JAX
``Server``; and the server's re-plan decisions and tokens against the JAX
``Server``'s on the same skewed requests."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.core.engine import ModuleBatchingEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import cache as jcache  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.cache import CacheConfig, PrefixStore  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

DEC = 5
RTOL = 1e-4


def _setup(arch="mixtral-8x7b"):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def _prompts(cfg, lens, seed=3, shared=0):
    """Prompts of ``shared`` common tokens, then each its own ``lens[i]``."""
    rng = np.random.default_rng(seed)
    pre = rng.integers(5, cfg.vocab_size - 5, size=shared)
    return [np.concatenate([pre, rng.integers(5, cfg.vocab_size - 5, size=n)]).astype(np.int32)
            for n in lens]


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(float(np.abs(b).max()), 1e-30)
    assert float(np.abs(a - b).max()) / scale < rtol, float(np.abs(a - b).max()) / scale


# ---------------------------------------------------------------------------
# PrefixStore
# ---------------------------------------------------------------------------
def test_prefix_store_keys_lru_and_support_match_reference():
    """The same calls give the same keys, spans, hits, misses, hit rate and
    LRU order as the JAX store; ``supported`` agrees on every config."""
    ours, theirs = PrefixStore(page_tokens=4, entries=2), jcache.PrefixStore(4, entries=2)
    rng = np.random.default_rng(0)
    prompts = [np.arange(4), np.arange(9), np.arange(8), rng.integers(0, 50, 13),
               np.arange(9), rng.integers(0, 50, 17)]
    for p in prompts:
        assert ours.key(p) == theirs.key(p)
    calls = [("get", 1), ("put", 1), ("get", 1), ("put", 3), ("touch", 1), ("put", 5),
             ("get", 3), ("get", 1), ("put", 2), ("get", 5), ("get", 4)]
    for op, i in calls:
        key = ours.key(prompts[i])[0]
        if op == "get":
            assert (ours.get(key) is None) == (theirs.get(key) is None), (op, i)
        elif op == "put":
            ours.put(key, [i])
            theirs.put(key, [i])
        else:                                  # touch == the reference's put of a stored key
            if ours.touch(key):
                theirs.put(key, None)
        assert list(ours._store) == list(theirs._store), (op, i)
        assert (ours.hits, ours.misses, ours.hit_rate) == (
            theirs.hits, theirs.misses, theirs.hit_rate)
    for arch in ("mixtral-8x7b", "olmoe-1b-7b", "h2o-danube-1.8b", "mamba2-370m",
                 "jamba-1.5-large-398b", "qwen2-1.5b"):
        cfg = get_config(arch, smoke=True)
        assert PrefixStore.supported(cfg) == jcache.PrefixStore.supported(
            jget(arch, smoke=True)), arch


def test_prefix_cache_config_requires_paging():
    assert CacheConfig(page_tokens=8, prefix_cache=True).prefix_cache
    with pytest.raises(AssertionError, match="paging"):
        CacheConfig(prefix_cache=True)
    with pytest.raises(AssertionError, match="paging"):
        ServeConfig(prefix_cache=True)
    assert ServeConfig(kv_page_tokens=8, prefix_cache=True).prefix_cache


# ---------------------------------------------------------------------------
# The engine: capture and prefix-hit admission
# ---------------------------------------------------------------------------
def _kernel_calls(monkeypatch):
    """Count the kernel ops' calls (on the CPU no launch is counted)."""
    calls = {"flash_attention": 0, "grouped_expert_ffn": 0}
    for name in calls:
        fn = getattr(ops, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ops, name, wrapped)
    return calls


def _row_kv(eng, li, row, n):
    """Row ``row``'s first ``n`` KV slots of layer ``li`` as numpy, from the
    port's engine or the JAX engine."""
    pages = eng.pages
    if pages is not None and not pages.fully_resident:
        if isinstance(pages, jcache.KVPageTable):
            k, v = pages.read_row(li, row, n)
        else:
            k, v = (t[0] for t in pages.read_rows(li, [row], n))
        return np.asarray(k), np.asarray(v)
    return (np.asarray(eng.cache[li]["k"][row, :n]), np.asarray(eng.cache[li]["v"][row, :n]))


@pytest.mark.parametrize("device_pool", [None, 1.0], ids=["mode-A", "mode-B"])
def test_prefix_hit_matches_jax_engine(device_pool, monkeypatch):
    """Prefill a prompt into row 0, capture its prefix, admit a second prompt
    with the same prefix into row 1 as a hit: the captured rows equal the
    JAX engine's, the hit's logits (from the JAX engine's own stored rows
    too) and the row's written KV equal the JAX hit's within 1e-4, and the
    kernel calls per hit do not depend on the prefix length."""
    jcfg, cfg, jp, tp = _setup()
    pt = 4
    cc = CacheConfig(page_tokens=pt, device_pool_bytes=device_pool, prefix_cache=True)
    jcc = jcache.CacheConfig(page_tokens=pt, device_pool_bytes=device_pool, prefix_cache=True)
    plan, jplan = Plan(B=2, b_a=2, b_e=16, omega=0.0), JPlan(B=2, b_a=2, b_e=16, omega=0.0)
    calls = _kernel_calls(monkeypatch)
    per_hit = []
    for npre in (8, 12):
        pa, pb = _prompts(cfg, [2, 3], seed=npre, shared=npre)
        eng = ModuleBatchingEngine(cfg, tp, plan, max_seq=npre + 8, cache_config=cc,
                                   device="cpu")
        jeng = JEngine(jcfg, jp, jplan, max_seq=npre + 8, cache_config=jcc)
        eng.init_cache(2)
        jeng.init_cache(2)
        _close(eng.prefill_slots(pa[None], [0]), jeng.prefill_slots(jnp.asarray(pa)[None], [0]))
        kvs, jkvs = eng.read_prefix_rows(0, npre), jeng.read_prefix_rows(0, npre)
        assert eng.stats.planned_reads == (1 if device_pool is None else 0)
        for (k, v), (jk, jv) in zip(kvs, jkvs):
            assert k.shape == (npre, cfg.num_kv_heads, cfg.head_dim)
            _close(k, jk)
            _close(v, jv)
        before = dict(calls)
        lg = eng.prefill_prefix_hit(1, pb, kvs, npre)
        per_hit.append({n: calls[n] - before[n] for n in calls})
        jlg = jeng.prefill_prefix_hit(1, list(pb), jkvs, npre)
        _close(lg, jlg)
        # the JAX engine's stored rows through the port's admission
        lg2 = eng.prefill_prefix_hit(1, pb, [(torch.from_numpy(np.array(k)),
                                              torch.from_numpy(np.array(v)))
                                             for k, v in jkvs], npre)
        _close(lg2, jlg)
        for li in range(cfg.num_layers):
            k, v = _row_kv(eng, li, 1, len(pb))
            jk, jv = _row_kv(jeng, li, 1, len(pb))
            _close(k, jk)
            _close(v, jv)
    n_moe = sum(1 for i in range(cfg.num_layers) if cfg.ffn_kind(i) == "moe")
    assert per_hit[0] == per_hit[1] == {"flash_attention": cfg.num_layers,
                                        "grouped_expert_ffn": n_moe}


def test_prefix_hit_decodes_as_a_cold_prefill():
    """A row admitted as a hit then decodes the same tokens as the same
    prompt prefilled cold (contiguous cache, the fused chunk's CPU body)."""
    _, cfg, _, tp = _setup("olmoe-1b-7b")
    plan = Plan(B=2, b_a=2, b_e=2, omega=0.0)
    pa, pb = _prompts(cfg, [3, 5], shared=8)
    cold = ModuleBatchingEngine(cfg, tp, plan, max_seq=24, device="cpu")
    want = cold.generate(pb[None], DEC)
    eng = ModuleBatchingEngine(cfg, tp, plan, max_seq=24, device="cpu",
                               cache_config=CacheConfig(page_tokens=4))
    eng.init_cache(2)
    eng.prefill_slots(pa[None], [0])
    lg = eng.prefill_prefix_hit(1, pb, eng.read_prefix_rows(0, 8), 8)
    tok = lg.argmax(-1)
    from repro_torch.serving.sampling import BatchSampler

    toks = eng.decode_chunk(torch.stack([tok[0], tok[0]]), np.array([len(pb)] * 2),
                            BatchSampler(2), DEC - 1)
    assert int(tok[0]) == int(want[0, 0])
    assert torch.equal(toks[1], want[0, 1:])


# ---------------------------------------------------------------------------
# Serving with the prefix cache
# ---------------------------------------------------------------------------
def _serve(server, prompts, dec=DEC, req=Request):
    for p in prompts:
        server.submit(req(p, dec))
    return server.run()


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_prefix_serving_matches_cold_and_jax_server(scheduler):
    """Three prompts sharing a 9-token span at page 8 (each keyed at pspan
    8) on two slots: the port with the prefix cache gives the cold port's
    and the JAX ``Server``'s tokens, and the JAX server's hits and misses;
    ``prefill_tokens`` counts only a hit's suffix."""
    jcfg, cfg, jp, tp = _setup()
    prompts = _prompts(cfg, [3, 2, 4], seed=5, shared=9)
    plan, jplan = Plan(B=2, b_a=2, b_e=16, omega=0.0), JPlan(B=2, b_a=2, b_e=16, omega=0.0)
    kw = dict(scheduler=scheduler, decode_len=DEC, max_seq=24)
    cold = _serve(Server(cfg, tp, plan, serve=ServeConfig(**kw), device="cpu"), prompts)
    rep = _serve(Server(cfg, tp, plan, device="cpu",
                        serve=ServeConfig(kv_page_tokens=8, prefix_cache=True, **kw)),
                 prompts)
    jrep = _serve(JServer(jcfg, jp, jplan, serve=JServeConfig(kv_page_tokens=8,
                                                              prefix_cache=True, **kw)),
                  [p.tolist() for p in prompts], req=JRequest)
    for a, b, c in zip(cold.request_results, rep.request_results, jrep.request_results):
        assert np.array_equal(a.tokens, b.tokens), (scheduler, a.index)
        assert np.array_equal(b.tokens, np.asarray(c.tokens)), (scheduler, a.index)
    assert (rep.prefix_hits, rep.prefix_misses) == (jrep.prefix_hits, jrep.prefix_misses)
    assert rep.prefix_hits >= 1 and rep.prefix_hit_rate == jrep.prefix_hit_rate
    assert rep.prefill_tokens == jrep.prefill_tokens < cold.prefill_tokens


def test_prefix_cache_dropped_for_unsupported_model():
    """A sliding-window model cannot take a stored prefix: the server serves
    without the store, as the reference does (no hit, no miss)."""
    jcfg, cfg, jp, tp = _setup("h2o-danube-1.8b")
    prompts = _prompts(cfg, [3, 2], shared=9)
    plan = Plan(B=2, b_a=2, b_e=16, omega=0.0)
    kw = dict(decode_len=4, max_seq=18, kv_page_tokens=4, prefix_cache=True)
    server = Server(cfg, tp, plan, serve=ServeConfig(**kw), device="cpu")
    assert server._prefix is None
    rep = _serve(server, prompts, 4)
    jrep = _serve(JServer(jcfg, jp, JPlan(B=2, b_a=2, b_e=16, omega=0.0),
                          serve=JServeConfig(**kw)), [p.tolist() for p in prompts], 4, JRequest)
    assert rep.prefix_hits == rep.prefix_misses == jrep.prefix_hits == jrep.prefix_misses == 0
    for a, b in zip(rep.request_results, jrep.request_results):
        assert np.array_equal(a.tokens, np.asarray(b.tokens))


# ---------------------------------------------------------------------------
# Online capacity re-planning
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_replan_matches_jax_server(scheduler):
    """Four requests decoding 26 tokens one tick a step (re-plan checks at
    steps 8, 16 and 24) with a drift threshold the seeded routing crosses:
    the same re-plans, the same b_e pushed into the engine and the same
    tokens as the JAX ``Server``; the re-planned capacity drops copies."""
    jcfg, cfg, jp, tp = _setup()
    prompts = _prompts(cfg, [6, 9, 4, 8], seed=11)
    kw = dict(scheduler=scheduler, decode_len=26, max_seq=40, decode_chunk=1,
              replan_skew=1e-3, replan_drop_target=0.2)
    server = Server(cfg, tp, Plan(B=4, b_a=2, b_e=4, omega=0.0), serve=ServeConfig(**kw),
                    device="cpu")
    rep = _serve(server, prompts, 26)
    jserver = JServer(jcfg, jp, JPlan(B=4, b_a=2, b_e=4, omega=0.0), serve=JServeConfig(**kw))
    jrep = _serve(jserver, [p.tolist() for p in prompts], 26, JRequest)
    assert rep.capacity_replans == jrep.capacity_replans >= 1
    assert server._engine._b_e_override == jserver._engine._b_e_override < 4
    assert server._engine.stats.planned_reads == 3
    assert rep.expert_tokens_dropped == jrep.expert_tokens_dropped > 0
    for a, b in zip(rep.request_results, jrep.request_results):
        assert np.array_equal(a.tokens, np.asarray(b.tokens)), a.index
    # the per-module path re-plans the same way and gives the same tokens
    oracle = Server(cfg, tp, Plan(B=4, b_a=2, b_e=4, omega=0.0), serve=ServeConfig(**kw),
                    device="cpu")
    for p in prompts:
        oracle.submit(Request(p, 26))
    oracle._ensure_engine()
    oracle._engine.fused_decode = False
    orep = oracle.run()
    assert orep.capacity_replans == rep.capacity_replans
    assert oracle._engine.stats.fused_ticks == 0 < server._engine.stats.fused_ticks
    for a, b in zip(rep.request_results, orep.request_results):
        assert np.array_equal(a.tokens, b.tokens), a.index


def test_set_expert_capacity_overrides_and_restores():
    _, cfg, _, tp = _setup()
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=4, b_a=2, b_e=4, omega=0.0), max_seq=16,
                               device="cpu")
    assert eng._expert_capacity(4) == 4
    eng.set_expert_capacity(1)
    assert eng._expert_capacity(4) == 1
    eng.set_expert_capacity(None)
    assert eng._expert_capacity(4) == 4
