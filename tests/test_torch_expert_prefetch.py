"""Port predictive per-expert streaming and the hot-expert LRU vs
``repro.serving.weights`` and ``repro.core.engine`` on the CPU, in f32,
with the JAX init's weights: the same tokens as resident decode, and the
same prediction hits, misses, LRU hits and copies as the JAX store."""
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
from repro.models import moe as jmoe  # noqa: E402
from repro.serving.weights import ParamStore as JStore  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serving.weights import ParamStore  # noqa: E402

B, S, DEC = 4, 12, 6


def _setup(arch="mixtral-8x7b"):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _pair(jcfg, cfg, jp, tp, predictor=None, **store_kw):
    """The JAX and the port engine over predictive stores built alike."""
    kw = dict(B=B, b_a=2, b_e=B, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC,
                 store=JStore(jcfg, jp, resident_bytes=0.0, **store_kw))
    te = ModuleBatchingEngine(cfg, None, Plan(**kw), max_seq=S + DEC, device="cpu",
                              store=ParamStore(cfg, tp, resident_bytes=0.0, device="cpu",
                                               **store_kw))
    je.predictor = te.predictor = predictor
    return je, te


def _counters(eng):
    st = eng.sync_stats()
    return (st.weight_htod_bytes, eng.store.prefetch_issued, eng.store.demand_fetches,
            st.expert_pred_hits, st.expert_pred_misses, st.expert_lru_hits,
            st.expert_lru_bytes)


def _resident_tokens(cfg, tp, toks):
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                               max_seq=S + DEC, device="cpu")
    return eng.generate(toks, DEC).numpy()


# ---------------------------------------------------------------------------
# Token identity and the counters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,khat,lru", [
    ("mixtral-8x7b", 1, None), ("mixtral-8x7b", 2, None), ("mixtral-8x7b", 4, None),
    ("mixtral-8x7b", 2, 1e9), ("jamba-1.5-large-398b", 2, None),
    ("jamba-1.5-large-398b", 2, 1e9)])
def test_predictive_streamed_matches_resident_and_jax(arch, khat, lru):
    """Predictive streaming gives the resident tokens and the JAX engine's,
    with the same bytes, prefetches, demand fetches, prediction hits and
    misses, LRU hits and LRU bytes as the JAX store."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    je, te = _pair(jcfg, cfg, jp, tp, predict_topk=khat, lru_bytes=lru)
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    b = te.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(b, _resident_tokens(cfg, tp, toks))
    got = _counters(te)
    assert got == _counters(je)
    assert got[0] > 0 and sum(got[3:6]) > 0      # the per-expert path ran


@pytest.mark.parametrize("which", ["empty", "always-last"])
def test_predictor_seam_prefetch_only(which):
    """An adversarial predictor changes which bytes are staged, never the
    tokens: mispredictions are fetched on demand.  Counters as the JAX
    engine's with the same predictor."""
    jcfg, cfg, jp, tp, toks = _setup()
    pred = {"empty": lambda nli, k: [],
            "always-last": lambda nli, k: [cfg.num_experts - 1]}[which]
    je, te = _pair(jcfg, cfg, jp, tp, predictor=pred, predict_topk=2, lru_bytes=0.0)
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    assert np.array_equal(te.generate(toks, DEC).numpy(), a)
    assert np.array_equal(a, _resident_tokens(cfg, tp, toks))
    got = _counters(te)
    assert got == _counters(je)
    assert got[4] > 0                            # wrong on purpose


def test_planned_reads_one_per_predictive_layer_and_tick():
    """The predictive stage reads the device once per streamed MoE layer
    and decode tick (the packed used + predicted vector), and nowhere
    else: prefill assembles whole stacks without one."""
    _, cfg, _, tp, toks = _setup()
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0, predict_topk=2),
                               max_seq=S + DEC, device="cpu", stream_weights=True,
                               resident_bytes=0.0)
    n_pred = sum(eng.store.streams_experts(li) for li in range(cfg.num_layers))
    eng.prefill(toks)
    assert eng.stats.planned_reads == 0
    eng.generate(toks, DEC)
    assert n_pred == cfg.num_layers and eng.stats.planned_reads == n_pred * (DEC - 1)


@pytest.mark.parametrize("khat", [1, 2, 8])
def test_predict_experts_matches_jax(khat):
    """The prediction itself: the same ids as ``repro.models.moe.
    predict_experts`` on the same router and hidden states."""
    jcfg, cfg, jp, tp, _ = _setup()
    rng = np.random.default_rng(khat)
    x = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    router = np.array(jp["layers"][0]["moe"]["router"][0])
    want = np.asarray(jmoe.predict_experts(jcfg, jnp.asarray(router), jnp.asarray(x), khat))
    got = tmoe.predict_experts(cfg, torch.from_numpy(router), torch.from_numpy(x), khat)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# Hot-expert LRU
# ---------------------------------------------------------------------------
def test_lru_respects_byte_budget_and_demotes_cold():
    """As the reference's: a budget of one and a half experts keeps one;
    the newer demotes the older; a reuse is an LRU hit with no copy."""
    jcfg, cfg, jp, tp, _ = _setup()
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * 4            # f32
    for st in (JStore(jcfg, jp, resident_bytes=0.0, predict_topk=2,
                      lru_bytes=1.5 * per_expert),
               ParamStore(cfg, tp, resident_bytes=0.0, predict_topk=2,
                          lru_bytes=1.5 * per_expert, device="cpu")):
        li = next(iter(st._experts_host))
        st.acquire_experts(li, [0])
        assert (li, 0) in st._lru
        st.acquire_experts(li, [1])              # budget fits only one
        assert (li, 1) in st._lru and (li, 0) not in st._lru
        assert st._lru_used <= st.lru_bytes
        ec = st.take_expert_counters()
        assert ec["pred_misses"] == 2 and ec["lru_hits"] == 0
        htod = st.take_counters()[0]
        st.acquire_experts(li, [1])              # hot hit, no copy
        assert st.take_expert_counters()["lru_hits"] == 1
        assert st.take_counters()[0] == 0 and htod > 0


def test_lru_zero_budget_never_caches():
    _, cfg, _, tp, _ = _setup()
    st = ParamStore(cfg, tp, resident_bytes=0.0, predict_topk=2, lru_bytes=0.0,
                    device="cpu")
    li = next(iter(st._experts_host))
    st.acquire_experts(li, [0])
    st.acquire_experts(li, [0])
    assert not st._lru and st._lru_used == 0
    assert st.take_expert_counters()["lru_hits"] == 0


def test_stack_rows_of_other_experts_stay_finite():
    """The (E, ...) stacks are shared by every predictive layer: a row the
    routing does not use keeps the last expert it held (zeros until
    then), which is finite; the used rows hold this layer's experts."""
    _, cfg, _, tp, _ = _setup()
    st = ParamStore(cfg, tp, resident_bytes=0.0, predict_topk=2, lru_bytes=0.0,
                    device="cpu")
    l0, l1 = sorted(st._experts_host)[:2]
    wg, _, _ = st.acquire_experts(l0, [0, 1])
    assert torch.count_nonzero(wg[2:]) == 0
    wg, wu, wd = st.acquire_experts(l1, [1])
    moe1 = tp["layers"][l1]["moe"]
    assert torch.equal(wg[1], moe1["experts_w_gate"][1])
    assert torch.equal(wd[1], moe1["experts_w_down"][1])
    assert torch.equal(wg[0], tp["layers"][l0]["moe"]["experts_w_gate"][0])
    assert all(torch.isfinite(t).all() for t in (wg, wu, wd))


# ---------------------------------------------------------------------------
# Serving surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_predictive_server_report_matches_jax(scheduler):
    """The report folds the prediction and LRU counters per drain: equal to
    the JAX server's, with the resident tokens."""
    from repro.serving.server import Request as JRequest
    from repro.serving.server import ServeConfig as JServeConfig
    from repro.serving.server import Server as JServer
    from repro.serving.server import StreamConfig as JStreamConfig
    from repro_torch.serving.server import Request, ServeConfig, Server, StreamConfig

    jcfg, cfg, jp, tp, _ = _setup()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (9, 5, 12, 7)]
    kw = dict(B=4, b_a=2, b_e=8, omega=0.0)
    stream = dict(stream_weights=True, resident_bytes=0.0, predict_topk=2)
    js = JServer(jcfg, jp, JPlan(**kw), serve=JServeConfig(scheduler=scheduler, decode_len=5),
                 stream=JStreamConfig(**stream))
    ts = Server(cfg, tp, Plan(**kw), serve=ServeConfig(scheduler=scheduler, decode_len=5),
                stream=StreamConfig(**stream), device="cpu")
    ref = Server(cfg, tp, Plan(**kw), serve=ServeConfig(scheduler=scheduler, decode_len=5),
                 device="cpu")
    for p in prompts:
        js.submit(JRequest(p, 5))
        ts.submit(Request(p, 5))
        ref.submit(Request(p, 5))
    jr, tr, rr = js.run(), ts.run(), ref.run()
    for a, b, c in zip(jr.request_results, tr.request_results, rr.request_results):
        assert np.array_equal(a.tokens, b.tokens) and np.array_equal(b.tokens, c.tokens)
    fields = ("weight_htod_bytes", "expert_pred_hits", "expert_pred_misses",
              "expert_lru_hits")
    assert [getattr(tr, f) for f in fields] == [getattr(jr, f) for f in fields]
    assert tr.pred_hit_rate == pytest.approx(jr.pred_hit_rate)
    assert tr.lru_hit_rate == pytest.approx(jr.lru_hit_rate)
    assert tr.htod_gb > 0 and rr.htod_gb == 0
