"""Port ``ParamStore`` (weight streaming) vs ``repro.serving.weights`` on the
CPU, in f32, with the JAX init's weights: the same residency split, the
same copies counted, and streamed generation equal to resident generation
and to the JAX streamed engine."""
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
from repro.serving.weights import ParamStore as JStore  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import workload as W  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import weights as weights_mod  # noqa: E402
from repro_torch.serving.weights import ParamStore  # noqa: E402

B, S, DEC = 4, 12, 6
REL = 1e-4          # logits bound of tests/test_engine.py


def _setup(arch, **over):
    jcfg = replace(jget(arch, smoke=True), dtype="float32", **over)
    cfg = replace(get_config(arch, smoke=True), dtype="float32", **over)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _engines(jcfg, cfg, jp, tp, **store_kw):
    """The JAX and the port engine, each over its own store built with
    ``store_kw`` (None: every weight resident)."""
    kw = dict(B=B, b_a=2, b_e=B, omega=0.0)
    js = JStore(jcfg, jp, **store_kw)
    ts = ParamStore(cfg, tp, device="cpu", **store_kw)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC, store=js)
    te = ModuleBatchingEngine(cfg, None, Plan(**kw), max_seq=S + DEC, store=ts,
                              device="cpu")
    return je, te


def _counters(eng, store):
    eng.sync_stats()
    return (eng.stats.weight_htod_bytes, store.prefetch_issued, store.demand_fetches)


def _resident_tokens(cfg, tp, toks):
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                               max_seq=S + DEC, device="cpu")
    return eng.generate(toks, DEC).numpy()


# ---------------------------------------------------------------------------
# Exactness: streamed == resident == the JAX streamed engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "serial"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_streamed_generate_matches_resident_and_jax(arch, prefetch):
    """Every per-layer module streamed (budget 0): the port's tokens equal
    its resident engine's and the JAX streamed engine's, and the bytes,
    prefetches and demand fetches equal the JAX store's."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    je, te = _engines(jcfg, cfg, jp, tp, resident_bytes=0.0, prefetch=prefetch)
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    b = te.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(b, _resident_tokens(cfg, tp, toks))
    assert _counters(te, te.store) == _counters(je, je.store)
    assert te.stats.weight_htod_bytes > 0 and te.stats.expert_tokens_dropped == 0
    if not prefetch:
        assert te.store.prefetch_issued == 0 and te.store.demand_fetches > 0


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_streamed_partial_budget_matches_resident_and_jax(arch):
    """A budget of the base and every mixer: the mixers are resident, the
    expert stacks stream; split, tokens and counters as the JAX store's."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    budget = W.base_weight_bytes(cfg) + sum(
        W.mixer_weight_bytes(cfg, cfg.layer_kind(i)) for i in range(cfg.num_layers))
    je, te = _engines(jcfg, cfg, jp, tp, resident_bytes=budget)
    rp, jrp = te.store.residency, je.store.residency
    assert all(rp.mixer_resident)
    assert not any(rp.ffn_resident[i] for i in range(cfg.num_layers)
                   if cfg.ffn_kind(i) == "moe")
    assert (rp.mixer_resident, rp.ffn_resident) == (jrp.mixer_resident, jrp.ffn_resident)
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    b = te.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(b, _resident_tokens(cfg, tp, toks))
    assert _counters(te, te.store) == _counters(je, je.store)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_streamed_logits_match_jax_streamed_engine(arch):
    """Prefill and two decode steps through streamed stores: logits within
    1e-4 of their scale of the JAX engine's, greedy tokens equal."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    je, te = _engines(jcfg, cfg, jp, tp, resident_bytes=0.0)
    lj = np.asarray(je.prefill(jnp.asarray(toks)))
    lt = te.prefill(toks).numpy()
    scale = float(np.abs(lj).max())
    assert np.abs(lt - lj).max() / scale < REL
    nxt = lj.argmax(-1)
    for t in range(2):
        lj = np.asarray(je.decode_step(jnp.asarray(nxt), S + t))
        lt = te.decode_step(nxt, S + t).numpy()
        assert np.abs(lt - lj).max() / scale < REL
        assert np.array_equal(lt.argmax(-1), lj.argmax(-1))
        nxt = lj.argmax(-1)
    assert _counters(te, te.store) == _counters(je, je.store)


def test_streamed_single_layer_model_wraps():
    """One layer: the prefetch wraps onto the same layer (the next step's)
    and generation stays exact."""
    jcfg, cfg, jp, tp, toks = _setup("mixtral-8x7b", num_layers=1)
    je, te = _engines(jcfg, cfg, jp, tp, resident_bytes=0.0)
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    assert np.array_equal(te.generate(toks, DEC).numpy(), a)
    assert _counters(te, te.store) == _counters(je, je.store)


def test_everything_resident_budget_is_a_no_op():
    """A budget above the model pins everything: no host set, no copies,
    no window slots, and the fused path stays eligible."""
    _, cfg, _, tp, toks = _setup("mixtral-8x7b")
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                               max_seq=S + DEC, device="cpu", stream_weights=True,
                               resident_bytes=float(W.model_bytes(cfg)) + 1e9)
    assert eng.store.fully_resident and eng.fused_eligible()
    assert np.array_equal(eng.generate(toks, DEC).numpy(), _resident_tokens(cfg, tp, toks))
    assert eng.stats.weight_htod_bytes == 0 and eng.stats.prefetch_wait_s == 0.0
    assert eng.store.device_buffer_bytes() == 0


# ---------------------------------------------------------------------------
# ParamStore unit behaviour, against the JAX store
# ---------------------------------------------------------------------------
def _budgets(cfg):
    base = W.base_weight_bytes(cfg)
    one_mixer = base + W.mixer_weight_bytes(cfg, cfg.layer_kind(0))
    mixers = base + sum(W.mixer_weight_bytes(cfg, cfg.layer_kind(i))
                        for i in range(cfg.num_layers))
    return {"zero": 0.0, "one-mixer": one_mixer, "mixers": mixers,
            "mixers+1-stack": mixers + W.ffn_module_weight_bytes(cfg, "moe"),
            "model": float(W.model_bytes(cfg)), "none": None}


@pytest.mark.parametrize("budget", ["zero", "one-mixer", "mixers", "mixers+1-stack",
                                    "model", "none"])
def test_store_residency_split_matches_jax(budget):
    """The greedy split, the resident and streamed bytes and the
    fully-resident flag equal the JAX store's at each budget."""
    jcfg, cfg, jp, tp, _ = _setup("jamba-1.5-large-398b")
    rb = _budgets(cfg)[budget]
    js, ts = JStore(jcfg, jp, resident_bytes=rb), ParamStore(cfg, tp, resident_bytes=rb,
                                                             device="cpu")
    assert (ts.residency.mixer_resident, ts.residency.ffn_resident) == (
        js.residency.mixer_resident, js.residency.ffn_resident)
    assert ts.residency.resident_bytes == pytest.approx(js.residency.resident_bytes)
    assert ts.resident_module_bytes() == js.resident_module_bytes()
    assert ts.streamed_module_bytes() == js.streamed_module_bytes()
    assert ts.fully_resident == js.fully_resident
    assert ts.describe() == js.describe()


def test_store_prefetch_window_bounded_and_counters_drain():
    """As the reference's: the window holds at most ``depth`` keys, acquire
    consumes the in-flight entry, a fetch that was never staged is a demand
    fetch, and ``take_counters`` drains."""
    _, cfg, _, tp, _ = _setup("jamba-1.5-large-398b")
    st = ParamStore(cfg, tp, resident_bytes=0.0, prefetch_depth=2, device="cpu")
    for li in range(len(st.schema)):
        st.prefetch(li)
        assert len(st._inflight) <= 2
    assert st.prefetch_issued == len(st.schema)
    st2 = ParamStore(cfg, tp, resident_bytes=0.0, device="cpu")
    st2.prefetch(0)
    p = st2.acquire(0)
    assert "norm1" in p and 0 not in st2._inflight
    assert st2.demand_fetches == 0
    st2.acquire(1)                           # never prefetched
    assert st2.demand_fetches == 1
    htod, wait = st2.take_counters()
    assert htod == sum(h.layout.nbytes for h in st2._host[:2]) and wait == 0.0
    assert st2.take_counters() == (0, 0.0)   # drained


def test_store_prefetch_disabled_is_serial():
    _, cfg, _, tp, _ = _setup("mixtral-8x7b")
    st = ParamStore(cfg, tp, resident_bytes=0.0, prefetch=False, device="cpu")
    st.prefetch(0)                           # no-op
    assert not st._inflight
    st.acquire(0)
    assert st.demand_fetches == 1


@pytest.mark.parametrize("depth", [1, 3])
def test_window_depth_counts_match_jax(depth):
    """A window of depth 1 (one slot, which the consumer holds while the
    next layer's prefetch is issued: that copy waits for the slot) and of
    depth 3: the same tokens, bytes, prefetches and demand fetches as the
    JAX store at that depth."""
    jcfg, cfg, jp, tp, toks = _setup("mixtral-8x7b", num_layers=3)
    kw = dict(B=B, b_a=2, b_e=B, omega=0.0)
    js = JStore(jcfg, jp, resident_bytes=0.0, prefetch_depth=depth)
    ts = ParamStore(cfg, tp, resident_bytes=0.0, prefetch_depth=depth, device="cpu")
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC, store=js)
    te = ModuleBatchingEngine(cfg, None, Plan(**kw), max_seq=S + DEC, store=ts,
                              device="cpu")
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    assert np.array_equal(te.generate(toks, DEC).numpy(), a)
    assert _counters(te, ts) == _counters(je, js)
    assert len(ts._window._slots) == depth


# (prefetch_depth, the calls, the layers whose copy is really queued, in order)
_COPY_CASES = {
    # layer 1's prefetch finds the only slot leased and is deferred, then
    # dropped for layer 2's before it had a slot: never copied
    "dropped-before-slot": (1, [("p", 0), ("a", 0), ("p", 1), ("p", 2), ("a", 2)],
                            [0, 2]),
    # the demand fetch of layer 2 takes the slot of layer 0's finished
    # prefetch, so acquiring layer 0 copies it again
    "slot-taken": (2, [("p", 0), ("p", 1), ("a", 2), ("a", 0)], [0, 1, 2, 0]),
}


@pytest.mark.parametrize("case", sorted(_COPY_CASES))
def test_window_copied_bytes_count_real_copies(case):
    """``htod_bytes``, ``issued`` and ``demand`` keep the reference's
    counts (equal to the JAX store's on the same calls), while
    ``copied_bytes`` counts the copies really queued."""
    jcfg, cfg, jp, tp, _ = _setup("mixtral-8x7b", num_layers=3)
    depth, calls, copied = _COPY_CASES[case]
    js = JStore(jcfg, jp, resident_bytes=0.0, prefetch_depth=depth)
    ts = ParamStore(cfg, tp, resident_bytes=0.0, prefetch_depth=depth, device="cpu")
    for op, li in calls:
        for st in (js, ts):
            st.prefetch(li) if op == "p" else st.acquire(li)
    assert ((ts.htod_bytes, ts.prefetch_issued, ts.demand_fetches)
            == (js.htod_bytes, js.prefetch_issued, js.demand_fetches))
    assert ts._window.copies == len(copied)
    assert ts.copied_bytes == sum(ts._host[li].layout.size for li in copied)
    assert ts.take_counters()[0] == js.take_counters()[0]
    assert ts.copied_bytes == sum(ts._host[li].layout.size for li in copied)  # not drained


@pytest.mark.parametrize("predict_topk", [0, 2], ids=["whole-stack", "per-expert"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b"])
def test_seeded_store_is_bit_equal_to_init_params_split(arch, predict_topk):
    """``ParamStore.seeded`` (each layer drawn with ``init_params``'s
    generator, in its order, and placed at once) holds bit for bit what a
    store of ``init_params(cfg, seed)`` holds: resident modules, streamed
    modules (through ``acquire``, which copies them in) and base
    weights."""
    cfg = get_config(arch, smoke=True)
    budget = _budgets(cfg)["one-mixer"]
    kw = dict(resident_bytes=budget, predict_topk=predict_topk, device="cpu")
    a = ParamStore(cfg, M.init_params(cfg, seed=5, device="cpu"), **kw)
    b = ParamStore.seeded(cfg, seed=5, **kw)
    for k in a.base:
        assert torch.equal(a.base[k], b.base[k]), k
    for li in range(cfg.num_layers):
        pa, pb = a.acquire(li), b.acquire(li)
        la, lb = list(weights_mod._leaves(pa)), list(weights_mod._leaves(pb))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, ta), (_, tb) in zip(la, lb):
            assert ta.dtype == tb.dtype and torch.equal(ta, tb), (li, path)
    assert a.streamed_module_bytes() == b.streamed_module_bytes() > 0


def test_close_frees_the_store():
    """``close`` (and dropping the store) frees the window slots, the
    stacks and the LRU; a CPU store pins no host memory."""
    _, cfg, _, tp, _ = _setup("mixtral-8x7b")
    before = weights_mod.pinned_bytes()
    st = ParamStore(cfg, tp, resident_bytes=0.0, predict_topk=2, lru_bytes=1e9,
                    device="cpu")
    assert st.device_buffer_bytes() > 0 and weights_mod.pinned_bytes() == before
    st.close()
    assert st.device_buffer_bytes() == 0 and not st._experts_host
    st.close()                               # idempotent


def test_streaming_entry_points_default_to_cuda():
    """The store's entry points run on ``cuda`` unless asked for the CPU,
    and raise without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, cfg, _, tp, _ = _setup("mixtral-8x7b")
    with pytest.raises(RuntimeError, match="cuda"):
        ParamStore(cfg, tp, resident_bytes=0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ParamStore.seeded(cfg, 0, resident_bytes=0.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ModuleBatchingEngine(cfg, tp, Plan(B=2, b_a=2, b_e=2), stream_weights=True,
                             resident_bytes=0.0)


# ---------------------------------------------------------------------------
# Serving surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_serve_dataset_streaming_reports_htod_like_jax(scheduler):
    """Streamed serving returns the resident tokens and the JAX server's,
    with the same htod bytes in the report."""
    from repro.data.datasets import DatasetSpec as JSpec
    from repro.data.datasets import synthetic_requests as jrequests
    from repro.serving.scheduler import serve_dataset as jserve
    from repro_torch.data.datasets import DatasetSpec, synthetic_requests
    from repro_torch.serving.scheduler import serve_dataset

    jcfg, cfg, jp, tp, _ = _setup("mixtral-8x7b")
    reqs = synthetic_requests(DatasetSpec("tiny", 4, 8, 4), cfg.vocab_size)
    jreqs = jrequests(JSpec("tiny", 4, 8, 4), jcfg.vocab_size)
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(reqs, jreqs))
    kw = dict(B=4, b_a=2, b_e=8, omega=0.0)
    ref = serve_dataset(cfg, tp, reqs, Plan(**kw), 4, scheduler=scheduler, device="cpu")
    assert ref.htod_gb == 0.0
    rep = serve_dataset(cfg, tp, reqs, Plan(**kw), 4, scheduler=scheduler,
                        stream_weights=True, resident_bytes=0.0, device="cpu")
    jrep = jserve(jcfg, jp, jreqs, JPlan(**kw), 4, scheduler=scheduler,
                  stream_weights=True, resident_bytes=0.0)
    assert rep.htod_gb > 0.0 and rep.prefetch_wait_s == 0.0
    assert rep.weight_htod_bytes == jrep.weight_htod_bytes
    for a, b, c in zip(ref.request_results, rep.request_results, jrep.request_results):
        assert np.array_equal(a.tokens, b.tokens) and np.array_equal(b.tokens, c.tokens)
