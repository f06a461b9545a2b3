"""Port engine vs ``repro.core.engine.ModuleBatchingEngine`` on the CPU, in
f32, with the same Plan and the JAX init's weights."""
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
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402

B, S, DEC = 6, 16, 6
REL = 1e-4          # logits bound of tests/test_engine.py:47-54


def _setup(arch):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_engine_logits_match_reference_engine(arch):
    jcfg, cfg, jp, tp, toks = _setup(arch)
    kw = dict(B=B, b_a=2, b_e=B, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu")
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
    je.sync_stats()
    te.sync_stats()
    assert te.stats.expert_launches == je.stats.expert_launches
    assert te.stats.attn_microbatches == je.stats.attn_microbatches
    assert te.stats.expert_tokens == je.stats.expert_tokens


@pytest.mark.parametrize("arch,b_e", [("olmoe-1b-7b", 2), ("mixtral-8x7b", 3),
                                      ("jamba-1.5-large-398b", 2)])
def test_engine_ragged_generate_tokens_and_counters_match(arch, b_e):
    """Ragged lengths, a capacity that drops copies: tokens, per-layer drops
    and the per-expert load histogram equal the JAX engine's exactly."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    lens = np.array([16, 11, 7, 16, 9, 3])
    kw = dict(B=B, b_a=4, b_e=b_e, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu")
    a = np.asarray(je.generate(jnp.asarray(toks), DEC, lengths=lens))
    b = te.generate(toks, DEC, lengths=lens).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(te.stats.expert_tokens_dropped_by_layer,
                          je.stats.expert_tokens_dropped_by_layer)
    assert np.array_equal(te.stats.expert_load, je.stats.expert_load)
    assert te.stats.expert_tokens_dropped == je.stats.expert_tokens_dropped
    assert te.stats.expert_tokens_dropped > 0         # the capacity did bite


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_engine_long_ragged_prompts_match_reference_engine(arch):
    """Prompts of 1024..1280 tokens (past the naive limit), ragged, then 3
    decode steps at a capacity that drops: tokens, per-layer drops and the
    per-expert load histogram equal the JAX engine's exactly."""
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    n, S_long, dec = 4, 1280, 4
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (n, S_long)).astype(np.int32)
    lens = np.array([1280, 1024, 1187, 1093])
    kw = dict(B=n, b_a=2, b_e=2, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S_long + dec)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S_long + dec, device="cpu")
    a = np.asarray(je.generate(jnp.asarray(toks), dec, lengths=lens))
    b = te.generate(toks, dec, lengths=lens).numpy()
    assert np.array_equal(a, b)
    assert np.array_equal(te.stats.expert_tokens_dropped_by_layer,
                          je.stats.expert_tokens_dropped_by_layer)
    assert np.array_equal(te.stats.expert_load, je.stats.expert_load)
    assert te.stats.expert_tokens_dropped == je.stats.expert_tokens_dropped
    assert te.stats.expert_tokens_dropped > 0         # the capacity did bite


def test_engine_prefill_routes_only_live_positions(monkeypatch):
    """A ragged prefill routes only the positions below each row's length:
    every MoE layer of each micro-batch dispatches sum(lengths) tokens, and
    the capacity probe sees no padded token."""
    from repro_torch.models import moe as tmoe

    _, cfg, _, tp, toks = _setup("olmoe-1b-7b")
    lens = np.array([16, 3, 5, 16, 1, 9])
    routed = []
    dispatch = tmoe.grouped_dispatch

    def spy(cfg_, xt, *a, **kw):
        routed.append(xt.shape[0])
        return dispatch(cfg_, xt, *a, **kw)

    monkeypatch.setattr(tmoe, "grouped_dispatch", spy)
    te = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=4, b_e=B, omega=0.0),
                              max_seq=S + DEC, device="cpu")
    te.prefill(toks, lengths=lens)
    per_layer = [int(lens[:4].sum()), int(lens[4:].sum())]
    assert routed == per_layer * cfg.num_layers
    routed.clear()
    te.prefill(toks)                                  # no lengths: every position
    assert routed == [4 * S, 2 * S] * cfg.num_layers


def test_ragged_batch_matches_each_sequence_alone():
    jcfg, cfg, jp, tp, toks = _setup("olmoe-1b-7b")
    lens = [16, 9, 5]
    plan = Plan(B=3, b_a=3, b_e=3, omega=0.0)
    te = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu")
    batch = te.generate(toks[:3], DEC, lengths=np.array(lens)).numpy()
    for i, n in enumerate(lens):
        alone = ModuleBatchingEngine(cfg, tp, Plan(B=1, b_a=1, b_e=1, omega=0.0),
                                     max_seq=S + DEC, device="cpu")
        assert np.array_equal(alone.generate(toks[i:i + 1, :n], DEC).numpy()[0],
                              batch[i])


def test_cache_tensors_are_written_in_place():
    """The engine owns preallocated KV buffers: prefill-slot insertion,
    decode ticks and evictions never reallocate them."""
    _, cfg, _, tp, toks = _setup("mixtral-8x7b")
    te = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                              max_seq=S + DEC, device="cpu")
    te.init_cache(B)
    ptrs = [(c["k"].data_ptr(), c["v"].data_ptr()) for c in te.cache]
    lg = te.prefill_slots(toks, np.arange(B))
    nxt = lg.argmax(-1)
    for t in range(3):
        nxt = te.decode_step(nxt, S + t).argmax(-1)
    te.evict_slots([1, 4])
    te.prefill_slots(toks[:2, :8], [1, 4])
    assert [(c["k"].data_ptr(), c["v"].data_ptr()) for c in te.cache] == ptrs
    assert torch.count_nonzero(te.cache[0]["k"][1, 8:]) == 0   # row overwritten
    # the hybrid's SSM state (h, conv) and KV buffers, the same way
    _, cfg, _, tp, toks = _setup("jamba-1.5-large-398b")
    te = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                              max_seq=S + DEC, device="cpu")
    te.init_cache(B)
    ptrs = [tuple(t.data_ptr() for t in c.values()) for c in te.cache]
    assert {tuple(c) for c in te.cache} == {("h", "conv"), ("k", "v")}
    nxt = te.prefill_slots(toks, np.arange(B)).argmax(-1)
    for t in range(3):
        nxt = te.decode_step(nxt, S + t).argmax(-1)
    te.evict_slots([1, 4])
    assert torch.count_nonzero(te.cache[0]["h"][[1, 4]]) == 0      # evicted rows
    te.prefill_slots(toks[:2, :8], [1, 4])
    assert torch.count_nonzero(te.cache[0]["h"][1]) > 0            # re-prefilled
    assert [tuple(t.data_ptr() for t in c.values()) for c in te.cache] == ptrs


def test_default_device_is_cuda_and_never_falls_back():
    _, cfg, _, tp, _ = _setup("olmoe-1b-7b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        ModuleBatchingEngine(cfg, tp, Plan(B=2, b_a=2, b_e=2))


def test_later_slices_raise():
    """The loop expert path, once a later slice, constructs and runs on the
    CPU: per module (never fused), one expert launch per non-empty chunk;
    an unknown path is refused."""
    _, cfg, _, tp, toks = _setup("olmoe-1b-7b")
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=2, b_a=2, b_e=2), max_seq=S + 3,
                               expert_path="loop", device="cpu")
    assert eng.expert_path == "loop" and not eng.fused_eligible()
    out = eng.generate(toks[:2], 3)
    assert out.shape == (2, 3) and eng.stats.fused_dispatches == 0
    assert eng.stats.expert_launches > 0 and eng.stats.expert_tokens > 0
    with pytest.raises(AssertionError):
        ModuleBatchingEngine(cfg, tp, Plan(B=2, b_a=2, b_e=2), expert_path="dense",
                             device="cpu")
