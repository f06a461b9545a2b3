"""The engine's reference oracles in the port against the JAX package's, on
the CPU in f32 with the JAX init's weights: the ``loop`` expert path, the
exact (``grouped_prefill=False``) prefill, ``greedy_generate``, the
baselines' cost models, the byte tokenizer and the modality frontends."""
import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import hardware as jhw  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.core.engine import ModuleBatchingEngine as JEngine  # noqa: E402
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.frontends import frontend_embeddings as jfrontend  # noqa: E402
from repro.serving.generate import greedy_generate as jgreedy  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.bridge import from_numpy_params, to_tensor  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core import hardware  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.frontends import frontend_embeddings, frontend_spec  # noqa: E402
from repro_torch.serving.generate import greedy_generate  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

B, S, DEC = 6, 16, 6
REL = 1e-4          # logits bound of tests/test_engine.py:47-54


def _setup(arch):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _rel(got, want, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()) / scale


# ---------------------------------------------------------------------------
# The loop expert path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_loop_engine_matches_reference_loop_engine(arch):
    """Logits within 1e-4 relative at prefill and 2 decode steps, then
    generate: equal tokens, expert launches and routed tokens, at a b_e
    that splits experts into several chunks."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    kw = dict(B=B, b_a=2, b_e=2, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC, expert_path="loop")
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu",
                              expert_path="loop")
    assert not te.fused_eligible()
    lj = np.asarray(je.prefill(jnp.asarray(toks)))
    scale = float(np.abs(lj).max())
    assert _rel(te.prefill(toks).numpy(), lj, scale) < REL
    nxt = lj.argmax(-1)
    for t in range(2):
        lj = np.asarray(je.decode_step(jnp.asarray(nxt), S + t))
        lt = te.decode_step(nxt, S + t).numpy()
        assert _rel(lt, lj, scale) < REL
        assert np.array_equal(lt.argmax(-1), lj.argmax(-1))
        nxt = lj.argmax(-1)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC, expert_path="loop")
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu",
                              expert_path="loop")
    a = np.asarray(je.generate(jnp.asarray(toks), DEC))
    assert np.array_equal(te.generate(toks, DEC).numpy(), a)
    assert te.stats.expert_launches == je.stats.expert_launches
    assert te.stats.expert_tokens == je.stats.expert_tokens
    n_moe = sum(1 for _, f in te.schema if f == "moe")
    assert te.stats.expert_tokens == n_moe * (DEC - 1) * B * cfg.experts_per_token
    assert te.stats.fused_dispatches == 0 and not te.graph_captures


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_grouped_matches_loop_token_for_token(arch):
    """tests/test_grouped_dispatch.py's bar in the port: the grouped engine
    and the loop oracle at b_e = B (no drops) give the same tokens; the
    grouped engine makes one expert launch per MoE layer and decode tick,
    the loop at least as many."""
    _, cfg, _, tp, toks = _setup(arch)
    plan = Plan(B=B, b_a=2, b_e=B, omega=0.0)
    eng_g = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu")
    eng_l = ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu",
                                 expert_path="loop")
    out_g = eng_g.generate(toks, DEC).numpy()
    out_l = eng_l.generate(toks, DEC).numpy()
    assert np.array_equal(out_g, out_l), float(np.mean(out_g == out_l))
    assert eng_g.stats.expert_tokens_dropped == 0
    n_moe = sum(1 for _, f in eng_g.schema if f == "moe")
    assert eng_g.stats.expert_launches == n_moe * (DEC - 1)
    assert eng_l.stats.expert_launches >= eng_g.stats.expert_launches


def test_loop_reads_routing_once_per_layer_and_tick_under_strict_sanitizer():
    """The loop stage's one host read a MoE layer and tick is a planned
    ``expert-loop-oracle`` read: the strict sanitizer passes and counts it."""
    _, cfg, _, tp, toks = _setup("olmoe-1b-7b")
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                               max_seq=S + DEC, device="cpu", expert_path="loop")
    with analysis.sanitize(strict=True) as san:
        eng.generate(toks, DEC)
    n_moe = sum(1 for _, f in eng.schema if f == "moe")
    assert san.report()["planned_transfers"]["expert-loop-oracle"] == n_moe * (DEC - 1)
    assert eng.stats.planned_reads == n_moe * (DEC - 1)


# ---------------------------------------------------------------------------
# The exact prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_exact_prefill_matches_reference_with_no_probe(arch):
    """``grouped_prefill=False``: the dense-combine prefill, within 1e-4 of
    the JAX engine's and with no capacity probe; the grouped prefill makes
    one probe per MoE layer and micro-batch."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    kw = dict(B=B, b_a=2, b_e=B, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**kw), max_seq=S + DEC, grouped_prefill=False)
    te = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu",
                              grouped_prefill=False)
    lj = np.asarray(je.prefill(jnp.asarray(toks)))
    with analysis.sanitize(strict=True) as san:
        lt = te.prefill(toks).numpy()
    assert _rel(lt, lj) < REL
    assert "prefill-capacity-probe" not in san.report()["planned_transfers"]
    tg = ModuleBatchingEngine(cfg, tp, Plan(**kw), max_seq=S + DEC, device="cpu")
    with analysis.sanitize(strict=True) as san:
        lg = tg.prefill(toks).numpy()
    n_moe = sum(1 for _, f in te.schema if f == "moe")
    assert san.report()["planned_transfers"]["prefill-capacity-probe"] == n_moe * 3
    assert _rel(lg, lt) < REL
    nxt = lj.argmax(-1)
    assert np.array_equal(te.decode_step(nxt, S).numpy().argmax(-1),
                          np.asarray(je.decode_step(jnp.asarray(nxt), S)).argmax(-1))


def test_loop_exact_prefill_server_matches_reference_server():
    """A ``Server`` on both oracles (``expert_path='loop'``,
    ``grouped_prefill=False``) gives the JAX ``Server``'s tokens (the
    continuous scheduler: admissions into freed slots)."""
    jcfg, cfg, jp, tp, _ = _setup("olmoe-1b-7b")
    rng = np.random.default_rng(7)
    lens, decs = [12, 5, 9, 3, 7], [4, 6, 3, 5, 4]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    kw = dict(B=3, b_a=2, b_e=3, omega=0.0)
    for sched in ("continuous",):
        sk = dict(scheduler=sched, decode_len=4, expert_path="loop", grouped_prefill=False)
        js = JServer(jcfg, jp, JPlan(**kw), serve=JServeConfig(**sk))
        ts = Server(cfg, tp, Plan(**kw), serve=ServeConfig(**sk), device="cpu")
        for p, d in zip(prompts, decs):
            js.submit(JRequest(p, d))
            ts.submit(Request(p, d))
        jrep, trep = js.run(), ts.run()
        assert len(trep.request_results) == len(prompts)
        for a, b in zip(jrep.request_results, trep.request_results):
            assert a.index == b.index and np.array_equal(a.tokens, b.tokens)
        assert trep.decode_slot_steps == jrep.decode_slot_steps
        assert ts._engine.expert_path == "loop" and not ts._engine.grouped_prefill


def test_launcher_serves_the_loop_path():
    """``--expert-path loop`` reaches the engine: under the strict sanitizer
    the loop stage's reads are counted as ``expert-loop-oracle``."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--requests", "3",
                     "--prompt-lens", "5,9", "--decode-len", "4", "--batch", "3",
                     "--omega", "0", "--expert-path", "loop", "--sanitize", "strict"])
    text = out.getvalue()
    assert '"expert-loop-oracle"' in text and '"host_reads": []' in text


def test_serve_config_refuses_unknown_expert_path():
    with pytest.raises(AssertionError):
        ServeConfig(expert_path="dense")


# ---------------------------------------------------------------------------
# greedy_generate (model-based batching)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m"])
def test_greedy_generate_matches_reference(arch):
    """The model-based-batching order gives the JAX ``greedy_generate``'s
    tokens, and the module-batching engine's (the oracle relation of
    tests/test_engine.py)."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    S_ = 32 if arch.startswith("mamba") else S      # one whole SSM chunk
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)
    want = np.asarray(jgreedy(jcfg, jp, jnp.asarray(toks), DEC))
    got = greedy_generate(cfg, tp, torch.from_numpy(toks).long(), DEC).numpy()
    assert np.array_equal(got, want)
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B, omega=0.0),
                               max_seq=S_ + DEC, device="cpu")
    assert np.array_equal(eng.generate(toks, DEC).numpy(), got)


# ---------------------------------------------------------------------------
# Baselines, tokenizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
@pytest.mark.parametrize("system", baselines.SYSTEMS)
def test_baselines_match_reference(arch, system):
    """Every cost-model estimate of every baseline system equals the JAX
    package's, on the paper's profiles, full-size configs."""
    assert baselines.SYSTEMS == jbase.SYSTEMS
    cfg, jcfg = get_config(arch), jget(arch)
    names = sorted(set(hardware.PROFILES) & set(jhw.PROFILES))
    assert len(names) == 3                           # the paper's three testbeds
    for name in names:
        hw, jh = hardware.PROFILES[name], jhw.PROFILES[name]
        for ctx in (512, 2048):
            assert (baselines.model_based_batch_limit(cfg, hw, ctx)
                    == jbase.model_based_batch_limit(jcfg, jh, ctx))
            for got, want in ((baselines.estimate_baseline_decode(cfg, hw, ctx, system),
                               jbase.estimate_baseline_decode(jcfg, jh, ctx, system)),
                              (baselines.estimate_baseline_prefill(cfg, hw, ctx, system),
                               jbase.estimate_baseline_prefill(jcfg, jh, ctx, system))):
                assert got.throughput == want.throughput
                assert got.t_model == want.t_model
                assert got.tokens == want.tokens
                assert got.htod_bytes == want.htod_bytes
                assert got.dtoh_bytes == want.dtoh_bytes
                assert got.layer_times == want.layer_times


@pytest.mark.parametrize("text", ["", "hello, world", "grüße 🌍\n\t", "\x00\xff"])
def test_tokenizer_round_trips(text):
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    ids = tok.encode(text)
    assert ids.dtype == np.int32 and ids[0] == tok.BOS
    assert np.array_equal(ids, jtok.encode(text))
    assert tok.decode(ids.tolist()) == text
    assert np.array_equal(tok.encode(text, add_bos=False), ids[1:])
    assert tok.decode(ids.tolist() + [tok.EOS]) == jtok.decode(ids.tolist() + [tok.EOS])
    assert tok.vocab_size == jtok.vocab_size == 258


# ---------------------------------------------------------------------------
# Modality frontends
# ---------------------------------------------------------------------------
def test_frontend_embedding_shapes_and_determinism():
    for arch in ("musicgen-medium", "internvl2-76b"):
        cfg = get_config(arch, smoke=True)
        emb = frontend_embeddings(cfg, 3, device="cpu")
        assert emb.shape == (3, cfg.frontend_tokens, cfg.d_model)
        assert emb.dtype == torch.bfloat16
        spec = frontend_spec(cfg, 3)
        assert spec.shape == emb.shape and spec.dtype == emb.dtype
        assert spec.device.type == "meta"
        assert torch.equal(emb, frontend_embeddings(cfg, 3, device="cpu"))
        g = torch.Generator().manual_seed(5)
        assert not torch.equal(emb, frontend_embeddings(cfg, 3, g, device="cpu"))
        assert 0.01 < float(emb.float().std()) < 0.03
    cfg = get_config("qwen2-1.5b", smoke=True)
    assert frontend_embeddings(cfg, 2, device="cpu") is None
    assert frontend_spec(cfg, 2) is None


@pytest.mark.parametrize("arch", ["musicgen-medium", "internvl2-76b"])
def test_frontend_prefill_and_generate_match_reference(arch):
    """The JAX stub's array (through numpy) into both packages: the model's
    prefill logits and the engine's prefill and generate agree with the
    JAX ones, and the frontend positions' token ids do not matter."""
    jcfg, cfg, jp, tp, _ = _setup(arch)
    Bf, Sf = 4, 24
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (Bf, Sf)).astype(np.int32)
    jfe = jfrontend(jcfg, Bf)
    fe = to_tensor(np.asarray(jfe))
    lj, _ = JM.prefill(jcfg, jp, jnp.asarray(toks), jfe)
    lt, _ = M.prefill(cfg, tp, torch.from_numpy(toks).long(), fe)
    assert _rel(lt.numpy(), np.asarray(lj)) < REL
    plan = dict(B=Bf, b_a=2, b_e=16, omega=0.0)
    je = JEngine(jcfg, jp, JPlan(**plan), max_seq=Sf + DEC)
    te = ModuleBatchingEngine(cfg, tp, Plan(**plan), max_seq=Sf + DEC, device="cpu")
    assert _rel(te.prefill(toks, fe).numpy(),
                np.asarray(je.prefill(jnp.asarray(toks), jfe))) < REL
    want = np.asarray(je.generate(jnp.asarray(toks), DEC, frontend_emb=jfe))
    got = te.generate(toks, DEC, frontend_emb=fe).numpy()
    assert np.array_equal(got, want)
    # tokens under the frontend prefix do not matter; after it they do
    toks2 = toks.copy()
    toks2[:, :cfg.frontend_tokens] = 0
    same = te.generate(toks2, DEC, frontend_emb=fe).numpy()
    assert np.array_equal(same, got)
    base = M.forward(cfg, tp, torch.from_numpy(toks).long(), fe)[0]
    assert torch.equal(M.forward(cfg, tp, torch.from_numpy(toks2).long(), fe)[0], base)
    toks3 = toks.copy()
    toks3[:, -1] = (toks3[:, -1] + 1) % cfg.vocab_size
    diff = M.forward(cfg, tp, torch.from_numpy(toks3).long(), fe)[0]
    assert not torch.equal(diff[:, -1], base[:, -1])
