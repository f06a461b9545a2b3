"""The port's fused decode chunk on the CPU, in f32 (on a CPU engine the
tick body runs eagerly T times; on the card it is a CUDA graph, held to the
same tokens by tests/test_torch_cuda.py and chip_smoke.py).

Contracts, as tests/test_fused_decode.py pins them in the JAX package: the
fused chunk gives the per-module path's tokens (``fused_decode=False``, the
oracle), greedy and seeded, ragged and with dead rows, and the JAX package's
fused ``generate`` tokens on the same weights; a chunk is one dispatch; new
(B, path, T) keys are counted as retraces; ``decode_step_sampled`` rides the
fused chunk; the server gives the same tokens at any chunk length.
"""
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
from repro.serving.sampling import SamplingParams as JSamplingParams  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.serving.sampling import BatchSampler, SamplingParams  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

B, S, DEC, T = 4, 12, 9, 4       # two chunks of 4: one JAX compile per path
SAMPLED = (0.8, 5, 13)          # temperature, top-k, seed


def _setup(arch):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _engine(cfg, tp, fused, b_e=B, n=B, b_a=2):
    plan = Plan(B=n, b_a=b_a, b_e=b_e, omega=0.0, decode_chunk=T)
    return ModuleBatchingEngine(cfg, tp, plan, max_seq=S + DEC, device="cpu",
                                fused_decode=fused)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b", "mamba2-370m",
                                  "jamba-1.5-large-398b"])
def test_fused_matches_per_module_and_jax_fused(arch, sampled):
    """Fused chunks of T=4 against per-module ticks and the JAX package's
    fused generate (the same chunking), greedy and seeded top-k."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    sp = SamplingParams(*SAMPLED) if sampled else None
    ref = _engine(cfg, tp, fused=False).generate(toks, DEC, sampling=sp, chunk=1)
    eng = _engine(cfg, tp, fused=True)
    got = eng.generate(toks, DEC, sampling=sp)
    assert np.array_equal(got.numpy(), ref.numpy())
    assert eng.stats.fused_dispatches == -(-(DEC - 1) // T)
    assert eng.stats.fused_ticks == DEC - 1
    je = JEngine(jcfg, jp, JPlan(B=B, b_a=2, b_e=B, omega=0.0, decode_chunk=T),
                 max_seq=S + DEC)
    jsp = JSamplingParams(*SAMPLED) if sampled else None
    want = np.asarray(je.generate(jnp.asarray(toks), DEC, sampling=jsp))
    assert je.stats.fused_dispatches == eng.stats.fused_dispatches
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-1.5-large-398b"])
def test_fused_ragged_drops_and_counters_match(arch):
    """A ragged batch at a capacity that drops copies: tokens, per-layer
    drops, the load histogram and the launch accounting equal the
    per-module path's and the JAX fused engine's."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    lens = np.array([12, 7, 4, 10])
    ref = _engine(cfg, tp, fused=False, b_e=2)
    r = ref.generate(toks, DEC, lengths=lens, chunk=1).numpy()
    eng = _engine(cfg, tp, fused=True, b_e=2)
    g = eng.generate(toks, DEC, lengths=lens).numpy()
    je = JEngine(jcfg, jp, JPlan(B=B, b_a=2, b_e=2, omega=0.0, decode_chunk=T),
                 max_seq=S + DEC)
    want = np.asarray(je.generate(jnp.asarray(toks), DEC, lengths=lens))
    assert np.array_equal(g, r) and np.array_equal(g, want)
    for st in (ref.stats, je.stats):
        assert np.array_equal(eng.stats.expert_tokens_dropped_by_layer,
                              st.expert_tokens_dropped_by_layer)
        assert np.array_equal(eng.stats.expert_load, st.expert_load)
    assert eng.stats.expert_tokens_dropped > 0            # the capacity did bite
    assert eng.stats.expert_launches == ref.stats.expert_launches == je.stats.expert_launches
    assert eng.stats.device_attn_tokens == ref.stats.device_attn_tokens
    assert eng.stats.device_attn_tokens == je.stats.device_attn_tokens


def test_dead_rows_hold_their_stale_token_and_position():
    """``live`` False rows re-feed their token at their position every
    tick (so each of their columns is the same token), exactly as the
    per-module chunk does, while live rows advance."""
    _, cfg, _, tp, toks = _setup("mixtral-8x7b")
    live = np.array([True, False, True, False])
    outs = []
    for fused in (False, True):
        eng = _engine(cfg, tp, fused=fused)
        cur = eng.prefill(toks).argmax(-1)
        sampler = BatchSampler.uniform(B, None)
        pos = np.array([S, S - 3, S, S - 5])
        outs.append(eng.decode_chunk(cur, pos, sampler, 5, live=live).numpy())
        assert (eng.stats.fused_dispatches == 1) == fused
    assert np.array_equal(outs[0], outs[1])
    dead = outs[1][~live]
    assert (dead == dead[:, :1]).all()
    assert not (outs[1][live] == outs[1][live][:, :1]).all()


def test_retraces_count_keys_and_sampled_step_is_fused():
    """A repeated (B, path, T) chunk is not a new key; a new T is.  The
    single-tick sampled entry point takes the fused chunk and equals the
    per-module tick."""
    _, cfg, _, tp, toks = _setup("mixtral-8x7b")
    eng, ref = _engine(cfg, tp, fused=True, b_a=B), _engine(cfg, tp, fused=False, b_a=B)
    cur = eng.prefill(toks).argmax(-1)
    ref.prefill(toks)
    sampler = BatchSampler.uniform(B, None)
    eng.decode_chunk(cur, S, sampler, 4)
    eng.decode_chunk(cur, S, sampler, 4)
    assert eng.stats.decode_retraces == 1
    eng.decode_chunk(cur, S, sampler, 2)
    assert eng.stats.decode_retraces == 2
    eng.prefill(toks)
    d0 = eng.stats.fused_dispatches
    samplers = [BatchSampler(B), BatchSampler(B)]
    for s in samplers:
        for i, p in enumerate([None, SamplingParams(0.9, 0, 1), SamplingParams(0.7, 3, 2),
                               None]):
            s.set_slot(i, p)
    t_f = eng.decode_step_sampled(cur, S, samplers[0])
    t_r = ref.decode_step_sampled(cur, S, samplers[1])
    assert np.array_equal(t_f.numpy(), t_r.numpy())
    assert eng.stats.fused_dispatches == d0 + 1
    assert ref.stats.fused_dispatches == 0
    assert eng.stats.decode_retraces == 3               # a sampled key is new


def test_generate_twice_reuses_the_cache_in_place():
    """A second ``generate`` on one engine zeroes the same cache buffers
    (whose addresses a captured graph holds) and gives the same tokens."""
    _, cfg, _, tp, toks = _setup("jamba-1.5-large-398b")
    eng = _engine(cfg, tp, fused=True)
    a = eng.generate(toks, DEC).numpy()
    ptrs = [t.data_ptr() for layer in eng.cache for t in layer.values()]
    b = eng.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert [t.data_ptr() for layer in eng.cache for t in layer.values()] == ptrs


LENS = [12, 5, 9, 3, 7, 12, 4]
DECS = [4, 6, 3, 8, 4, 2, 7]
SAMPLING = [None, SamplingParams(0.8, 0, 4), None, SamplingParams(1.0, 3, 9), None,
            SamplingParams(0.6, 0, 2), SamplingParams(0.9, 2, 5)]


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_server_tokens_do_not_depend_on_the_chunk(scheduler):
    """The server at decode_chunk 1 and 8 gives every request the same
    tokens, and the JAX server's (mixed greedy and seeded slots, ragged
    prompts and decode lengths, 4 slots for 7 requests so the continuous
    scheduler recycles slots); chunks of 8 take fewer dispatches for the
    same ticks."""
    jcfg, cfg, jp, tp, _ = _setup("olmoe-1b-7b")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    plan = Plan(B=4, b_a=2, b_e=4, omega=0.0, decode_chunk=8)
    out, stats = {}, {}
    for chunk in (1, 8):
        server = Server(cfg, tp, plan, serve=ServeConfig(scheduler=scheduler,
                                                         decode_chunk=chunk), device="cpu")
        for p, d, sp in zip(prompts, DECS, SAMPLING):
            server.submit(Request(p, d, sampling=sp))
        out[chunk] = [r.tokens for r in server.run().request_results]
        stats[chunk] = server._engine.stats
    assert all(np.array_equal(a, b) for a, b in zip(out[1], out[8]))
    assert [len(t) for t in out[8]] == DECS
    assert stats[8].fused_ticks == stats[1].fused_ticks > 0
    assert stats[8].fused_dispatches < stats[1].fused_dispatches
    jserver = JServer(jcfg, jp, JPlan(B=4, b_a=2, b_e=4, omega=0.0, decode_chunk=8),
                      serve=JServeConfig(scheduler=scheduler))
    for p, d, sp in zip(prompts, DECS, SAMPLING):
        jsp = None if sp is None else JSamplingParams(sp.temperature, sp.top_k, sp.seed)
        jserver.submit(JRequest(p, d, sampling=jsp))
    want = [r.tokens for r in jserver.run().request_results]
    assert all(np.array_equal(a, b) for a, b in zip(out[8], want))


def test_launcher_plans_the_chunk_from_the_cadence():
    """``launch.serve.build_plan`` re-plans ``decode_chunk`` with
    ``planner.select_decode_chunk`` at the served batch, as the JAX CLI
    does: a static wave chunks up to its decode length, continuous
    admission of 64 requests decoding 32 tokens evicts every half tick."""
    import argparse

    from repro_torch.core.hardware import H100_SXM_80GB
    from repro_torch.launch.serve import build_plan

    cfg = get_config("olmoe-1b-7b")
    chunks = {}
    for sched in ("static", "continuous"):
        args = argparse.Namespace(prompt_lens=[64, 256], decode_len=32, scheduler=sched,
                                  batch=64, requests=64, b_e=64)
        chunks[sched] = build_plan(cfg, H100_SXM_80GB, args).decode_chunk
    assert chunks == {"static": 32, "continuous": 1}
