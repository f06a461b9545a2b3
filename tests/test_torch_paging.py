"""The paged, host-tiered KV cache in the port against the JAX package on
the CPU, in f32: the page table (frames, free lists, tiers, counters), paged
generation against contiguous generation in Mode A and Mode B at omega 0
and 0.5, the server serving KV beyond its device budget, and K3p's plain
version against K3's on the gathered copy."""
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
from repro.serving.scheduler import Request as JRequest  # noqa: E402
from repro.serving.scheduler import serve_dataset as jserve  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.serving.cache import CacheConfig, KVPageTable, PageAllocOOM  # noqa: E402
from repro_torch.serving.scheduler import Request, serve_dataset  # noqa: E402
from repro_torch.serving.server import ServeConfig  # noqa: E402

B, S, DEC = 4, 12, 6


def _setup(arch="mixtral-8x7b"):
    jcfg = replace(jget(arch, smoke=True), dtype="float32")
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jp, tp, toks


def _schema(cfg):
    return [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]


def _tables(budget_frames=None, page_tokens=4):
    """The port's and the JAX package's tables on the same config, with a
    device budget of ``budget_frames`` frames (None: all), ``"half"`` or
    ``"none"`` (a 1-byte budget: every frame on the host)."""
    jcfg, cfg, _, _, _ = _setup()
    probe = KVPageTable(cfg, _schema(cfg), B, S + DEC, CacheConfig(page_tokens=page_tokens),
                        device="cpu")
    budget = {None: None, "half": (probe.total_frames // 2) * probe.frame_bytes,
              "none": 1.0}[budget_frames]
    t = KVPageTable(cfg, _schema(cfg), B, S + DEC,
                    CacheConfig(page_tokens=page_tokens, device_pool_bytes=budget), device="cpu")
    j = jcache.KVPageTable(jcfg, _schema(jcfg), B, S + DEC,
                           jcache.CacheConfig(page_tokens=page_tokens,
                                              device_pool_bytes=budget))
    return cfg, t, j


def test_cache_config_validation():
    assert not CacheConfig().enabled
    assert CacheConfig(page_tokens=8).enabled
    with pytest.raises(AssertionError):
        CacheConfig(page_tokens=-1)
    # the reference's rule: a prefix cache needs paging
    assert CacheConfig(page_tokens=8, prefix_cache=True).prefix_cache
    with pytest.raises(AssertionError, match="paging"):
        CacheConfig(prefix_cache=True)


@pytest.mark.parametrize("budget", [None, "half", "none"])
def test_page_table_frames_match_jax_table(budget):
    """The same calls give the same frames, free lists, frame encoding and
    write targets as the JAX table (``slot_targets`` against its
    ``write_targets``): allocation with host-preferring rows, spills across
    tiers, freeing, re-allocation."""
    _, t, j = _tables(budget)
    assert (t.device_frames, t.host_frames, t.total_frames, t.frame_bytes, t.span,
            t.pages_per_seq) == (j.device_frames, j.host_frames, j.total_frames,
                                 j.frame_bytes, j.span, j.pages_per_seq)
    assert t.fully_resident == j.fully_resident == (budget is None)
    assert np.array_equal(t.gather_indices([0, 1]), j.gather_indices([0, 1]))
    calls = [("ensure", [0, 1], [False, True]), ("ensure", [0], [True]),
             ("ensure", [2, 3], [True, True]), ("free", [1, 2], None),
             ("ensure", [2], [False]), ("ensure", [1], [True]), ("free", [0], None),
             ("ensure", [0], [False])]
    for op, rows, pref in calls:
        for table in (t, j):
            if op == "ensure":
                table.ensure_rows(rows, prefer_host=pref)
            else:
                table.free_rows(rows)
        assert np.array_equal(t.page_map, j.page_map), (op, rows)
        assert t._free_dev == j._free_dev and t._free_host == j._free_host
        live = [r for r in range(B) if t.page_map[r, 0] >= 0]
        assert np.array_equal(t.gather_indices(range(B)), j.gather_indices(range(B)))
        slot = (np.arange(len(live)) * 3) % t.span
        wpage, off, pt = slot // t.page_tokens, slot % t.page_tokens, t.page_tokens
        tg = t.slot_targets(live, slot)
        wframe, host_writes = j.write_targets(live, wpage)
        on_pool = np.flatnonzero(wframe < j.device_frames)
        assert np.array_equal(tg.pool_i, on_pool)
        assert np.array_equal(tg.pool_flat, wframe[on_pool] * pt + off[on_pool])
        assert tg.host_i.tolist() == [i for i, _ in host_writes]
        assert tg.host_flat.tolist() == [h * pt + int(off[i]) for i, h in host_writes]
    if budget == "none":                      # everything spilled to the host
        assert (t.page_map >= t.device_frames).all()


def test_page_table_exhaustion_raises_and_rolls_back():
    """Out of frames in both tiers: ``PageAllocOOM``, and the row's frames
    taken so far go back to the free lists."""
    _, t, _ = _tables("half")
    t.ensure_rows([0, 1], prefer_host=[True, True])   # the host tier's frames
    t._free_host.clear()
    del t._free_dev[1:]                        # one frame left: not a row's worth
    with pytest.raises(PageAllocOOM):
        t.ensure_rows([3])
    assert (t.page_map[3] == -1).all() and len(t._free_dev) == 1


def test_mode_a_table_is_bookkeeping_only():
    _, t, j = _tables(None, page_tokens=8)
    assert t.fully_resident and not t.pool_k and not t.host_k
    t.ensure_rows([0, 1])
    t.insert_rows(0, torch.ones(2, t.span, 1, 1), torch.ones(2, t.span, 1, 1), [0, 1])
    t.prefetch(1)
    assert t.take_counters() == j.take_counters() == (0, 0, 0.0)


@pytest.mark.parametrize("budget", ["half", "none"])
def test_page_table_content_and_counters_match_jax_table(budget):
    """Mode B content: admission, decode-slot writes to the host tier, row
    reads, prefetch and acquire (a stale prefetch is copied again and
    counted as a demand fetch) give the JAX table's values and its htod and
    dtoh byte counts."""
    cfg, t, j = _tables(budget)
    rng = np.random.default_rng(5)
    K, hd = cfg.num_kv_heads, cfg.head_dim
    li, li2 = t.attn_layers[0], t.attn_layers[1]
    for table in (t, j):
        table.ensure_rows([0, 1, 2], prefer_host=[True, False, False])
    nk = rng.standard_normal((3, t.span, K, hd)).astype(np.float32)
    nv = rng.standard_normal((3, t.span, K, hd)).astype(np.float32)
    for layer in (li, li2):
        t.insert_rows(layer, torch.from_numpy(nk), torch.from_numpy(nv), [0, 1, 2])
        j.insert_rows(layer, jnp.asarray(nk), jnp.asarray(nv), [0, 1, 2])
    t.prefetch(li2)
    j.prefetch(li2)
    host_f = [int(f) - t.device_frames for f in t.page_map[0] if f >= t.device_frames]
    kn = rng.standard_normal((K, hd)).astype(np.float32)
    t.write_host_slots(li2, [host_f[0] * t.page_tokens + 1], torch.from_numpy(kn[None]),
                       torch.from_numpy(-kn[None]))
    j.write_host_slot(li2, host_f[0], 1, kn, -kn)            # stales the prefetch
    for layer in (li, li2):
        tk, tv = t.acquire(layer)
        jk, jv = j.acquire(layer)
        assert np.array_equal(tk.numpy(), np.asarray(jk))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        for row in (0, 1, 2):
            rk, rv = t.read_rows(layer, [row], t.span)
            jk, jv = j.read_row(layer, row, j.span)
            assert np.array_equal(rk[0].numpy(), jk) and np.array_equal(rv[0].numpy(), jv)
    assert t.demand_fetches == j._window.demand == 2
    assert t._window.issued == j._window.issued == 1
    ht, dt, _ = t.take_counters()
    hj, dj, _ = j.take_counters()
    assert (ht, dt) == (hj, dj) and ht > 0 and dt > 0


def _generate(cfg, params, toks, omega=0.0, cache_config=None, engine=ModuleBatchingEngine,
              **kw):
    plan_cls = Plan if engine is ModuleBatchingEngine else JPlan
    if engine is ModuleBatchingEngine:
        kw["device"] = "cpu"
    eng = engine(cfg, params, plan_cls(B=B, b_a=2, b_e=B, omega=omega), max_seq=S + DEC,
                 cache_config=cache_config, **kw)
    out = eng.generate(toks if engine is ModuleBatchingEngine else jnp.asarray(toks), DEC)
    return np.asarray(out), eng


@pytest.mark.parametrize("mode", ["A", "B-host", "B-half"])
@pytest.mark.parametrize("omega", [0.0, 0.5])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-1.8b"])
def test_paged_generate_matches_contiguous(arch, omega, mode):
    """Paged generate equals contiguous generate token for token (and the
    JAX paged engine's tokens and KV byte counts): Mode A keeps the fused
    path and copies nothing; Mode B with every frame on the host, and with
    half the frames on the device, copies frames both ways.  h2o-danube is
    the sliding-window ring."""
    jcfg, cfg, jp, tp, toks = _setup(arch)
    probe = KVPageTable(cfg, _schema(cfg), B, S + DEC, CacheConfig(page_tokens=4),
                        device="cpu")
    budget = {"A": None, "B-host": 1.0,
              "B-half": (probe.total_frames // 2) * probe.frame_bytes}[mode]
    pt = 8 if mode == "B-host" else 4
    want, ref_eng = _generate(cfg, tp, toks, omega)
    got, eng = _generate(cfg, tp, toks, omega, CacheConfig(page_tokens=pt,
                                                            device_pool_bytes=budget))
    jgot, jeng = _generate(jcfg, jp, toks, omega,
                           jcache.CacheConfig(page_tokens=pt, device_pool_bytes=budget),
                           engine=JEngine)
    assert np.array_equal(want, got)
    assert np.array_equal(jgot, got)
    assert eng.stats.kv_dtoh_bytes == jeng.stats.kv_dtoh_bytes
    if omega == 0.0:
        assert eng.stats.kv_htod_bytes == jeng.stats.kv_htod_bytes
    assert eng.stats.host_attn_tokens == ref_eng.stats.host_attn_tokens == \
        jeng.stats.host_attn_tokens
    if mode == "A":
        assert eng.pages.fully_resident and eng.fused_eligible() == ref_eng.fused_eligible()
        assert eng.stats.kv_htod_bytes == eng.stats.kv_dtoh_bytes == 0
        assert eng.stats.fused_dispatches == ref_eng.stats.fused_dispatches > 0
    else:
        assert not eng.pages.fully_resident and eng.stats.kv_dtoh_bytes > 0
        # each layer's host frames cross once a tick: the first tick's first
        # layer on demand, every other one prefetched (the last tick's
        # prefetch of layer 0 is issued too), none made stale by the host
        # rows' writes (the JAX engine copies a layer twice at omega > 0)
        pages, ticks = eng.pages, DEC - 1
        n_attn = len(pages.attn_layers)
        assert pages.demand_fetches == 1
        assert eng.stats.kv_htod_bytes == (n_attn * ticks + 1) * pages.host_pool_bytes() // n_attn
        if mode == "B-half":
            assert 0 < eng.pages.device_frames < eng.pages.total_frames


def test_mode_b_keeps_kv_only_in_the_pools_and_decodes_per_module():
    _, cfg, _, tp, toks = _setup()
    _, eng = _generate(cfg, tp, toks, 0.0, CacheConfig(page_tokens=8, device_pool_bytes=1.0))
    assert not eng.fused_eligible()
    assert eng.stats.fused_dispatches == 0
    attn = [li for li, (kind, _) in enumerate(eng.schema) if kind == "attn"]
    assert all(eng.cache[li] == {} for li in attn)
    eng.evict_slots([1])                                # frees frames, no buffer
    assert (eng.pages.page_map[1] == -1).all()


def test_paged_engine_generates_twice_with_fresh_frames():
    """A second generate on one Mode B engine resets the table in place and
    gives the same tokens."""
    _, cfg, _, tp, toks = _setup()
    eng = ModuleBatchingEngine(cfg, tp, Plan(B=B, b_a=2, b_e=B), max_seq=S + DEC,
                               device="cpu",
                               cache_config=CacheConfig(page_tokens=4, device_pool_bytes=1.0))
    a = eng.generate(toks, DEC).numpy()
    pools = {li: t.data_ptr() for li, t in eng.pages.pool_k.items()}
    b = eng.generate(toks, DEC).numpy()
    assert np.array_equal(a, b)
    assert {li: t.data_ptr() for li, t in eng.pages.pool_k.items()} == pools


def _requests(cfg, lens, cls):
    rng = np.random.default_rng(3)
    return [cls(prompt=rng.integers(5, cfg.vocab_size - 5, size=n).astype(np.int32),
                decode_len=DEC) for n in lens]


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_kv_exceeding_device_budget_serves_from_host(scheduler):
    """The server serves KV its device budget cannot hold from the host
    tier (tests/test_cache.py:191-206): the contiguous tokens and the JAX
    paged server's, with host-to-device KV traffic."""
    jcfg, cfg, jp, tp, _ = _setup()
    lens = [8, 6, 9, 7]
    plan = Plan(B=2, b_a=2, b_e=16, omega=0.0)
    want = serve_dataset(cfg, tp, _requests(cfg, lens, Request), plan, DEC,
                         scheduler=scheduler, max_seq=S + DEC, device="cpu")
    got = serve_dataset(cfg, tp, _requests(cfg, lens, Request), plan, DEC,
                        scheduler=scheduler, max_seq=S + DEC, kv_page_tokens=8,
                        device_kv_gb=1e-9, device="cpu")
    jgot = jserve(jcfg, jp, _requests(jcfg, lens, JRequest),
                  JPlan(B=2, b_a=2, b_e=16, omega=0.0), DEC, scheduler=scheduler,
                  max_seq=S + DEC, kv_page_tokens=8, device_kv_gb=1e-9)
    for a, b, c in zip(want.request_results, got.request_results, jgot.request_results):
        assert np.array_equal(a.tokens, b.tokens) and np.array_equal(b.tokens, c.tokens)
    assert got.kv_htod_gb > 0.0 and got.kv_dtoh_bytes > 0
    assert got.kv_htod_bytes == jgot.kv_htod_bytes


def test_server_page_rounds_the_admission_charge():
    """With an Eq. 2 budget the continuous server charges the page-rounded
    KV extent of a request."""
    from repro_torch.core import workload as W
    from repro_torch.core.hardware import A5000_C2
    from repro_torch.serving.server import Server

    _, cfg, _, tp, _ = _setup()
    server = Server(cfg, tp, Plan(B=2, b_a=2, b_e=16),
                    serve=ServeConfig(scheduler="continuous", hw=A5000_C2, kv_page_tokens=8,
                                      max_seq=S + DEC), device="cpu")
    server.submit(Request(np.zeros(5, np.int32), 4))
    assert server._kv_need[0] == W.kv_bytes_per_seq(cfg, 9, page_tokens=8) > \
        W.kv_bytes_per_seq(cfg, 9)


@pytest.mark.parametrize("pt,window", [(4, False), (8, False), (8, True), (5, False)])
def test_paged_ref_equals_ref_on_the_gathered_copy(pt, window):
    """K3p's plain version is K3's plain version on the gathered copy, bit
    for bit: pages from the pool and from the window in any order, a ring
    (every slot valid) and a dead row reading the null frame."""
    g = torch.Generator().manual_seed(pt)
    n, H, K, hd, span = 4, 8, 2, 32, 30
    pages = -(-span // pt)
    P, Hf = 5, n * pages - 5
    pk = torch.randn((P + 1, pt, K, hd), generator=g)
    pv = torch.randn((P + 1, pt, K, hd), generator=g)
    ek = torch.randn((Hf, pt, K, hd), generator=g)
    ev = torch.randn((Hf, pt, K, hd), generator=g)
    ids = torch.randperm(n * pages, generator=g)
    frames = torch.where(ids < P, ids, ids + 1).reshape(n, pages).to(torch.int32)
    frames[3] = P                                        # a dead row: the null frame
    pos = torch.tensor([span + 7, 3, span - 1, 0] if window else [span - 1, 3, 17, 0])
    q = torch.randn((n, H, hd), generator=g)
    got = ops.decode_attention_paged(q, pk, pv, ek, ev, frames, pos, span)
    gk, gv = ref.gather_pages(pk, ek, frames, span), ref.gather_pages(pv, ev, frames, span)
    assert gk.shape == (n, span, K, hd)
    assert torch.equal(got, ref.decode_attention_ref(q, gk, gv, pos))
    assert torch.equal(gk[1, pt:2 * pt], torch.cat([pk, ek])[frames[1, 1].item()])
