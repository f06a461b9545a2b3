"""Fault injection and recovery in the port (``repro_torch.faults`` and its
seams) against the JAX package's, on the CPU in f32.

The plan is a copy of the reference's, so both packages draw the same
decisions for the same seed.  Every recovery -- retried and re-fetched
copies, page-OOM degradation, preemption and resume -- gives the fault-free
tokens, and the port's armed server gives the JAX ``Server``'s tokens under
the same plan, with the same preemption and resume counts.  Fault-free
baselines run under ``faults.shielded()`` so an ambient ``REPRO_FAULTS``
plan cannot perturb them.
"""
import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.faults as jfaults  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.scheduler import serve_dataset as jserve_dataset  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro_torch import analysis, faults  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.serving.cache import CacheConfig, KVPageTable  # noqa: E402
from repro_torch.serving.scheduler import serve_dataset  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402
from repro_torch.serving.weights import StreamWindow  # noqa: E402

PACKAGES = {"jax": jfaults, "torch": faults}
_MODEL = {}


def _mixtral():
    """The reference tests' model: Mixtral smoke, f32, the JAX weights
    bridged into the port."""
    if not _MODEL:
        jcfg = replace(jget("mixtral-8x7b", smoke=True), dtype="float32")
        cfg = replace(get_config("mixtral-8x7b", smoke=True), dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp,
                      tp=from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _MODEL


def _prompts(vocab, n, length=8, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, vocab, length))) for _ in range(n)]


def _tokens(report):
    return [list(map(int, r.tokens)) for r in report.request_results]


# ---------------------------------------------------------------------------
# The plan: one API, the same draws in both packages
# ---------------------------------------------------------------------------
def _parse(f):
    spec = f.parse_spec("seed=3,transfer=0.2,stall=0.05,oom=0.1,preempt=7,kill=1@4")
    assert (spec.seed, spec.preempt_every, spec.kill_replica, spec.kill_after) == (3, 7, 1, 4)
    assert (spec.transfer_rate, spec.stall_rate, spec.oom_rate) == pytest.approx((0.2, 0.05, 0.1))
    for bad in ("seed=3,bogus=1", "preempt"):
        with pytest.raises(ValueError):
            f.parse_spec(bad)
    bare = f.parse_spec("kill=1")
    assert (bare.kill_replica, bare.kill_after) == (1, 1)


def _coerce(f):
    assert f.resolve(None) is None
    fp = f.resolve("seed=1,transfer=0.1")
    assert isinstance(fp, f.FaultPlan) and f.resolve(fp) is fp
    assert f.resolve(fp.spec).spec == fp.spec
    with pytest.raises(TypeError):
        f.resolve(3)


def _ledger(f):
    fp = f.resolve("seed=0,transfer=1.0")
    with f.armed(fp):
        f.note("recovered:test-event")
        f.note("recovered:test-event", 2)
    rep = fp.report()
    assert rep["spec"]["transfer_rate"] == 1.0
    assert rep["events"]["recovered:test-event"] == 3


def _shield(f):
    fp = f.resolve("seed=0,transfer=1.0")
    with f.armed(fp):
        assert f.current() is fp
        with f.shielded():
            assert f.current() is None
        assert f.current() is fp


def _never_twice(f):
    fp = f.FaultPlan(f.parse_spec("seed=0,transfer=1.0,oom=1.0"))
    assert [fp.transfer_fault("stream-window", 5) for _ in range(20)] == [True, False] * 10
    ooms = [fp.page_oom() for _ in range(10)]
    assert not any(a and b for a, b in zip(ooms, ooms[1:]))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("case", [_parse, _coerce, _ledger, _shield, _never_twice],
                         ids=lambda c: c.__name__.strip("_"))
def test_fault_plan_api(pkg, case):
    case(PACKAGES[pkg])


@pytest.mark.parametrize("spec", ["seed=11,transfer=0.5", "seed=7,transfer=0.05,stall=0.3,oom=0.4",
                                  "seed=12,transfer=0.5,preempt=3"])
def test_both_packages_draw_the_same_decisions(spec):
    """The same seed draws the same decision sequence at every site."""
    plans = [f.FaultPlan.parse(spec) for f in (jfaults, faults)]
    draws = []
    for fp in plans:
        seq = []
        for k in range(64):
            seq += [fp.transfer_fault("stream-window", k % 3),
                    fp.transfer_fault("expert-prefetch", (k, 1)),
                    fp.stall_fault("stream-window", k), fp.page_oom(), fp.preempt_due(k)]
        draws.append(seq)
    assert draws[0] == draws[1]
    assert plans[0].report() == plans[1].report()


def test_port_copies_the_reference_modules():
    """``faults/plan.py`` and ``analysis/markers.py`` are copies; the
    faults package's ``__init__`` differs only in its import line."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1] / "src"
    for rel in ("faults/plan.py", "analysis/markers.py"):
        assert (root / "repro" / rel).read_text() == (root / "repro_torch" / rel).read_text()
    ref = (root / "repro/faults/__init__.py").read_text()
    port = (root / "repro_torch/faults/__init__.py").read_text()
    assert port == ref.replace("from repro.faults.plan", "from repro_torch.faults.plan")


# ---------------------------------------------------------------------------
# StreamWindow: retry, stall, watchdog
# ---------------------------------------------------------------------------
def _window(retry=None, tag="stream-window", depth=2):
    """A CPU window whose fetch fills 4 floats with the key."""
    calls = []

    def fetch(key, slot):
        calls.append(key)
        out = slot.view(torch.float32)[:4]
        out.fill_(float(key if not isinstance(key, tuple) else key[1]))
        return out, 16

    win = StreamWindow(fetch, lambda key: 16, 16, torch.device("cpu"), depth=depth,
                       tag=tag, retry=retry)
    return win, calls


def test_stream_window_retries_transient_faults():
    """At rate 1.0 every first attempt fails and the first retry succeeds
    (never twice in a row); the failed attempt never reached the copy."""
    win, calls = _window()
    with faults.armed(faults.resolve("seed=0,transfer=1.0")):
        out = win.acquire(7)
    assert torch.equal(out, torch.full((4,), 7.0))
    assert (win.retries, win.copies, win.demand) == (1, 1, 1)
    assert calls == [7]


def test_stream_window_retry_exhaustion_raises():
    """With no retries the injected failure surfaces as the typed error:
    nothing is served around it."""
    win, calls = _window(retry=faults.RetryPolicy(max_retries=0))
    with faults.armed(faults.resolve("seed=0,transfer=1.0")):
        with pytest.raises(faults.TransientTransferError, match="stream-window"):
            win.acquire(7)
    assert calls == [] and win.copies == 0


def test_stream_window_stalled_prefetch_recovers_by_demand_fetch():
    """A stalled prefetch is abandoned at acquire and fetched again on
    demand: the value is right, the timeout counted, the bytes counted as
    the reference counts them (the re-fetch is a demand fetch)."""
    win, calls = _window(retry=faults.RetryPolicy(watchdog_s=0.01))
    with faults.armed(faults.resolve("seed=0,stall=1.0")):
        win.prefetch(3)
        out = win.acquire(3)
    assert torch.equal(out, torch.full((4,), 3.0))
    assert (win.timeouts, win.issued, win.demand, win.htod_bytes) == (1, 1, 1, 32)
    assert calls == [3, 3] and win.copies == 2


def test_stream_window_watchdog_recovers_an_overdue_copy():
    """A copy still not done past the watchdog (``Event.query``, never a
    host wait) is abandoned at acquire and fetched again; with no watchdog
    the same copy is simply waited for on the stream."""
    for watchdog, timeouts in ((0.001, 1), (None, 0)):
        win, calls = _window(retry=faults.RetryPolicy(watchdog_s=watchdog))
        win._landed = lambda e: False              # a copy that never finishes
        win.prefetch(5)
        win.inflight[5].issued_at -= 1.0           # queued a second ago
        out = win.acquire(5)
        assert torch.equal(out, torch.full((4,), 5.0))
        assert win.timeouts == timeouts and len(calls) == 1 + timeouts


def test_stream_window_watchdog_failed_recovery_names_tag_and_key():
    """When the recovery fetch also fails past its retries, the timeout
    surfaces as ``StreamTimeoutError`` naming the window's tag and key."""
    # a seed whose first draw at the site passes (the prefetch) and whose
    # second fails (the recovery fetch)
    seed = next(s for s in range(1000) if _draws(s) == [False, True])
    win, _ = _window(retry=faults.RetryPolicy(max_retries=0), tag="expert-prefetch")
    with faults.armed(faults.resolve(f"seed={seed},transfer=0.5,stall=1.0")):
        win.prefetch((2, 5))
        with pytest.raises(faults.StreamTimeoutError) as ei:
            win.acquire((2, 5))
    assert "expert-prefetch" in str(ei.value) and "(2, 5)" in str(ei.value)
    assert win.timeouts == 1


def _draws(seed):
    fp = faults.FaultPlan.parse(f"seed={seed},transfer=0.5")
    return [fp.transfer_fault("expert-prefetch", 0) for _ in range(2)]


def test_stream_window_unarmed_counters_stay_zero():
    win, _ = _window()
    with faults.shielded():
        win.prefetch(0)
        win.acquire(0)
        win.acquire(1)
    assert (win.retries, win.timeouts) == (0, 0)
    assert win.take_fault_counters() == (0, 0)


# ---------------------------------------------------------------------------
# Server.submit, the page table
# ---------------------------------------------------------------------------
def test_rejected_submit_leaves_server_untouched():
    m = _mixtral()
    cfg, tp = m["cfg"], m["tp"]
    plan = Plan(B=2, b_a=2, b_e=16, omega=0.0)
    prompts = _prompts(cfg.vocab_size, 2, 6)

    def mk():
        return Server(cfg, tp, plan, serve=ServeConfig(scheduler="continuous", decode_len=4,
                                                       max_seq=10), device="cpu")
    with faults.shielded():
        clean = mk()
        for p in prompts:
            clean.submit(Request(p, 4))
        want = _tokens(clean.run())
        srv = mk()
        with pytest.raises(ValueError):
            srv.submit(Request(list(range(1, 30)), 4))
        with pytest.raises(ValueError):
            srv.submit(Request(prompts[0], 4, arrival_s=float("nan")))
        assert (len(srv._handles), len(srv._pending), srv._kv_need) == (0, 0, {})
        handles = [srv.submit(Request(p, 4)) for p in prompts]
        assert [h.index for h in handles] == [0, 1]
        assert _tokens(srv.run()) == want


def test_page_table_oom_is_typed_and_transactional():
    """Real exhaustion (no plan) raises the typed ``PageAllocOOM``, a
    ``FaultError``, and rolls the partial row back; an injected OOM leaves
    the table as it was."""
    cfg = _mixtral()["cfg"]
    schema = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]
    tbl = KVPageTable(cfg, schema, 2, 8, CacheConfig(page_tokens=4), device="cpu")
    assert tbl.pages_per_seq == 2 and issubclass(faults.PageAllocOOM, faults.FaultError)
    with faults.shielded():
        tbl.ensure_rows([0])
        tbl._free_dev, spare = tbl._free_dev[:1], tbl._free_dev[1:]
        with pytest.raises(faults.PageAllocOOM):
            tbl.ensure_rows([1])
        assert (tbl.page_map[1] == -1).all() and len(tbl._free_dev) == 1
        tbl._free_dev += spare
    with faults.armed(faults.resolve("seed=0,oom=1.0")):
        with pytest.raises(faults.PageAllocOOM, match="injected"):
            tbl.ensure_rows([1])
        assert (tbl.page_map[1] == -1).all() and len(tbl._free_dev) == 2
        tbl.ensure_rows([1])                      # never twice in a row
    assert (tbl.page_map[1] >= 0).all()


def test_demotion_moves_device_frames_to_the_host_tier():
    """``demote_device_frames`` copies live device frames into free host
    frames, highest row and page first, and the rows read the same KV."""
    cfg = _mixtral()["cfg"]
    schema = [(cfg.layer_kind(i), cfg.ffn_kind(i)) for i in range(cfg.num_layers)]
    tbl2 = KVPageTable(cfg, schema, 3, 8, CacheConfig(page_tokens=4), device="cpu")
    assert tbl2.demote_device_frames(4) == 0          # Mode A: no host tier
    # a budget of two frames: rows 0 (device) and 1, 2 (host)
    tbl = KVPageTable(cfg, schema, 3, 8,
                      CacheConfig(page_tokens=4, device_pool_bytes=2 * _frame(cfg, 4)),
                      device="cpu")
    tbl.ensure_rows([0])
    li = tbl.attn_layers[0]
    gen = torch.Generator().manual_seed(0)
    kv = torch.randn((1, 8, cfg.num_kv_heads, cfg.head_dim), generator=gen)
    tbl.insert_rows(li, kv, -kv, [0])
    before = tbl.read_rows(li, [0], 8)
    assert (tbl.page_map[0] < tbl.device_frames).all()
    tbl.take_counters()
    assert tbl.demote_device_frames(1) == 1
    assert tbl.take_counters()[1] == tbl.frame_bytes
    assert tbl.page_map[0, 1] >= tbl.device_frames and tbl.page_map[0, 0] < tbl.device_frames
    after = tbl.read_rows(li, [0], 8)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def _frame(cfg, pt):
    return cfg.num_layers * 2 * pt * cfg.num_kv_heads * cfg.head_dim * 4


# ---------------------------------------------------------------------------
# Recovery end to end, against the JAX Server under the same plan
# ---------------------------------------------------------------------------
ARMED = {
    "streamed-transfer-stall": ("seed=5,transfer=0.3,stall=0.1",
                                dict(stream_weights=True, resident_bytes=0)),
    "paged-oom": ("seed=2,oom=0.5", dict(kv_page_tokens=4)),
    "preempt": ("seed=3,preempt=3", {}),
    "paged-mode-b-preempt": ("seed=4,preempt=3", dict(kv_page_tokens=4, device_kv_gb=1e-9)),
}
COUNTERS = ("transfer_retries", "transfer_timeouts", "preemptions", "resumes",
            "degrade_deferrals", "page_demotions", "chunk_shrinks")


@pytest.mark.parametrize("case", sorted(ARMED))
def test_armed_serving_matches_fault_free_and_jax_server(case):
    """Each armed plan gives the port's fault-free tokens and the JAX
    ``Server``'s tokens under the same plan; every recovery counter equals
    the JAX report's, and a resume runs no prefill."""
    spec, kw = ARMED[case]
    m = _mixtral()
    kw = dict(kw, scheduler="continuous")
    prompts = _prompts(m["cfg"].vocab_size, 4)
    plan = dict(B=4, b_a=2, b_e=64, omega=0.0)
    with faults.shielded(), jfaults.shielded():
        base = serve_dataset(m["cfg"], m["tp"], [Request(p, 8) for p in prompts],
                             Plan(**plan), 8, device="cpu", **kw)
        jbase = jserve_dataset(m["jcfg"], m["jp"], [JRequest(p, 8) for p in prompts],
                               JPlan(**plan), 8, **kw)
    armed = serve_dataset(m["cfg"], m["tp"], [Request(p, 8) for p in prompts],
                          Plan(**plan), 8, device="cpu", faults=spec, **kw)
    jarmed = jserve_dataset(m["jcfg"], m["jp"], [JRequest(p, 8) for p in prompts],
                            JPlan(**plan), 8, faults=spec, **kw)
    assert _tokens(base) == _tokens(jbase)
    assert _tokens(armed) == _tokens(base) == _tokens(jarmed)
    assert {c: getattr(armed, c) for c in COUNTERS} == {c: getattr(jarmed, c) for c in COUNTERS}
    assert sum(getattr(armed, c) for c in COUNTERS) > 0
    assert armed.resumes == armed.preemptions
    assert armed.prefill_tokens == base.prefill_tokens


@pytest.mark.parametrize("kw", [dict(kv_page_tokens=4, device_kv_gb=1e-9), {}],
                         ids=["mode-b", "contiguous"])
def test_oom_deferred_waves_match_a_fault_free_witness(kw):
    """The admission waves an injected page OOM splits (``ServeReport
    .admission_waves``: decode tick, request indices) replayed fault-free,
    each wave submitted just before the step at its tick: the witness is
    admitted in the same waves and gives the armed run's tokens bit for
    bit, in Mode B and in the contiguous cache."""
    m = _mixtral()
    prompts = _prompts(m["cfg"].vocab_size, 6)
    plan = Plan(B=6, b_a=2, b_e=64, omega=0.0)
    base = dict(scheduler="continuous", decode_len=6, kv_page_tokens=4, device_kv_gb=1e-9)
    armed = Server(m["cfg"], m["tp"], plan, serve=ServeConfig(faults="seed=2,oom=0.4", **base),
                   device="cpu")
    for p in prompts:
        armed.submit(Request(p, 6))
    rep = armed.run()
    waves = rep.admission_waves
    assert rep.degrade_deferrals > 0 and len(waves) > 1
    assert sorted(i for _, idx in waves for i in idx) == list(range(len(prompts)))
    serve = dict(base, decode_chunk=1, max_batch=len(prompts), max_seq=len(prompts[0]) + 6)
    if not kw:
        serve.pop("kv_page_tokens"), serve.pop("device_kv_gb")
    with faults.shielded():
        wit = Server(m["cfg"], m["tp"], plan, serve=ServeConfig(**serve), device="cpu")
        steps = 0
        for tick, idx in waves:
            while steps < tick and wit.step():
                steps += 1
            for i in idx:
                wit.submit(Request(prompts[i], 6))
        wrep = wit.run()
    assert wrep.admission_waves == waves
    assert _tokens(wrep) == _tokens(rep)


def test_public_preempt_mid_run():
    """``Server.preempt(handle)``: evicted mid-drain, resumed, the stream
    completes as the unpreempted one did."""
    m = _mixtral()
    plan = Plan(B=2, b_a=2, b_e=16, omega=0.0, decode_chunk=1)
    prompts = _prompts(m["cfg"].vocab_size, 2)

    def mk():
        return Server(m["cfg"], m["tp"], plan,
                      serve=ServeConfig(scheduler="continuous", decode_len=6), device="cpu")
    with faults.shielded():
        clean = mk()
        for p in prompts:
            clean.submit(Request(p, 6))
        want = _tokens(clean.run())
        srv = mk()
        handles = [srv.submit(Request(p, 6)) for p in prompts]
        srv.step()
        srv.step()
        assert handles[0].status == "running"
        assert srv.preempt(handles[0]) and handles[0].status == "preempted"
        assert not srv.preempt(handles[0])
        assert _tokens(srv.run()) == want
    assert (srv.report.preemptions, srv.report.resumes) == (1, 1)
    assert srv.report.checkpoint_bytes > 0 and srv.report.checkpoint_s > 0


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_preemption_carries_ssm_state(arch):
    """A Mamba2 or Jamba row's checkpoint carries its SSM ``h`` and
    ``conv`` state: preempted runs give the fault-free tokens."""
    cfg = replace(get_config(arch, smoke=True), dtype="float32")
    from repro_torch.models import model as M

    tp = M.init_params(cfg, seed=0, device="cpu")
    prompts = _prompts(cfg.vocab_size, 3, length=9)
    plan = Plan(B=2, b_a=2, b_e=64, omega=0.0)
    with faults.shielded():
        base = serve_dataset(cfg, tp, [Request(p, 7) for p in prompts], plan, 7,
                             scheduler="continuous", device="cpu")
    armed = serve_dataset(cfg, tp, [Request(p, 7) for p in prompts], plan, 7,
                          scheduler="continuous", device="cpu", faults="seed=1,preempt=2")
    assert armed.preemptions > 0 and armed.resumes == armed.preemptions
    assert _tokens(armed) == _tokens(base)


def test_degrade_ladder_demotes_and_shrinks_token_identical(monkeypatch):
    """Consecutive page OOMs walk the whole ladder -- defer, demote device
    frames to the host tier, halve the chunk cap -- and the run completes
    with the fault-free tokens.  (An injected OOM never repeats at once, so
    the ladder's later stages need real exhaustion: three reservations in a
    row find no frame here.)"""
    m = _mixtral()
    prompts = _prompts(m["cfg"].vocab_size, 4)
    decs = [8, 3, 8, 8]          # slot 1 frees its frames first; slot 0 lives on
    plan = Plan(B=2, b_a=2, b_e=64, omega=0.0, decode_chunk=4)
    # 16 slots a row in 4-slot pages: 6 device frames, row 0 on 4, row 1 on 2 + 2 host
    serve = dict(scheduler="continuous", kv_page_tokens=4,
                 device_kv_gb=6 * _frame(m["cfg"], 4) / 1e9)
    with faults.shielded():
        base = serve_dataset(m["cfg"], m["tp"], [Request(p, d) for p, d in zip(prompts, decs)],
                             plan, 8, device="cpu", **serve)
    srv = Server(m["cfg"], m["tp"], plan, serve=ServeConfig(faults="seed=0", **serve),
                 device="cpu")
    for p, d in zip(prompts, decs):
        srv.submit(Request(p, d))
    srv._ensure_engine()
    real, left = srv._engine.reserve_slot_rows, [0]

    def short_of_frames(rows):
        if srv._engine.pages.page_map[rows[0], 0] < 0 and srv._any_live() and left[0] < 3:
            left[0] += 1
            raise faults.PageAllocOOM("no free frame")
        return real(rows)

    monkeypatch.setattr(srv._engine, "reserve_slot_rows", short_of_frames)
    rep = srv.run()
    assert _tokens(rep) == _tokens(base)
    assert (rep.degrade_deferrals, rep.page_demotions, rep.chunk_shrinks) == (3, 2, 1)


def test_degrade_reraises_when_nothing_can_free_a_frame():
    """No plan armed and nothing live: a page OOM is not absorbed."""
    m = _mixtral()
    srv = Server(m["cfg"], m["tp"], Plan(B=1, b_a=1, b_e=16, omega=0.0),
                 serve=ServeConfig(scheduler="continuous", decode_len=4, kv_page_tokens=4),
                 device="cpu")
    srv.submit(Request(_prompts(m["cfg"].vocab_size, 1)[0], 4))
    srv._ensure_engine()
    srv._engine.pages._free_dev.clear()
    with faults.shielded(), pytest.raises(faults.PageAllocOOM):
        srv.run()


# ---------------------------------------------------------------------------
# Unarmed no-op, sanitizer integration, the report, the launcher
# ---------------------------------------------------------------------------
def test_unarmed_serving_is_the_fault_free_path():
    """With no plan the seams add nothing: no fault-scope read, no retry,
    no checkpoint, every recovery counter 0, the JAX ``Server``'s tokens
    and the same planned reads as the reference's counted tags."""
    m = _mixtral()
    prompts = _prompts(m["cfg"].vocab_size, 4)
    plan = dict(B=4, b_a=2, b_e=64, omega=0.0)
    kw = dict(scheduler="continuous", stream_weights=True, resident_bytes=0, kv_page_tokens=4)
    with faults.shielded(), analysis.sanitize(strict=True, pointers=True) as san:
        rep = serve_dataset(m["cfg"], m["tp"], [Request(p, 6) for p in prompts], Plan(**plan),
                            6, device="cpu", **kw)
    with jfaults.shielded():
        jrep = jserve_dataset(m["jcfg"], m["jp"], [JRequest(p, 6) for p in prompts],
                              JPlan(**plan), 6, **kw)
    r = san.report()
    assert not {"fault-retry", "ckpt-save", "ckpt-restore"} & set(r["planned_transfers"])
    assert all(getattr(rep, c) == 0 for c in COUNTERS)
    assert _tokens(rep) == _tokens(jrep)
    assert r["host_reads"] == [] and r["pointer_violations"] == []


def test_armed_recovery_is_strict_sanitizer_clean():
    """The whole chaos mix under the strict sanitizer with the pointer
    check: every recovery read rides a planned scope, no cache moves."""
    m = _mixtral()
    prompts = _prompts(m["cfg"].vocab_size, 4)
    with analysis.sanitize(strict=True, pointers=True) as san:
        rep = serve_dataset(
            m["cfg"], m["tp"], [Request(p, 8) for p in prompts],
            Plan(B=4, b_a=2, b_e=64, omega=0.0), 8, scheduler="continuous",
            stream_weights=True, resident_bytes=0, kv_page_tokens=4, device="cpu",
            faults="seed=5,transfer=0.3,stall=0.1,oom=0.3,preempt=3")
    assert rep.transfer_retries > 0 and rep.preemptions > 0
    r = san.report()
    assert r["planned_transfers"]["fault-retry"] > 0 and r["planned_transfers"]["ckpt-save"] > 0
    assert r["pointer_checks"] > 0 and r["pointer_violations"] == []


def test_fault_report_records_injections_and_recoveries():
    m = _mixtral()
    prompts = _prompts(m["cfg"].vocab_size, 4)
    fp = faults.resolve("seed=5,transfer=0.3,stall=0.1")
    serve_dataset(m["cfg"], m["tp"], [Request(p, 6) for p in prompts],
                  Plan(B=4, b_a=2, b_e=64, omega=0.0), 6, scheduler="continuous",
                  stream_weights=True, resident_bytes=0, faults=fp, device="cpu")
    events = fp.report()["events"]
    assert any(k.startswith("injected:transfer") for k in events)
    assert any(k.startswith("recovered:transfer-retry") for k in events)
    assert any(k.startswith("recovered:transfer-timeout") for k in events)


def test_launcher_serves_with_faults_and_the_sanitizer():
    """``--faults`` and ``--sanitize`` reach the server; the recovery
    counters, the ledger and the sanitizer's report are printed."""
    from repro_torch.launch import serve as launch

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu", "--requests", "4",
                     "--prompt-lens", "5,9", "--decode-len", "6", "--batch", "2",
                     "--omega", "0", "--scheduler", "continuous", "--kv-page-tokens", "4",
                     "--faults", "seed=3,preempt=2,oom=0.3", "--sanitize", "strict"])
    text = out.getvalue()
    assert "faults: transfer_retries 0" in text and "preemptions" in text
    assert '"injected:preempt"' in text and "sanitizer (strict)" in text
    assert '"host_reads": []' in text and '"ckpt-save"' in text
