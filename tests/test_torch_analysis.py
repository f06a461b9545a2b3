"""The port's analysis package (``repro_torch.analysis``) on the CPU.

Each lint rule is shown a deliberate violation on a synthetic source, then
the same line with a justified allowance; the port's own tree lints clean.
The sanitizer raises on a host read inside a decode region, passes and
counts planned ``allowed`` scopes, catches a new graph key in a steady
region, a moved cache tensor and a retained dropped cache; full ``Server``
lifecycles run under it, and its per-tag counts of planned reads equal the
JAX sanitizer's on the same requests.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from dataclasses import replace  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import analysis as janalysis  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.dag_builder import Plan as JPlan  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.server import Request as JRequest  # noqa: E402
from repro.serving.server import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.server import Server as JServer  # noqa: E402
from repro.serving.server import StreamConfig as JStreamConfig  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import lint, registry, runtime  # noqa: E402
from repro_torch.bridge import from_numpy_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.core.engine import ModuleBatchingEngine  # noqa: E402
from repro_torch.serving.sampling import BatchSampler  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server, StreamConfig  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SRC = os.path.join(ROOT, "src", "repro_torch")
_MODEL = {}


def _mixtral():
    """Mixtral smoke in f32, the JAX weights bridged into the port."""
    if not _MODEL:
        jcfg = replace(jget("mixtral-8x7b", smoke=True), dtype="float32")
        cfg = replace(get_config("mixtral-8x7b", smoke=True), dtype="float32")
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL.update(jcfg=jcfg, cfg=cfg, jp=jp,
                      tp=from_numpy_params(cfg, jax.tree.map(np.asarray, jp), "cpu"))
    return _MODEL


def _rules(findings):
    return sorted({f.rule for f in findings})


# ---------------------------------------------------------------------------
# The lint: one violation per rule, then its allowance
# ---------------------------------------------------------------------------
VIOLATIONS = {
    "MG101": ("core/t.py", """
        import numpy as np
        import torch
        from repro_torch.analysis import hot_path

        @hot_path
        def tick(x, ev):
            a = x.item()
            b = x.tolist()
            c = x.cpu()
            d = x.numpy()
            e = np.asarray(x)
            f = float(x)
            g = int(x.sum())
            h = bool(x.any())
            torch.cuda.synchronize()
            ev.synchronize()
            return a, b, c, d, e, f, g, h
    """, 10),
    "MG102": ("core/t.py", """
        import torch
        from repro_torch.kernels import build

        def run(xs):
            for x in xs:
                g = torch.cuda.CUDAGraph()
            while xs:
                lib = build.library("expert_gemm")
            return g, lib
    """, 2),
    "MG103": ("core/t.py", """
        def tweak(cfg, plan, self):
            cfg.num_layers = 4
            plan.B += 1
            self.serve.decode_len = 3
            object.__setattr__(cfg, "d_model", 8)
    """, 4),
    "MG104": ("core/t.py", """
        import torch
        from repro_torch.analysis import hot_path

        @hot_path
        def tick(self, li, k, carry):
            self.cache[li]["k"] = torch.cat([self.cache[li]["k"], k], dim=1)
            self.pages.pool_k[li] = self.pages.pool_k[li].clone()
            cache = self.cache[li]["v"] + 1
            self._carries[4] = carry.state * 2
    """, 4),
    "MG105": ("core/t.py", """
        import torch

        def up(x, dev, self):
            a = x.cuda()
            b = x.to(dev, non_blocking=True)
            c = x.to(self.device)
            d = x.to(device="cuda")
            e = torch.as_tensor([1, 2], device=dev)
            return a, b, c, d, e
    """, 5),
    "MG107": ("distributed/ep.py", """
        import torch.distributed as dist

        def exchange(x, out):
            dist.all_to_all_single(out, x)
            return out
    """, 1),
}


@pytest.mark.parametrize("rule", sorted(VIOLATIONS))
def test_lint_rule_flags_then_allowance_clears(rule):
    """A synthetic violation of ``rule`` is flagged once per site; the same
    source with a justified allowance on each flagged line lints clean."""
    relpath, src, n = VIOLATIONS[rule]
    src = textwrap.dedent(src)
    found = lint.check_source(src, "t.py", relpath)
    assert _rules(found) == [rule] and len(found) == n, [f.render() for f in found]
    lines = src.splitlines()
    for line in {f.line for f in found}:
        lines[line - 1] += f"  # lint: allow[{rule}] synthetic case of the test"
    assert lint.check_source("\n".join(lines), "t.py", relpath) == []


def test_lint_scopes_and_exemptions():
    """Cold functions may read back; construction scopes may set
    attributes; the copy modules may copy; a collective inside a
    ``@register_collective`` function is fine; ``.to(dtype)`` is no copy."""
    cold = "def cold(x):\n    return x.item(), int(x)\n"
    assert lint.check_source(cold, "t.py", "core/t.py") == []
    ctor = textwrap.dedent("""
        class C:
            def __init__(self, cfg):
                self.cfg = cfg
        def __post_init__(self):
            object.__setattr__(self, "x", 1)
    """)
    assert lint.check_source(ctor, "t.py", "core/t.py") == []
    copy = "def f(x, dev):\n    return x.to(dev), x.to(torch.float32)\n"
    for rel in ("serving/weights.py", "serving/cache.py"):
        assert lint.check_source(copy, "t.py", rel) == []
    assert _rules(lint.check_source(copy, "t.py", "core/t.py")) == ["MG105"]
    reg = textwrap.dedent("""
        import torch.distributed as dist
        from repro_torch.analysis import register_collective

        @register_collective("ep.a2a")
        def exchange(x, out):
            dist.all_to_all_single(out, x)
    """)
    assert lint.check_source(reg, "t.py", "distributed/ep.py") == []


def test_lint_known_host_values_pass():
    """MG101 and MG105 pass values the function makes host ones: numpy
    results and their elements, annotated numpy or integer parameters, loop
    and comprehension targets over them; ``.to(x.device)`` and
    ``torch.as_tensor(v, device=)`` of a value not known to be a host one
    are not copies to flag.  A name with one tensor binding is flagged."""
    src = textwrap.dedent("""
        import numpy as np
        import torch
        from repro_torch.analysis import hot_path

        @hot_path
        def tick(toks, ids: np.ndarray, n: int, pos, y, x):
            mat = toks.cpu().numpy()  # lint: allow[MG101] the planned read
            a = [int(mat[s, 0]) for s in range(n)]
            b = {int(e) for e in ids}
            for e in ids:
                e = int(e)
            c = bool(np.any(ids > 0)), np.asarray(ids), float(mat.shape[0])
            d = y.to(x.device), torch.as_tensor(pos, device=x.device)
            return a, b, c, d
    """)
    assert lint.check_source(src, "t.py", "core/t.py") == []
    mixed = src.replace("    for e in ids:", "    e = x.sum()\n    for e in ids:")
    # both int(e) (the lint does not separate a comprehension's scope)
    assert [f.rule for f in lint.check_source(mixed, "t.py", "core/t.py")] == ["MG101"] * 2
    host = "import numpy as np\n\ndef up(a, dev):\n    return torch.from_numpy(a).to(a.device)\n"
    assert _rules(lint.check_source(host, "t.py", "core/t.py")) == ["MG105"]


@pytest.mark.parametrize("case", ["no-reason", "stale", "docstring"])
def test_lint_mg106_allowances(case):
    """An allowance needs a reason and must suppress something; an example
    in a docstring is no allowance."""
    hot = ("from repro_torch.analysis import hot_path\n\n@hot_path\n"
           "def tick(x):\n    return x.item()  # lint: allow[MG101] the planned read\n")
    assert lint.check_source(hot, "t.py", "core/t.py") == []
    src = {"no-reason": hot.replace(" the planned read", ""),
           "stale": "def f(x):\n    return x  # lint: allow[MG101] nothing here\n",
           "docstring": '"""x.item()  # lint: allow[MG101]"""\n'}[case]
    want = [] if case == "docstring" else ["MG106"]
    assert _rules(lint.check_source(src, "t.py", "core/t.py")) == want


def test_lint_port_is_clean_and_every_allowance_has_a_reason():
    assert lint.lint_paths([SRC]) == []


def test_lint_cli_exit_codes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", SRC],
                         env=env, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    bad = tmp_path / "bad.py"
    bad.write_text("from repro_torch.analysis import hot_path\n\n\n@hot_path\n"
                   "def decode(logits):\n    return logits.argmax().item()\n")
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint", str(bad)],
                         env=env, capture_output=True, text=True)
    assert out.returncode == 1 and "MG101" in out.stdout


# ---------------------------------------------------------------------------
# The sanitizer: the guard, planned scopes, steady regions
# ---------------------------------------------------------------------------
HOST_READS = {
    "item": lambda t: t.sum().item(), "tolist": lambda t: t.tolist(),
    "numpy": lambda t: t.numpy(), "cpu": lambda t: t.cpu(),
    "bool": lambda t: bool(t.any()), "int": lambda t: int(t.sum()),
    "float": lambda t: float(t.sum()), "index": lambda t: [1, 2, 3][t[0]],
    "asarray": lambda t: np.asarray(t), "synchronize": lambda t: torch.cuda.synchronize(),
}


@pytest.mark.parametrize("kind", sorted(HOST_READS))
def test_decode_region_rejects_host_reads(kind):
    """Strict: a host read (or sync) inside a decode region raises;
    outside the region, or inside ``allowed``, the same read works."""
    t = torch.arange(4)
    with analysis.sanitize(strict=True) as san:
        with runtime.decode_region():
            with pytest.raises(analysis.SanitizerError, match="decode region"):
                HOST_READS[kind](t)
            if kind != "synchronize":
                with analysis.allowed("test-tag"):
                    HOST_READS[kind](t)
        if kind != "synchronize":
            HOST_READS[kind](t)
    assert san.planned.get("test-tag", 0) == (kind != "synchronize")


def test_log_mode_records_instead_of_raising():
    t = torch.arange(4)
    with analysis.sanitize(strict=False) as san:
        with runtime.decode_region():
            assert t.sum().item() == 6
    assert len(san.host_reads) == 1 and ".item()" in san.host_reads[0]
    assert san.report()["mode"] == "log"


def test_allowed_scope_counts_per_tag():
    t = torch.arange(4)
    with analysis.sanitize(strict=True) as san:
        with runtime.decode_region():
            for _ in range(3):
                with analysis.allowed("token-readback"):
                    t.numpy()
            with analysis.allowed("expert-prefetch"):
                with analysis.allowed("fault-retry"):
                    t.tolist()
                t.cpu()                       # still inside the outer scope
    assert san.report()["planned_transfers"] == {
        "token-readback": 3, "expert-prefetch": 1, "fault-retry": 1}


def test_unarmed_region_installs_nothing(monkeypatch):
    """No sanitizer: the region is a null context (no mode installed) and
    ``allowed`` counts nothing."""
    monkeypatch.setattr(runtime, "_AMBIENT", None)
    monkeypatch.setattr(runtime, "_AMBIENT_INIT", True)
    t = torch.arange(4)
    with runtime.decode_region():
        assert not torch.overrides._get_current_function_mode_stack()
        assert t.sum().item() == 6
        with analysis.allowed("tag"):
            assert int(t[1]) == 1
    assert runtime.current() is None


def test_steady_region_catches_a_new_graph_key():
    """The registry's key sets: a key added inside ``steady()`` is a
    ``RetraceViolation`` naming it (strict) or a count (log); a discarded
    key added again counts again."""
    ks = registry.TraceKeySet("test.graphs")
    ks.add((4, 0, 64))
    with analysis.sanitize(strict=True) as san:
        with san.steady():
            assert not ks.add((4, 0, 64))
        with pytest.raises(analysis.RetraceViolation, match=r"test\.graphs \(8, 0, 64\)"):
            with san.steady():
                ks.add((8, 0, 64))
    assert san.steady_retraces == {"test.graphs": 1}
    ks.discard((4, 0, 64))
    with analysis.sanitize(strict=False) as san:
        with san.steady():
            assert ks.add((4, 0, 64))
    assert san.steady_retraces == {"test.graphs": 1}
    assert registry.keyset_counts()["test.graphs"] == 2 and ks.count == 2


def test_ambient_env_sanitizer(tmp_path):
    """``REPRO_SANITIZE`` arms a process-wide sanitizer and
    ``REPRO_SANITIZE_REPORT`` writes its report at exit."""
    report = tmp_path / "san.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), REPRO_SANITIZE="strict",
               REPRO_SANITIZE_REPORT=str(report))
    snippet = textwrap.dedent("""
        import torch
        from repro_torch.analysis import runtime
        t = torch.arange(4)
        failed = False
        with runtime.decode_region():
            try:
                t.sum().item()
            except runtime.SanitizerError:
                failed = True
            with runtime.allowed("tag"):
                t.sum().item()
        assert failed, "the ambient strict guard did not trip"
    """)
    out = subprocess.run([sys.executable, "-c", snippet], env=env, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    rep = json.loads(report.read_text())
    assert rep["mode"] == "strict" and rep["planned_transfers"]["tag"] == 1


# ---------------------------------------------------------------------------
# Cache ownership: the pointer check and poisoning
# ---------------------------------------------------------------------------
def _engine(**kw):
    m = _mixtral()
    return ModuleBatchingEngine(m["cfg"], m["tp"], Plan(B=2, b_a=2, b_e=16, omega=0.0),
                                max_seq=12, device="cpu", **kw)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per-module"])
def test_pointer_check_catches_a_rebound_cache_tensor(fused):
    """Ticks that write the cache in place pass; a cache tensor rebound
    between ticks is a ``DonationViolation`` at the next tick."""
    eng = _engine(fused_decode=fused)
    toks = torch.randint(1, eng.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))
    sampler = BatchSampler(2)
    with analysis.sanitize(strict=True, pointers=True) as san:
        nxt = sampler.sample(eng.prefill(toks))
        nxt = eng.decode_chunk(nxt, np.full(2, 8), sampler, 2)[:, -1]
        eng.decode_chunk(nxt, np.full(2, 10), sampler, 1)
        assert san.pointer_checks == 2
        li = next(i for i, (k, _) in enumerate(eng.schema) if k == "attn")
        eng.cache[li]["k"] = eng.cache[li]["k"].clone()      # the bug
        with pytest.raises(analysis.DonationViolation, match=f"cache.{li}.k"):
            eng.decode_chunk(nxt, np.full(2, 11), sampler, 1)


def test_poisoned_retained_cache_reads_nan():
    """A cache the engine drops (a new batch size) is filled with NaN under
    ``poison=True``: a retained reference reads NaN; the live one reads
    finite values."""
    eng = _engine()
    toks = torch.randint(1, eng.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    with analysis.sanitize(strict=False, poison=True) as san:
        eng.generate(toks, 2)
        li = next(i for i, (k, _) in enumerate(eng.schema) if k == "attn")
        retained = eng.cache[li]["k"]                  # the bug poisoning shows
        eng.generate(toks[:1], 2)                      # another batch size
        assert torch.isnan(retained).all()
        assert torch.isfinite(eng.cache[li]["k"]).all()
    assert san.poisoned > 0
    kept = eng.cache[li]["k"]
    eng.generate(toks, 2)                              # unarmed: nothing poisoned
    assert torch.isfinite(kept).all()


# ---------------------------------------------------------------------------
# Full Server lifecycles under the strict sanitizer
# ---------------------------------------------------------------------------
_MODES = {"contiguous": {}, "paged": {"kv_page_tokens": 4, "device_kv_gb": 1e-9},
          "streamed": {"stream": StreamConfig(stream_weights=True, resident_bytes=0.0)},
          "omega": {"omega": 0.5}, "paged-omega": {"omega": 0.5, "kv_page_tokens": 4,
                                                   "device_kv_gb": 1e-9}}


def _requests(cfg, n=3, length=8, decode=3):
    rng = np.random.default_rng(0)
    return [Request(rng.integers(1, cfg.vocab_size, length).astype(np.int32), decode)
            for _ in range(n)]


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
@pytest.mark.parametrize("mode", sorted(_MODES))
def test_server_lifecycle_sanitized(scheduler, mode):
    """A warm pass, then the same workload in a steady region: no host read
    outside a planned scope, no new graph key, no moved cache tensor."""
    m = _mixtral()
    opts = dict(_MODES[mode])
    stream = opts.pop("stream", StreamConfig())
    omega = opts.pop("omega", 0.0)
    reqs = _requests(m["cfg"])
    with analysis.sanitize(strict=True, pointers=True) as san:
        server = Server(m["cfg"], m["tp"], Plan(B=2, b_a=1, b_e=16, omega=omega),
                        serve=ServeConfig(scheduler=scheduler, decode_len=3, **opts),
                        stream=stream, device="cpu")
        first = [server.submit(r) for r in reqs]
        while server.step():
            pass
        with san.steady():
            again = [server.submit(r) for r in reqs]
            while server.step():
                pass
        server.finalize()
    assert [h.tokens for h in first] == [h.tokens for h in again]
    rep = san.report()
    assert rep["steady_retraces"] == {} and rep["host_reads"] == []
    assert rep["planned_transfers"]["token-readback"] >= 1
    assert rep["pointer_checks"] > 0 and rep["pointer_violations"] == []


def test_seeded_host_read_in_a_decode_function_raises(monkeypatch):
    """The same lifecycle with an ``.item()`` seeded into a decode stage
    raises ``SanitizerError``; unarmed it serves."""
    m = _mixtral()
    real = ModuleBatchingEngine._expert_stage_grouped

    def stage(self, li, p, x):
        x.sum().item()                             # the seeded hidden sync
        return real(self, li, p, x)

    monkeypatch.setattr(ModuleBatchingEngine, "_expert_stage_grouped", stage)

    def serve():
        server = Server(m["cfg"], m["tp"], Plan(B=2, b_a=2, b_e=16, omega=0.0),
                        serve=ServeConfig(scheduler="continuous", decode_len=3), device="cpu")
        for r in _requests(m["cfg"]):
            server.submit(r)
        return server.run()

    with analysis.sanitize(strict=True), pytest.raises(analysis.SanitizerError,
                                                       match=r"\.item\(\)"):
        serve()
    assert len(serve().request_results) == 3


def test_paged_tick_reads_no_positions():
    """Mode B keeps the positions' host mirror on the host (the counterpart
    of the reference's one position read a tick): a decode step with host
    positions makes no ``decode-inputs`` read, and a tensor of positions
    one."""
    from repro_torch.serving.cache import CacheConfig

    eng = _engine(cache_config=CacheConfig(page_tokens=4, device_pool_bytes=1.0))
    toks = torch.randint(1, eng.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(4))
    eng.prefill(toks)
    assert not eng.pages.fully_resident
    with analysis.sanitize(strict=True) as san:
        eng.decode_step(toks[:, -1], np.full(2, 8))
        assert "decode-inputs" not in san.planned
        eng.decode_step(toks[:, -1], torch.full((2,), 9))
    assert san.planned["decode-inputs"] == 1


# ---------------------------------------------------------------------------
# Per-tag planned reads against the JAX sanitizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["resident-static", "resident-continuous", "predictive"])
def test_planned_read_counts_match_jax_sanitizer(case):
    """One CPU run of the same requests through both servers: the port's
    counts of ``token-readback`` and ``prefill-capacity-probe`` (and, for a
    predictively streamed model, ``expert-prefetch``: the one read a layer
    and tick plus each expert copy issued) equal the JAX sanitizer's."""
    m = _mixtral()
    scheduler = "static" if case == "resident-static" else "continuous"
    kw = dict(B=3, b_a=2, b_e=3, omega=0.0)
    stream, jstream, tags = StreamConfig(), JStreamConfig(), ["token-readback",
                                                             "prefill-capacity-probe"]
    if case == "predictive":
        stream = StreamConfig(stream_weights=True, resident_bytes=0.0, predict_topk=1)
        jstream = JStreamConfig(stream_weights=True, resident_bytes=0.0, predict_topk=1)
        tags.append("expert-prefetch")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, m["cfg"].vocab_size, n).astype(np.int32)
               for n in (12, 5, 9, 3, 7)]
    decs = [4, 6, 3, 5, 4]
    with janalysis.sanitize(strict=True) as jsan:
        js = JServer(m["jcfg"], m["jp"], JPlan(**kw), stream=jstream,
                     serve=JServeConfig(scheduler=scheduler, decode_len=4))
        for p, d in zip(prompts, decs):
            js.submit(JRequest(p, d))
        jrep = js.run()
    with analysis.sanitize(strict=True) as san:
        ts = Server(m["cfg"], m["tp"], Plan(**kw), stream=stream,
                    serve=ServeConfig(scheduler=scheduler, decode_len=4), device="cpu")
        for p, d in zip(prompts, decs):
            ts.submit(Request(p, d))
        trep = ts.run()
    assert [r.tokens.tolist() for r in trep.request_results] == \
        [r.tokens.tolist() for r in jrep.request_results]
    want = {t: jsan.planned.get(t, 0) for t in tags}
    assert {t: san.planned.get(t, 0) for t in tags} == want
    assert all(want.values())
