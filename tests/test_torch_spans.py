"""The server's profiler ranges (``repro_torch.analysis.spans``) on the CPU.

Without a profiler a span is the shared null context and no
``RecordFunction`` is made.  Under ``torch.profiler`` a small ``Server`` run
writes one ``serve.prefill`` a wave and one ``serve.decode`` a decoding
step, each over the interval its ``ServeReport`` counter adds, with the
planned reads (``sync.<tag>``) nested inside them; the tokens are those of
an unprofiled run, and the strict sanitizer sees no new host read."""
from dataclasses import replace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.analysis import runtime, spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dag_builder import Plan  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.serving.server import Request, ServeConfig, Server  # noqa: E402

LENS = [12, 5, 9, 3, 7, 12, 4]
DECS = [4, 6, 3, 5, 4, 2, 6]
PLAN = Plan(B=3, b_a=2, b_e=3, omega=0.0)


@pytest.fixture(scope="module")
def model():
    cfg = replace(get_config("olmoe-1b-7b", smoke=True), dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in LENS]
    return cfg, params, prompts


def _run(model, scheduler):
    """Serve the prompts step by step; each step's increments of
    ``prefill_s``, ``decode_s`` and the decoded slot-steps, and the tokens."""
    cfg, params, prompts = model
    server = Server(cfg, params, PLAN, device="cpu",
                    serve=ServeConfig(scheduler=scheduler, decode_len=4, decode_chunk=4))
    handles = [server.submit(Request(p, d)) for p, d in zip(prompts, DECS)]
    rep, steps = server.report, []
    while True:
        before = (rep.prefill_s, rep.decode_s, rep.decode_slot_steps)
        more = server.step()
        steps.append((rep.prefill_s - before[0], rep.decode_s - before[1],
                      rep.decode_slot_steps > before[2]))
        if not more:
            break
    moe_layers = sum(ffn == "moe" for _, ffn in server._engine.schema)
    waves = [len(idx) for _, idx in rep.admission_waves]
    return [list(h.tokens) for h in handles], steps, waves, moe_layers


def _ranges(prof, name):
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


def _inside(inner, outer):
    return all(any(a0 <= b0 and b1 <= a1 for a0, a1 in outer) for b0, b1 in inner)


def test_no_profiler_gives_the_shared_null_context(monkeypatch):
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: made.append(name))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("serve.decode") is spans.span("serve.prefill") is spans._NULL
    with runtime.allowed("token-readback"):
        with spans.span("serve.decode"):
            pass
    assert made == []


def test_profiler_gives_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with runtime.allowed("token-readback"):
            pass
        rf = spans.span("serve.decode")
    assert isinstance(rf, torch.autograd.profiler.record_function)
    assert len(_ranges(prof, "sync.token-readback")) == 1
    assert spans.span("serve.decode") is spans._NULL


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_server_spans_cover_the_report_intervals(model, scheduler):
    plain, _, _, _ = _run(model, scheduler)
    with runtime.sanitize(strict=True) as san:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            toks, steps, waves, moe_layers = _run(model, scheduler)
    assert toks == plain
    assert san.report()["host_reads"] == []

    prefill, decode = _ranges(prof, "serve.prefill"), _ranges(prof, "serve.decode")
    assert len(prefill) == len(waves) >= 2
    decoded = [d for _, d, ran in steps if ran]
    assert len(decode) == len(decoded) == sum(d > 0 for _, d, _ in steps)
    assert len(decode) > 0
    # each span holds the interval its counter adds, and little more
    for got, want in ((prefill, [p for p, _, _ in steps if p > 0]), (decode, decoded)):
        span_s = sum(b - a for a, b in got) * 1e-6
        assert len(want) == len(got)
        assert sum(want) <= span_s + 1e-6
        assert span_s - sum(want) <= 1e-3 * len(got)

    readback = _ranges(prof, "sync.token-readback")
    assert len(readback) == len(decode) and _inside(readback, decode)
    probe = _ranges(prof, "sync.prefill-capacity-probe")
    b_a = PLAN.b_a
    assert len(probe) == moe_layers * sum(-(-n // b_a) for n in waves)
    assert _inside(probe, prefill)
    assert not _inside(probe[:1], decode)
