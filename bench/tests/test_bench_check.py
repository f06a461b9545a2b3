"""The check that decides ``correct``, driven end to end on the CPU at smoke
size (the harness's look for a card skipped): a sound run passes, and a run
with the timed path broken underneath does not."""
import time

import pytest

from bench import harness
from bench.tests import smoke

CELLS = ["olmoe.offline_chat", "mixtral.offline_streamed"]


def _run(cell, seed=2**31 + 5, limits=None):
    if limits is not None:
        cell.pinned["limits"] = limits
    return harness.result(cell, seed, 1.0, False, "cpu", time.perf_counter())


def _failed(out):
    return [k for k, c in out["checks"].items() if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_sound_f32_run_serves_the_references_tokens(name):
    smoke.threads()
    out = _run(smoke.cell(name, "float32"), limits={"max_logit_gap": 1e-4})
    assert out["correct"], out["checks"]
    assert out["notes"]["compared_tokens"] >= 10
    assert set(out["metrics"]) == {f"gen_tok_s.{name.split('_')[-1]}", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_a_token_altered_where_it_is_produced_fails(name, monkeypatch):
    from repro_torch.serving import server

    smoke.threads()
    emit = server.RequestHandle._emit

    def altered(self, token):
        emit(self, (token + 1) % 512 if len(self.tokens) == 2 else token)

    monkeypatch.setattr(server.RequestHandle, "_emit", altered)
    out = _run(smoke.cell(name))
    assert not out["correct"]
    assert _failed(out) == [k for k in out["checks"] if k != "unfinished"]


@pytest.mark.parametrize("name", CELLS)
def test_prefill_that_leaves_the_cache_unchanged_fails(name, monkeypatch):
    from repro_torch.core.engine import ModuleBatchingEngine

    smoke.threads()
    monkeypatch.setattr(ModuleBatchingEngine, "_write_cache_rows", lambda *a, **k: None)
    out = _run(smoke.cell(name))
    assert not out["correct"] and _failed(out)


def test_traced_run_reports_per_layer_metrics_only():
    smoke.threads()
    cell = smoke.cell("mixtral.offline_streamed")
    out = harness.result(cell, 11, 1.0, True, "cpu", time.perf_counter())
    names = set(out["metrics"])
    assert {f"{m}.streamed" for m in ("slot_occupancy_pct", "decode_tick_ms", "prefill_tok_s",
                                      "mfu_pct", "htod_gb_s", "copy_wait_ms_per_pass")} <= names
    assert "gen_tok_s.streamed" not in names and "setup_s" not in names
    assert "breakdown" in out and out["trace_window_s"] > 0
