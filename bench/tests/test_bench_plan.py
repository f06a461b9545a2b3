"""The plan a cell runs comes from its files alone: the host's memory and
cores, which the program's own profile reads from the machine, change
nothing."""
import importlib
import os

import pytest

from bench import harness, spec

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _plan(name):
    c = spec.cell(name)
    return harness.plan_of(harness.model_config(c.conf), c)


@pytest.mark.parametrize("name", CELLS)
def test_plan_does_not_follow_the_host(name, monkeypatch, capsys):
    from repro_torch.core import hardware

    first = _plan(name)
    real = os.sysconf
    monkeypatch.setattr(os, "sysconf", lambda k: real(k) * (7 if k == "SC_PHYS_PAGES" else 1))
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    importlib.reload(hardware)
    try:
        assert _plan(name) == first
    finally:
        monkeypatch.undo()
        importlib.reload(hardware)
    c = spec.cell(name)
    assert (first.B, first.b_e, first.omega) == (c.pinned["B"], c.pinned["b_e"], c.pinned["omega"])


def test_mixtral_streams_the_pinned_stacks():
    from repro_torch.core import workload as W

    c = spec.cell("mixtral.offline_streamed")
    rp = W.plan_residency(harness.model_config(c.conf), harness.resident_bytes(c))
    assert sum(not r for r in rp.ffn_resident) == c.pinned["streamed_stacks"] == 13
    assert all(rp.mixer_resident) and all(rp.ffn_resident[:19])
