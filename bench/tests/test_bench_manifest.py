"""BENCHMARK.json against the contract's shape, and every file it names."""
import json
import re

import pytest

from bench import harness, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

MAN = spec.manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
    for w in MAN["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"]), w


def test_run_seconds_fits_the_full_check():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"bench/configs/{c['name']}.json"
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(pairs) // 4)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _line(m["layer"])
    every = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]]
    every += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(every) == len(set(every))
    assert {w["config"] for w in MAN["workloads"]} == set(names)


def _reported(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_reports_and_moves(w):
    e2e = [m["name"] for m in MAN["end_to_end"] if _reported(m, w["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in MAN["per_layer"] if _reported(m, w["name"])]
    assert per
    for m in per:
        assert m["moves"] in e2e, (m["name"], w["name"])


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert (spec.BENCH / "metrics" / f"{harness.base(m['name'])}.py").is_file()
    for cell in m.get("workloads", []):
        assert cell in {w["name"] for w in MAN["workloads"]}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(w):
    c = spec.cell(w["name"])
    assert c.pinned["limits"] and all(v > 0 for v in c.pinned["limits"].values())
    assert c.pinned["scheduler"] in ("static", "continuous")
    assert int(c.pinned["b_e"]) == int(c.pinned["B"])      # no routed copy drops
    assert float(c.pinned["omega"]) == 0.0
    assert c.conf["name"] == w["config"]
    json.dumps(c.mix)
