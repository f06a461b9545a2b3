"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's analytic terms, and its table from synthetic dry-run reports."""
import json

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402

CASES = [(a, s, w) for a in list_archs() for s in SHAPES for w in ("fsdp", "tp")]


@pytest.mark.parametrize("arch,shape,weights", CASES, ids=lambda v: str(v))
def test_analytic_terms_equal_the_reference(arch, shape, weights):
    cfg, jcfg = get_config(arch), jget(arch)
    assert roof.memory_bytes_per_device(cfg, SHAPES[shape], weights) == \
        jroof.memory_bytes_per_device(jcfg, JSHAPES[shape], weights)
    assert roof.model_flops(cfg, SHAPES[shape]) == jroof.model_flops(jcfg, JSHAPES[shape])


def test_reference_properties_hold():
    """6ND for training, 2ND per decoded token, active parameters for an MoE,
    weight-stationary (tp) under fsdp."""
    q = get_config("qwen2-1.5b")
    n = q.param_counts()["active"]
    tr, de = SHAPES["train_4k"], SHAPES["decode_32k"]
    assert roof.model_flops(q, tr) == pytest.approx(6 * n * tr.global_batch * tr.seq_len)
    assert roof.model_flops(q, de) == pytest.approx(2 * n * de.global_batch)
    moe = get_config("phi3.5-moe-42b-a6.6b")
    assert roof.model_flops(moe, tr) < 0.3 * (
        6 * moe.param_counts()["total"] * tr.global_batch * tr.seq_len)
    ol = get_config("olmoe-1b-7b")
    assert roof.memory_bytes_per_device(ol, de, "tp")["total"] < \
        roof.memory_bytes_per_device(ol, de, "fsdp")["total"]
    for shape in SHAPES.values():
        m = roof.memory_bytes_per_device(ol, shape)
        assert m["total"] > 0 and all(v >= 0 for v in m.values())


def test_h100_datasheet_constants():
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.LINK_BW) == (989.4e12, 3.35e12, 50e9)
    assert "H100" in roof.to_markdown([], "fsdp") and "TPU" not in roof.to_markdown([], "fsdp")


def test_build_rows_statuses_from_synthetic_reports(tmp_path):
    """ok (terms from the report's FLOPs and bytes), skipped, failed and
    missing rows, and the markdown table."""
    arch = "olmoe-1b-7b"
    dot, coll, peak = 4e15, 2e10, 30e9
    reports = {
        "train_4k": {"status": "ok", "dot_flops_per_device": dot, "collective_bytes": coll,
                     "memory": {"peak_size_in_bytes": peak}},
        "long_500k": {"status": "skipped", "reason": "long_500k requires sub-quadratic"},
        "prefill_32k": {"status": "failed", "error": "RuntimeError: boom"},
    }
    for shape, rep in reports.items():
        rep = {"arch": arch, "shape": shape, "mesh": "single", "weights": "fsdp", **rep}
        (tmp_path / f"{arch}_{shape}_single_fsdp.json").write_text(json.dumps(rep))
    rows = {(r.arch, r.shape): r for r in roof.build_rows("fsdp", str(tmp_path))}
    assert len(rows) == len(list_archs()) * len(SHAPES)
    ok = rows[(arch, "train_4k")]
    cfg = get_config(arch)
    mem = roof.memory_bytes_per_device(cfg, SHAPES["train_4k"], "fsdp")["total"]
    assert ok.status == "ok"
    assert ok.compute_s == dot / roof.PEAK_FLOPS
    assert ok.memory_s == mem / roof.HBM_BW
    assert ok.collective_s == coll / roof.LINK_BW
    assert ok.dominant == max(("compute", ok.compute_s), ("memory", ok.memory_s),
                              ("collective", ok.collective_s), key=lambda kv: kv[1])[0]
    assert ok.useful_ratio == roof.model_flops(cfg, SHAPES["train_4k"]) / (dot * 256)
    assert ok.peak_bytes == peak
    assert rows[(arch, "long_500k")].status == "skipped"
    assert rows[(arch, "prefill_32k")].status == "failed"
    assert rows[(arch, "prefill_32k")].note.startswith("RuntimeError")
    assert rows[(arch, "decode_32k")].status == "missing"
    md = roof.to_markdown(list(rows.values()), "fsdp")
    assert "30.0 GB" in md and "| olmoe-1b-7b | decode_32k | — |" in md


def test_fmt_s():
    assert (roof.fmt_s(None), roof.fmt_s(5e-5), roof.fmt_s(0.25), roof.fmt_s(2.0)) == \
        ("-", "50us", "250.0ms", "2.00s")
