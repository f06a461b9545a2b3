"""The port's trace analysis (``repro_torch.launch.trace_analysis``), the
counterpart of ``tests/test_hlo_analysis.py``: a synthetic trace, a trace
recorded from a toy program on a fake group of 4 ranks, the FLOPs of a
recorded matmul, the op histogram and the live-storage peak."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.distributed import collectives as C  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch.trace_analysis import (  # noqa: E402
    Recorder,
    collective_stats,
    dot_flops,
    op_histogram,
    read_trace,
    total_collective_bytes,
    total_flops,
    write_trace,
)
from repro_torch.sharding.specs import ShardCtx  # noqa: E402

SYNTH = [
    {"type": "op", "op": "aten.mm", "dtypes": ["float32"], "shapes": [[4, 8]], "flops": 512},
    {"type": "collective", "kind": "all-gather", "axes": ["model"], "ranks": 2,
     "sent_bytes": 16, "bytes": 32},
    {"type": "collective", "kind": "all-reduce", "axes": ["model"], "ranks": 2,
     "sent_bytes": 32, "bytes": 32},
    {"type": "op", "op": "aten.add", "dtypes": ["float32"], "shapes": [[4, 8]], "flops": 0},
    {"type": "collective", "kind": "all-gather", "axes": ["data"], "ranks": 4,
     "sent_bytes": 64, "bytes": 256},
    {"type": "op", "op": "aten.bmm", "dtypes": ["float32"], "shapes": [[2, 4, 8]],
     "flops": 1024},
    {"type": "op", "op": "aten.convolution", "dtypes": ["float32"], "shapes": [[1, 4, 8]],
     "flops": 100},
]


def test_synthetic_counts_and_bytes():
    stats = collective_stats(SYNTH)
    assert stats["all-gather"] == {"count": 2, "bytes": 32 + 256, "sent_bytes": 16 + 64}
    assert stats["all-reduce"] == {"count": 1, "bytes": 32, "sent_bytes": 32}
    # an all-reduce weighs 2 in the total (a ring's reduce-scatter and all-gather)
    assert total_collective_bytes(SYNTH) == (32 + 256) + 2 * 32
    assert dot_flops(SYNTH) == 512 + 1024             # the convolution is no dot
    assert total_flops(SYNTH) == 512 + 1024 + 100


def test_trace_round_trips_through_json_lines(tmp_path):
    for name in ("t.jsonl", "t.jsonl.gz"):
        path = str(tmp_path / name)
        write_trace(path, SYNTH)
        assert read_trace(path) == SYNTH


def test_recorded_matmul_flops_are_2mnk():
    M_, N, K = 6, 5, 7
    a, b = torch.ones((M_, K)), torch.ones((K, N))
    with Recorder() as rec:
        c = a @ b
        d = torch.bmm(a[None].expand(3, M_, K), b[None].expand(3, K, N))
    assert dot_flops(rec.records) == 2 * M_ * N * K + 3 * 2 * M_ * N * K
    mm = next(r for r in rec.records if r["op"] == "aten.mm")
    assert mm["shapes"] == [[M_, N]] and mm["dtypes"] == ["float32"]
    assert c.shape == (M_, N) and d.shape == (3, M_, N)


def test_op_histogram():
    with Recorder() as rec:
        x = torch.ones((4, 4))
        for _ in range(3):
            x = x + 1
        x = x @ x
    h = op_histogram(rec.records)
    assert h["aten.add"] == 3 and h["aten.mm"] == 1
    assert list(h)[0] == "aten.add"                   # most frequent first
    assert op_histogram(SYNTH, top=1) == {"all-gather": 2}


def test_live_storage_peak():
    """The peak counts the held arguments and every live output; views share
    their base's storage; a released tensor leaves the live count."""
    a = torch.ones((256, 256))                        # 256 KB, held
    rec = Recorder()
    rec.hold({"a": a, "view": a[1:]})
    assert rec.live_bytes == a.nbytes
    with rec:
        b = a * 2                                     # +256 KB
        v = b.view(-1)                                # a view: no new storage
        del b, v
        c = a + 1                                     # reuses the freed room
    assert rec.peak_bytes == 2 * a.nbytes
    assert rec.live_bytes == 2 * a.nbytes
    del c
    assert rec.live_bytes == a.nbytes


def test_toy_program_on_a_fake_group_of_four():
    """Every exchange of ``distributed.collectives`` on a (2, 2) mesh of a
    fake group becomes one record with its kind, axes, ranks and bytes;
    ``STATS`` counts the same by kind."""
    with mesh.fake_group(4):
        m = mesh.make_mesh((2, 2), ("data", "model"))
        ctx = ShardCtx(mesh=m, batch_axes=("data",), model_axis="model")
        x = torch.ones((4, 6), dtype=torch.bfloat16)
        C.reset_stats()
        with Recorder(m) as rec:
            C.reduce_model(ctx, x)                    # f32 sum over model: 96 B
            C.gather_model(ctx, x, 1, partial=False)  # 48 B sent, 96 B gathered
            C.all_to_all_model(ctx, x)                # 48 B each way
            C.reduce_batch(ctx, x)                    # over data
        colls = [r for r in rec.records if r["type"] == "collective"]
    assert [(r["kind"], r["axes"], r["ranks"]) for r in colls] == [
        ("all-reduce", ["model"], 2), ("all-gather", ["model"], 2),
        ("all-to-all", ["model"], 2), ("all-reduce", ["data"], 2)]
    assert [(r["sent_bytes"], r["bytes"]) for r in colls] == [
        (96, 96), (48, 96), (48, 48), (96, 96)]
    stats = collective_stats(rec.records)
    assert stats == {"all-reduce": {"count": 2, "bytes": 192, "sent_bytes": 192},
                     "all-gather": {"count": 1, "bytes": 96, "sent_bytes": 48},
                     "all-to-all": {"count": 1, "bytes": 48, "sent_bytes": 48}}
    assert {k: (v["calls"], v["bytes"]) for k, v in C.STATS["by_kind"].items()} == {
        k: (s["count"], s["sent_bytes"]) for k, s in stats.items()}


def test_by_kind_counters_sum_to_the_totals():
    with mesh.fake_group(2):
        m = mesh.make_mesh((1, 2), ("data", "model"))
        ctx = ShardCtx(mesh=m, batch_axes=("data",), model_axis="model")
        C.reset_stats()
        x = torch.ones((2, 8))
        for _ in range(3):
            C.reduce_model(ctx, x)
        C.all_gather_value(ctx, x, 0)
        C.all_to_all_model(ctx, x)
    by = C.STATS["by_kind"]
    assert sum(v["calls"] for v in by.values()) == C.STATS["calls"] == 5
    assert sum(v["bytes"] for v in by.values()) == C.STATS["bytes"]
    C.reset_stats()
    assert C.STATS["calls"] == 0 and all(v == {"calls": 0, "bytes": 0}
                                         for v in C.STATS["by_kind"].values())
