"""``bench/trace.py::read`` and ``bench/program_spans.py::read`` on
hand-built chrome-trace events (times in us): the slice's fields with and
without the program's ranges, and the split of the idle time, the waits and
the decode chunks' copies that the ranges give; then both on a profiled
smoke server on the CPU."""
import json

import pytest

from bench import program_spans, trace

HOST, STREAM = 1, 7


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1,
         "tid": STREAM if cat in ("kernel", "gpu_memcpy", "gpu_memset",
                                  "gpu_user_annotation") else HOST}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def ann(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def rt(name, ts, dur, corr):
    return ev(name, "cuda_runtime", ts, dur, corr)


HTOD, DTOH = "Memcpy HtoD (Pinned -> Device)", "Memcpy DtoH (Device -> Pageable)"


def base_events():
    """A 1000 us slice with two kernels, a copy, launches and host ops, and
    no range of the program's."""
    return [
        ann("bench.slice", 0, 1000), ann("bench.step", 0, 400), ann("bench.step", 500, 500),
        ev("bench.slice", "gpu_user_annotation", 0, 1000),
        rt("cudaLaunchKernel", 90, 5, 1), ev("aten::mm", "cpu_op", 80, 40),
        ev("k1", "kernel", 100, 100, 1),
        rt("cudaMemcpyAsync", 140, 5, 2), ev(HTOD, "gpu_memcpy", 150, 150, 2),
        ev("aten::copy_", "cpu_op", 290, 20),
        rt("cudaLaunchKernel", 600, 5, 9),           # its device record was dropped
        ev("k2", "kernel", 1200, 50, 3),             # after the slice
    ]


def test_fields_without_program_ranges():
    sl = trace.read(base_events())
    assert sl.window_s == pytest.approx(1000e-6)
    assert sl.busy_s == pytest.approx(200e-6)
    assert sl.kernel_s == pytest.approx({"k1": 100e-6, HTOD: 150e-6})
    assert sl.gaps_s == pytest.approx({"bench.step": 100e-6,
                                       "bench.step > aten::copy_": 700e-6})
    assert sl.unmatched == 1
    assert program_spans.read(base_events()) is None
    assert sl.breakdown()["idle_gaps"][0] == ["bench.step > aten::copy_", pytest.approx(700e-6)]


def served_events():
    """A prefill wave with a capacity probe, then a decode chunk that streams
    a copy under a kernel and reads its tokens back."""
    return [
        ann("bench.slice", 0, 1000), ann("bench.step", 0, 1000),
        rt("cudaStreamSynchronize", 0, 8, 0),
        ann("serve.prefill", 10, 390),
        ev("k-prefill", "kernel", 20, 110, 1),
        ann("sync.prefill-capacity-probe", 100, 50), rt("cudaMemcpyAsync", 100, 40, 5),
        ev(DTOH, "gpu_memcpy", 130, 8, 5),
        ev("k-prefill", "kernel", 200, 180, 2),
        ann("serve.decode", 450, 450),
        ev(HTOD, "gpu_memcpy", 520, 180, 6),
        ev("k-decode", "kernel", 600, 200, 3),
        ann("sync.token-readback", 800, 100), rt("cudaMemcpyAsync", 805, 75, 7),
        ev(DTOH, "gpu_memcpy", 870, 5, 7),
    ]


def test_idle_split_waits_and_copies():
    sl = trace.read(served_events())
    p = program_spans.read(served_events())
    assert p.window_s == sl.window_s
    assert sl.busy_s == pytest.approx(583e-6)
    # [0,20) half before the wave; [138,200) and [380,400) in it; [400,450)
    # between; [450,520), [800,870) and [875,900) in the chunk; [900,1000) after
    assert p.idle_in == pytest.approx({"prefill": 92e-6, "decode": 165e-6,
                                       "outside": 160e-6})
    assert sum(p.idle_in.values()) == pytest.approx(sl.window_s - sl.busy_s)
    assert p.sync_idle == pytest.approx({"unplanned": 20e-6, "prefill-capacity-probe": 62e-6,
                                         "token-readback": 195e-6})
    assert p.decode_span_s == pytest.approx(450e-6)
    assert p.htod_idle_s == pytest.approx(270e-6)      # the copy runs [520,700)
    assert p.copy_only_s == pytest.approx(80e-6)       # [520,600): no kernel yet
    assert p.spans == {"serve.prefill": 1, "serve.decode": 1,
                       "sync.prefill-capacity-probe": 1, "sync.token-readback": 1}
    assert ["bench.step > serve.prefill", pytest.approx(140e-6)] in sl.breakdown()["idle_gaps"]


def test_gap_keys_by_where_it_began():
    events = [
        ann("bench.slice", 0, 1000), ann("bench.step", 0, 1000), ann("serve.decode", 0, 1000),
        ev("k", "kernel", 0, 100, 1),
        # inside sync.x, under an op and its copy: keyed x
        ann("sync.x", 90, 60), ev("aten::item", "cpu_op", 90, 50),
        rt("cudaMemcpyAsync", 91, 40, 2), ev(DTOH, "gpu_memcpy", 100, 10, 2),
        ev("k", "kernel", 200, 100, 3),
        # a device-to-host copy outside any sync range: unplanned
        rt("cudaMemcpyAsync", 290, 30, 4), ev(DTOH, "gpu_memcpy", 300, 10, 4),
        ev("k", "kernel", 400, 100, 5),
        # a host-to-device copy is no wait: not keyed
        rt("cudaMemcpyAsync", 490, 30, 6), ev(HTOD, "gpu_memcpy", 500, 10, 6),
        ev("k", "kernel", 600, 100, 7),
        # an event synchronisation: unplanned
        rt("cudaEventSynchronize", 690, 30, 0),
        ev("k", "kernel", 800, 200, 8),
    ]
    p = program_spans.read(events)
    assert p.sync_idle == pytest.approx({"x": 90e-6, "unplanned": 90e-6 + 100e-6})
    assert p.idle_in == pytest.approx({"prefill": 0.0, "decode": 370e-6, "outside": 0.0})


def test_copy_and_kernel_overlaps_in_decode():
    events = [
        ann("bench.slice", 0, 1000), ann("bench.step", 0, 1000),
        ann("serve.decode", 100, 300), ann("serve.decode", 600, 300),
        ev(HTOD, "gpu_memcpy", 50, 150, 1),       # [100,200) in the first chunk
        ev(HTOD, "gpu_memcpy", 150, 100, 2),      # overlaps the first copy
        ev("k", "kernel", 180, 40, 3),
        ev(HTOD, "gpu_memcpy", 700, 100, 4),
        ev("k", "kernel", 650, 300, 5),           # covers the second copy
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 300, 50, 6),
    ]
    p = program_spans.read(events)
    assert p.decode_span_s == pytest.approx(600e-6)
    # copies in chunks: [100,250) and [700,800)
    assert p.htod_idle_s == pytest.approx(600e-6 - 150e-6 - 100e-6)
    # of them without a kernel: [100,180) and [220,250)
    assert p.copy_only_s == pytest.approx(110e-6)


def test_no_program_without_a_serve_range():
    assert program_spans.read(base_events() + [ann("sync.token-readback", 300, 10)]) is None
    with pytest.raises(RuntimeError, match="bench.slice"):
        program_spans.read(base_events()[1:])


def test_shares_read_zero_where_a_kind_is_absent():
    got = program_spans.shares(program_spans.read(base_events() + [ann("serve.prefill", 0, 400)]))
    assert got["prefill_idle_pct"] == pytest.approx(20.0)     # [0,100), [300,400)
    assert got["serve_idle_pct"] == pytest.approx(60.0)
    assert [got[q] for q in ("decode_idle_pct", "sync_idle_pct", "htod_idle_pct",
                             "copy_bound_pct")] == [0.0] * 4


def test_shares_partition_the_idle_share():
    sl = trace.read(served_events())
    got = program_spans.shares(program_spans.read(served_events()))
    idle = 100.0 * (1.0 - sl.busy_s / sl.window_s)
    assert got["prefill_idle_pct"] + got["decode_idle_pct"] + got["serve_idle_pct"] == \
        pytest.approx(idle)
    assert got["sync_idle_pct"] == pytest.approx(27.7)
    assert got["htod_idle_pct"] == pytest.approx(60.0)
    assert got["copy_bound_pct"] == pytest.approx(100 * 80 / 450)


def test_profiled_smoke_server(tmp_path):
    """A profiled smoke server on the CPU: the program's ranges are found,
    one a wave and one a decoding step, and with no device record the card
    reads idle throughout."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench import harness
    from bench.tests import smoke

    smoke.threads()
    cell = smoke.cell("olmoe.offline_longdoc")
    cfg = harness.model_config(cell.conf)
    plan = harness.plan_of(cfg, cell)
    server, _ = harness.build_server(cfg, cell, plan, 12, "cpu")
    cli = harness.Client(server, cell, 12, cfg.vocab_size, max(1, plan.b_a))
    cli.step()
    waves0, decode0 = len(server.report.admission_waves), server.report.decode_s
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.slice"):
            for _ in range(6):
                with record_function("bench.step"):
                    cli.step()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    sl, p = trace.read(events), program_spans.read(events)
    assert sl.busy_s == 0.0
    assert p.spans["serve.prefill"] == len(server.report.admission_waves) - waves0 > 0
    assert p.spans["serve.decode"] == p.spans["sync.token-readback"] == 6
    # each chunk's range holds the interval decode_s adds, and little more
    decode_s = server.report.decode_s - decode0
    assert decode_s <= p.decode_span_s + 1e-6 and p.decode_span_s - decode_s <= 6e-3
    assert sum(p.idle_in.values()) == pytest.approx(sl.window_s)
    assert p.idle_in["decode"] == pytest.approx(p.decode_span_s)
    assert p.idle_in["prefill"] > 0 and p.sync_idle == {}
