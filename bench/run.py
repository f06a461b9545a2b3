"""Run one cell of the port's benchmark once, on this machine's cards.

    python3 bench/run.py --workload olmoe.offline_chat --seed 7 --seconds 40 --trace 0

From the root of a checkout of the repository.  The last line of standard
output is the run's JSON result (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, read from a traced slice
after the window); the numbers the check compared, each beside its limit,
are the last lines of standard error.  Without a CUDA card, with fewer
cards than the cell asks for, or where the program or the benchmark's files
are missing, it exits 1 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the benchmark's modules are imported as ``bench.*``: its own folder off the
# path, so that none of them shadows a module of the same name
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]


def fail(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card, and has no CPU result")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness, spec

    cell = spec.cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} found")
    try:
        import repro_torch
    except ImportError as err:
        fail(f"the program is missing ({err})")
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        fail(f"repro_torch comes from {repro_torch.__file__}, not this checkout")
    torch.cuda.set_device(0)
    out = harness.result(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        fail(f"modules that must not load were loaded: {bad}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(out.pop("memory_peak_bytes"))}
    if args.trace:
        if "busy_s" not in out:
            fail("the traced slice gave no device time")
        device["busy_s"] = out.pop("busy_s")
        device["window_s"] = out.pop("trace_window_s")
    checks = out.pop("checks")
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["notes"] = out["notes"]
    line["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))


if __name__ == "__main__":
    main()
