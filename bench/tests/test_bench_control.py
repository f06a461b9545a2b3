"""The control: the reference computed with float8 operands (the precision
below the configurations' bfloat16) in the program's place must come out not
correct, where the program's own runs come out correct.

On the card (``cuda``): at each cell's own size, on three seeds, the
control's readings fail one of the cell's limits and the program's pass all.
Each seed's readings print as one JSON line (``pytest -s``), with the
bfloat16 witness's beside them: the reference with bfloat16 operands, whose
share of tokens off the float32 reference's first shows how far the
configuration's own precision moves the tokens.  On the CPU, at smoke size,
the control reads well above the program on the same served tokens."""
import json
import time

import numpy as np
import pytest
import torch

from bench import harness, spec
from bench.reference import CONTROL, WITNESS
from bench.tests import smoke

CELLS = [w["name"] for w in spec.manifest()["workloads"]]


def _failed(numbers, limits):
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


@pytest.mark.parametrize("name", ["olmoe.offline_chat", "mixtral.offline_streamed"])
def test_control_reads_above_the_program_at_smoke_size(name):
    smoke.threads()
    prog, ctrl = [], []
    for seed in range(3):
        c = smoke.cell(name)
        c.pinned["sample"] = 8
        got = harness.serve_window(c, seed, 1.0, False, "cpu", time.perf_counter())
        v, ids, short = harness.check(c, seed, got, "cpu", (CONTROL,))
        assert ids and not short
        prog.append(v.numbers()["mean_logit_gap"])
        ctrl.append(v.numbers(CONTROL)["mean_logit_gap"])
    assert np.mean(ctrl) > 3 * np.mean(prog), (prog, ctrl)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    c = spec.cell(name)
    limits = c.pinned["limits"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        got = harness.serve_window(c, seed, 20.0, False, "cuda", time.perf_counter())
        v, ids, short = harness.check(c, seed, got, "cuda", (CONTROL, WITNESS))
        print(json.dumps({"cell": name, "seed": seed, "tokens": v.tokens if ids else 0,
                          "unfinished": len(short), "program": v.numbers() if ids else None,
                          **({low: v.numbers(low) for low in (CONTROL, WITNESS)} if ids else {})}))
        assert ids and not short
        assert not _failed(v.numbers(), limits), v.numbers()
        assert _failed(v.numbers(CONTROL), limits), v.numbers(CONTROL)
        del got
        torch.cuda.empty_cache()
