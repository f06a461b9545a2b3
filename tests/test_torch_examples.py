"""The port's examples (``examples/torch_*.py``): each ``main`` runs on the
CPU at a small size and keeps its asserts; without CUDA the default device
raises; the quickstart's planned strategy equals the reference planner's.

The examples run with one intra-op thread (restored afterwards): at these
sizes PyTorch's thread pool only adds contention beside other test
workers."""
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = {
    "quickstart": [],
    "offline_serve": ["--requests", "4", "--prompt-len", "8", "--decode-len", "4",
                      "--batch", "4"],
    "omega_split": [],
    "serve_online": ["--requests", "3", "--decode-len", "4"],
    "serve_prefix_cache": ["--requests", "3", "--prefix-len", "16", "--question-len", "4",
                           "--decode-len", "4", "--page-tokens", "8"],
    "serve_mesh": ["--requests", "4", "--prompt-len", "8", "--decode-len", "4"],
    "train_small": ["--smoke", "--steps", "3", "--log-every", "2", "--batch", "2",
                    "--seq", "16"],
}
# a line each example must print (its result, or its assert's subject)
EXPECT = {
    "quickstart": "engine generated (8, 12) tokens",
    "offline_serve": "decode tokens:      16",
    "omega_split": "planner-predicted decode throughput vs omega",
    "serve_online": "decode throughput:",
    "serve_prefix_cache": "tokens identical: True",
    "serve_mesh": "tokens identical to single-device serve: True (ranks agree: True)",
    "train_small": "final loss:",
}


def _load(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, one_thread, capsys, tmp_path):
    argv = EXAMPLES[name] + ["--device", "cpu"]
    if name == "train_small":
        argv += ["--checkpoint", str(tmp_path / "ckpt.npz")]
    _load(name).main(argv)
    out = capsys.readouterr().out
    assert EXPECT[name] in out, out


def test_examples_are_all_covered():
    assert {p.stem[len("torch_"):] for p in (ROOT / "examples").glob("torch_*.py")} == set(EXAMPLES)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_default_device_needs_cuda(name):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _load(name).main(EXAMPLES[name])


def test_quickstart_plan_equals_the_reference_planner():
    """The planned strategy for full Mixtral on the paper's C2 testbed at a
    768-token context: the same lines as ``examples/quickstart.py``'s."""
    from repro.configs import get_config as jget
    from repro.core import planner as jplanner
    from repro.core.hardware import A5000_C2 as JC2

    res = jplanner.search_decode(jget("mixtral-8x7b"), JC2, ctx=768)
    want = [
        "planned strategy for mixtral-8x7b",
        f"    {res.plan.describe()}",
        f"    predicted decode throughput: {res.estimate.throughput:.0f} tokens/s "
        f"({res.evaluated} configs searched)",
        "    critical path: " + " -> ".join(res.estimate.critical[:5]),
    ]
    assert _load("quickstart").plan_lines() == want
