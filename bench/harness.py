"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the check against the reference, the result line.

The program under test is ``repro_torch`` (``src/repro_torch``): its
``Server`` is driven through ``submit`` and ``step``, over a ``ParamStore``
built from the benchmark's seeded weights, with a plan that
``launch.serve.build_plan`` chooses from the cell's pinned inputs.  The
harness reads the program's counters (``ServeReport``) and its kernels'
names in the trace, and nothing else of it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import arith
from bench import reference
from bench import traffic as T
from bench import weights as Wt
from bench.spec import BENCH, Cell, Sizes
from bench.trace import Slice, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "chip_smoke", "benchmarks")
_REPORT = ("prefill_s", "decode_s", "prefill_tokens", "decode_slot_steps",
           "wasted_slot_steps", "weight_htod_bytes", "prefetch_wait_s")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that must never load here,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# The program's configuration, plan, weights and server
# ---------------------------------------------------------------------------
def model_config(conf: Dict):
    """The program's ``ModelConfig`` of a configuration file: its registered
    architecture with every size the file gives."""
    from repro_torch.configs import get_config

    sz = Sizes.of(conf)
    return dataclasses.replace(
        get_config(conf["port_config"]), num_layers=sz.n_layers, d_model=sz.d_model,
        num_heads=sz.n_heads, num_kv_heads=sz.n_kv_heads, head_dim=sz.head_dim,
        num_experts=sz.n_experts, experts_per_token=sz.top_k, moe_d_ff=sz.expert_ff,
        vocab_size=sz.vocab, rope_theta=sz.rope_theta, norm_eps=sz.norm_eps,
        dtype=conf["torch_dtype"], tie_embeddings=bool(conf["tie_word_embeddings"]),
        sliding_window=int(conf.get("sliding_window") or 0))


def hardware(pinned: Dict):
    """The planner's hardware profile, every field pinned in the cell's file
    (none read from the machine)."""
    from repro_torch.core.hardware import HardwareProfile

    return HardwareProfile(**pinned["profile"])


def plan_of(cfg, cell: Cell):
    """The program's plan from the pinned inputs: ``build_plan`` chooses
    b_a and the decode chunk; B, b_e, omega and the residency are the
    cell's."""
    from repro_torch.launch.serve import build_plan

    pin, mix = cell.pinned, cell.mix
    B = int(pin["B"])
    args = SimpleNamespace(
        prompt_lens=None, decode_len=T.max_len(mix["decode_len"]),
        prompt_len=T.max_seq(mix) - T.max_len(mix["decode_len"]),
        scheduler=pin["scheduler"], batch=B, requests=B, omega=float(pin["omega"]),
        b_e=int(pin["b_e"]), stream_weights=bool(pin.get("streamed_stacks")),
        resident_gb=None, predict_topk=None, mesh=None, ep_chunks=None)
    plan = build_plan(cfg, hardware(pin), args)
    return dataclasses.replace(plan, predict_topk=0)


def resident_bytes(cell: Cell) -> Optional[float]:
    """The resident budget that leaves the cell's last ``streamed_stacks``
    expert stacks in host memory (None: every weight on the card)."""
    n = int(cell.pinned.get("streamed_stacks", 0))
    if not n:
        return None
    sz = cell.sizes
    return arith.model_bytes(sz) - (n - 0.5) * arith.stack_bytes(sz)


def build_server(cfg, cell: Cell, plan, seed: int, device):
    from repro_torch.serving.server import ServeConfig, Server
    from repro_torch.serving.weights import ParamStore

    store = ParamStore(cfg, Wt.params(cell.sizes, seed, device, getattr(torch, cfg.dtype)),
                       resident_bytes=resident_bytes(cell), prefetch=True,
                       predict_topk=0, device=device)
    want = int(cell.pinned.get("streamed_stacks", 0))
    got = sum(not r for r in store.residency.ffn_resident)
    if got != want or not all(store.residency.mixer_resident):
        raise RuntimeError(f"residency streams {got} expert stacks (and "
                           f"{store.residency.n_streamed() - got} mixers), the cell pins {want}")
    pin = cell.pinned
    serve = ServeConfig(
        scheduler=pin["scheduler"], decode_len=T.max_len(cell.mix["decode_len"]),
        max_seq=T.max_seq(cell.mix), max_batch=int(pin["B"]), plan=plan,
        hw=hardware(pin) if pin["scheduler"] == "continuous" else None)
    return Server(cfg, None, plan, serve=serve, store=store, device=device), store


# ---------------------------------------------------------------------------
# The work a stretch of the run did, as the traffic's shapes give it
# ---------------------------------------------------------------------------
@dataclass
class WorkLog:
    """Tokens served in a stretch, and the shapes of the work behind them:
    ``prefill`` a list of waves, each a list of micro-batches of prompt
    lengths; ``decode`` a list of steps, each (ticks, keys seen by each
    decode token)."""

    tokens: int = 0
    prefill: List[List[List[int]]] = field(default_factory=list)
    decode: List[tuple] = field(default_factory=list)


class Client:
    """The closed-loop client: drives the server over the cell's traffic
    and logs the work.  Every token goes through ``on_token``; ``step``
    runs one server step, keeps the queue full and files the step's work in
    the log that is open."""

    def __init__(self, server, cell: Cell, seed: int, vocab: int, b_a: int) -> None:
        self.server, self.cell = server, cell
        self.stream = T.Stream(cell.mix, seed, vocab)
        self.depth = int(cell.pinned["B"])
        self.b_a = b_a
        self.handles: List = []
        self._queued: deque = deque()
        self.finished: List[int] = []
        self.log: Optional[WorkLog] = None
        self._step_keys: Dict[int, List[int]] = {}
        self._waves_seen = 0
        self.tracer: Optional[Tracer] = None

    def on_token(self, h, tok) -> None:
        j = len(h.tokens) - 1
        if j >= 1:
            self._step_keys.setdefault(h.index, []).append(len(h.prompt) + j)
        if self.log is not None:
            self.log.tokens += 1
        if len(h.tokens) >= h.decode_len:
            self.finished.append(h.index)

    def top_up(self) -> None:
        from repro_torch.serving.server import Request

        while self._queued and self._queued[0].status != "queued":
            self._queued.popleft()
        need = self.depth - len(self._queued)
        for s in self.stream.take(need) if need > 0 else []:
            h = self.server.submit(Request(prompt=s.prompt, decode_len=s.decode_len),
                                   on_token=self.on_token)
            assert h.index == s.index
            self.handles.append(h)
            self._queued.append(h)

    def step(self) -> None:
        self.top_up()
        self._step_keys = {}
        if self.tracer is not None:
            with self.tracer.step():
                self.server.step()
        else:
            self.server.step()
        waves = self.server.report.admission_waves
        new, self._waves_seen = waves[self._waves_seen:], len(waves)
        if self.log is None:
            return
        for _, idx in new:
            lens = [len(self.handles[i].prompt) for i in idx]
            self.log.prefill.append([lens[lo:lo + self.b_a]
                                     for lo in range(0, len(lens), self.b_a)])
        if self._step_keys:
            ticks = max(len(v) for v in self._step_keys.values())
            self.log.decode.append((ticks, [k for v in self._step_keys.values() for k in v]))

    def running(self) -> bool:
        return any(h.status == "running" for h in self.handles[-2 * self.depth - 1024:])

    def counters(self) -> Dict[str, float]:
        rep = self.server.finalize()
        return {k: float(getattr(rep, k)) for k in _REPORT}


# ---------------------------------------------------------------------------
# Per-layer readers
# ---------------------------------------------------------------------------
@dataclass
class Readings:
    """What a reader may read: the cell, the window's counters (deltas) and
    work, the traced slice and its work."""

    cell: Cell
    window_s: float
    counters: Dict[str, float]
    window: WorkLog
    slice: Optional[Slice] = None
    slice_log: Optional[WorkLog] = None


def base(name: str) -> str:
    """The quantity a metric's name gives, before its cell's suffix
    (``gen_tok_s.chat`` is ``gen_tok_s``): one reader serves every cell."""
    return name.split(".")[0]


def reader(name: str):
    path = BENCH / "metrics" / f"{base(name)}.py"
    spec = importlib.util.spec_from_file_location(f"bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------
def host_probe_ms() -> float:
    """Milliseconds a fixed Python loop takes: the host's speed beside a
    window, for the notes (the host-bound cells' rates follow it)."""
    t = time.perf_counter()
    sum(i * i for i in range(300_000))
    return 1e3 * (time.perf_counter() - t)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve_window(cell: Cell, seed: int, seconds: float, trace: bool, device,
                 t_start: float) -> Dict:
    """Set up, warm up, measure ``seconds``, optionally trace a slice; then
    free the program and return what the check and the result line need."""
    cfg = model_config(cell.conf)
    plan = plan_of(cfg, cell)
    server, store = build_server(cfg, cell, plan, seed, device)
    cli = Client(server, cell, seed, cfg.vocab_size, max(1, plan.b_a))
    warm = int(cell.pinned["warmup_finished"])
    while len(cli.finished) < warm:
        cli.step()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    before = cli.counters()
    host0 = host_probe_ms()
    done0 = len(cli.finished)
    cli.log = WorkLog()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        cli.step()
    t1 = time.perf_counter()
    window, cli.log = cli.log, None
    window_done = cli.finished[done0:]
    host1 = host_probe_ms()
    after = cli.counters()
    out = {"setup_s": setup_s, "window_s": t1 - t0, "window": window,
           "counters": {k: after[k] - before[k] for k in _REPORT},
           "done": window_done, "plan": plan, "slice": None, "slice_log": None,
           "host_probe_ms": [host0, host1]}
    if trace:
        out["slice"], out["slice_log"] = traced_slice(cli, cell)
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda" else 0)
    out["prompts"] = {i: cli.handles[i].prompt for i in window_done}
    out["served"] = {i: np.asarray(cli.handles[i].tokens, np.int64) for i in window_done}
    out["decode_len"] = {i: cli.handles[i].decode_len for i in window_done}
    del cli, server, store
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def traced_slice(cli: Client, cell: Cell):
    """Trace a slice after the window: the cell's ``trace_seconds`` of steps
    (under the static scheduler from a wave's admission, so that the slice
    holds its prefill), or without them one whole static wave.  A slice
    whose trace lost device records is traced again (three tries)."""
    static = cell.pinned["scheduler"] == "static"
    secs = cell.pinned.get("trace_seconds")
    sl = log = None
    for _ in range(3):
        if static:
            while cli.running():
                cli.step()
        cli.tracer = Tracer()
        cli.log = WorkLog()
        with cli.tracer.slice():
            t0 = time.perf_counter()
            cli.step()
            while (time.perf_counter() - t0 < float(secs)) if secs else cli.running():
                cli.step()
        sl, log, cli.tracer, cli.log = cli.tracer.result, cli.log, None, None
        if sl.unmatched == 0:
            break
        print(f"trace: {sl.unmatched} launches without a device record; tracing again",
              file=sys.stderr)
    return sl, log


def check(cell: Cell, seed: int, got: Dict, device, lower=()):
    """Compare the sampled requests' served tokens with the reference, and
    read the ``lower`` precisions beside it (no verdict where the window
    finished no request)."""
    ids = sample_ids(cell, seed, got)
    if not ids:
        return None, ids, []
    prompts = [got["prompts"][i] for i in ids]
    served = [got["served"][i] for i in ids]
    short = [i for i in ids if len(got["served"][i]) != got["decode_len"][i]]
    v = reference.judge(cell.sizes, seed, prompts, served, device, lower)
    return v, ids, short


def sample_ids(cell: Cell, seed: int, got: Dict) -> List[int]:
    done = got["done"]
    n = int(cell.pinned.get("sample", 8))
    if not done:
        return []
    longest = max(done, key=lambda i: len(got["prompts"][i]) + len(got["served"][i]))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x5A4D])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(k)] for k in pick]


def result(cell: Cell, seed: int, seconds: float, trace: bool, device,
           t_start: float) -> Dict:
    """One run: the contract's result object (without the device fields)."""
    got = serve_window(cell, seed, seconds, trace, device, t_start)
    t_ref = time.perf_counter()
    v, ids, short = check(cell, seed, got, device)
    ref_s = time.perf_counter() - t_ref
    read = v.numbers() if ids else {}
    checks = {k: {"value": read.get(k), "limit": float(lim)}
              for k, lim in cell.pinned["limits"].items()}
    checks["unfinished"] = {"value": len(short), "limit": 0}
    correct = bool(ids) and all(c["value"] is not None and c["value"] <= c["limit"]
                                for c in checks.values())
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics: Dict[str, Dict] = {}
    if not trace:
        vals = {"setup_s": got["setup_s"],
                "gen_tok_s": got["window"].tokens / got["window_s"]}
        for m in cell.end_to_end:
            if base(m["name"]) in vals:
                metrics[m["name"]] = {"value": vals[base(m["name"])], "unit": units[m["name"]]}
    else:
        r = Readings(cell=cell, window_s=got["window_s"], counters=got["counters"],
                     window=got["window"], slice=got["slice"], slice_log=got["slice_log"])
        for m in cell.per_layer:
            val = reader(m["name"])(r)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(got["done"]), "failed": len(short),
           "metrics": metrics, "memory_peak_bytes": got["memory_peak_bytes"],
           "checks": checks,
           "notes": {"window_s": got["window_s"], "tokens": got["window"].tokens,
                     "compared_tokens": v.tokens if ids else 0,
                     "reference_agree": v.agree if ids else 0, "read": read,
                     "reference_s": ref_s, "sampled": ids,
                     "plan": {"B": got["plan"].B, "b_a": got["plan"].b_a,
                              "b_e": got["plan"].b_e, "T": got["plan"].decode_chunk},
                     "counters": got["counters"], "host_probe_ms": got["host_probe_ms"],
                     "ticks": sum(t for t, _ in got["window"].decode)}}
    if trace and got["slice"] is not None:
        out["busy_s"], out["trace_window_s"] = got["slice"].busy_s, got["slice"].window_s
        out["breakdown"] = got["slice"].breakdown()
    return out
