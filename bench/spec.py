"""The benchmark's manifest and the files it names, found by name.

``BENCHMARK.json`` at the checkout's root lists the cells (workloads), the
configurations and the metrics.  Everything that belongs to one of them
sits in a file of its own beside this module:

* ``configs/<config>.json`` -- a model configuration as it is run, under
  the published config's keys;
* ``traffic/<traffic>.json`` -- a traffic mix, read by ``traffic.py``;
* ``workloads/<cell>.json`` -- the cell's pinned plan inputs and its limits;
* ``metrics/<metric>.py`` -- a per-layer metric's reader.

This module imports neither the program nor JAX.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> Dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


@dataclass(frozen=True)
class Sizes:
    """A decoder-only attention + sparse-MoE model's sizes, normalised from
    a configuration file's published keys."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_experts: int
    top_k: int
    expert_ff: int
    vocab: int
    rope_theta: float
    norm_eps: float

    @classmethod
    def of(cls, conf: Dict) -> "Sizes":
        d, h = conf["hidden_size"], conf["num_attention_heads"]
        return cls(
            n_layers=conf["num_hidden_layers"], d_model=d, n_heads=h,
            n_kv_heads=conf["num_key_value_heads"],
            head_dim=conf.get("head_dim") or d // h,
            n_experts=conf.get("num_experts") or conf["num_local_experts"],
            top_k=conf["num_experts_per_tok"],
            expert_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
            rope_theta=float(conf["rope_theta"]), norm_eps=float(conf["rms_norm_eps"]))


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads``: its configuration, traffic and pinned
    plan, and the metrics it reports."""

    name: str
    config: str
    traffic: str
    chips: int
    conf: Dict
    sizes: Sizes
    mix: Dict
    pinned: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, man: Optional[Dict] = None) -> Cell:
    man = man if man is not None else manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(known: {[w['name'] for w in man['workloads']]})")
    conf = read_json("configs", entry["config"])
    return Cell(name=name, config=entry["config"], traffic=entry["traffic"],
                chips=int(entry["chips"]), conf=conf, sizes=Sizes.of(conf),
                mix=read_json("traffic", entry["traffic"]),
                pinned=read_json("workloads", name),
                end_to_end=[m for m in man["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in man["per_layer"] if _reports(m, name)])
