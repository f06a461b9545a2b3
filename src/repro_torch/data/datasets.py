"""Data pipeline: synthetic token streams shaped like the paper's benchmarks.

The paper evaluates on MMLU / GSM8K / ChatBot-Arena / LongBench (Table 4,
Table 8).  Offline, we reproduce their *workload shapes* (sequence counts,
prompt and decode lengths) with deterministic synthetic token data, which is
sufficient for every throughput/scheduling claim (the systems are
content-agnostic).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_sequences: int
    prompt_len: int
    decode_len: int


# Paper Table 4 workloads
DATASETS = {
    "mmlu": DatasetSpec("mmlu", 116_000, 512, 1),
    "gsm8k": DatasetSpec("gsm8k", 8_500, 512, 256),
    "chatbot-arena": DatasetSpec("chatbot-arena", 36_000, 256, 512),
    # LongBench configurations of Table 8
    "longbench-16k-8k": DatasetSpec("longbench-16k-8k", 50, 16_384, 8_192),
    "longbench-8k-16k": DatasetSpec("longbench-8k-16k", 50, 8_192, 16_384),
    "longbench-8k-4k": DatasetSpec("longbench-8k-4k", 100, 8_192, 4_096),
    "longbench-4k-2k": DatasetSpec("longbench-4k-2k", 200, 4_096, 2_048),
}


def synthetic_requests(
    spec: DatasetSpec,
    vocab_size: int,
    limit: int | None = None,
    seed: int = 0,
    prompt_lens: Sequence[int] | None = None,
    decode_lens: Sequence[int] | None = None,
    arrivals: Sequence[float] | None = None,
    sampling=None,
) -> List["Request"]:
    """Deterministic synthetic requests shaped like ``spec``.

    ``prompt_lens`` / ``decode_lens`` override the spec's uniform lengths
    with a cycled mixed-length workload (ragged prompts / in-flight decode
    lengths) — the shape the continuous scheduler exists for.

    ``arrivals`` stamps per-request ``arrival_s`` offsets (an open-loop
    online workload — see ``repro_torch.serving.arrivals``; must cover every
    request, it is not cycled).  ``sampling`` attaches one
    ``SamplingParams`` decoding policy to every request (None = greedy).
    """
    from repro_torch.serving.arrivals import assign
    from repro_torch.serving.server import Request

    rng = np.random.default_rng(seed)
    n = min(spec.num_sequences, limit or spec.num_sequences)
    requests = [
        Request(
            prompt=rng.integers(
                0, vocab_size,
                prompt_lens[i % len(prompt_lens)] if prompt_lens
                else spec.prompt_len,
                dtype=np.int32,
            ),
            decode_len=(
                decode_lens[i % len(decode_lens)] if decode_lens
                else spec.decode_len
            ),
            sampling=sampling,
        )
        for i in range(n)
    ]
    if arrivals is not None:
        assign(requests, arrivals)
    return requests


def synthetic_batches(
    vocab_size: int,
    batch: int,
    seq: int,
    seed: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Infinite stream of (tokens, labels) for language-model training."""
    rng = np.random.default_rng(seed)
    while True:
        # mildly structured stream (zipfian-ish) so the loss can decrease
        base = rng.zipf(1.5, size=(batch, seq + 1)) % vocab_size
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        yield tokens, labels
