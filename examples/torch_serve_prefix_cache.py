"""Prefix-cache serving on the PyTorch port: shared prompt prefixes admitted
without their prefill.

A few-shot / system-prompt workload: every request carries the same long
instruction prefix followed by a short question.  Served twice through the
paged KV cache -- cold (prefix cache off) and with the ``PrefixStore`` on
-- to show hits skipping the shared span's prefill while producing
identical tokens.

The JAX example counts jit dispatches (``repro.core.engine.dispatch_count``),
which the port has no counterpart of.  This one reads the port's own
counters instead: the prefill token-positions the server computed
(``ServeReport.prefill_tokens``, the suffix only for a hit) and the
kernels' launches (``kernels.build.launch_counts``, on the card; a CPU run
launches none).

    PYTHONPATH=src python examples/torch_serve_prefix_cache.py [--requests 12] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.dag_builder import Plan
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.models import model as M
from repro_torch.serving.scheduler import Request, ServeConfig, Server


def serve(cfg, params, requests, plan, decode_len: int, max_seq: int, page_tokens: int,
          prefix_cache: bool, device):
    """The requests served to completion; returns (report, kernel launches)."""
    server = Server(cfg, params, plan,
                    serve=ServeConfig(decode_len=decode_len, max_seq=max_seq,
                                      kv_page_tokens=page_tokens, prefix_cache=prefix_cache),
                    device=device)
    for r in requests:
        server.submit(r)
    before = sum(build.launch_counts().values())
    report = server.run()
    return report, sum(build.launch_counts().values()) - before


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b",
                    help="must be all-attention without a sliding window "
                         "(prefixes are not transplantable otherwise)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--prefix-len", type=int, default=48)
    ap.add_argument("--question-len", type=int, default=8)
    ap.add_argument("--decode-len", type=int, default=16)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    system_prompt = [int(t) for t in rng.integers(5, cfg.vocab_size - 5, args.prefix_len)]

    def requests():
        return [
            Request(prompt=np.asarray(system_prompt + [
                int(t) for t in rng.integers(5, cfg.vocab_size - 5, args.question_len)
            ], dtype=np.int32), decode_len=args.decode_len)
            for _ in range(args.requests)
        ]
    rng = np.random.default_rng(1)          # same questions for both runs
    cold_reqs = requests()
    rng = np.random.default_rng(1)
    warm_reqs = requests()

    plan = Plan(B=4, b_a=4, b_e=64, omega=0.0)
    max_seq = args.prefix_len + args.question_len + args.decode_len
    print(f"{len(cold_reqs)} requests sharing a {args.prefix_len}-token "
          f"prefix on {cfg.name}, pages of {args.page_tokens} tokens")

    cold, cold_launches = serve(cfg, params, cold_reqs, plan, args.decode_len, max_seq,
                                args.page_tokens, False, dev)
    warm, warm_launches = serve(cfg, params, warm_reqs, plan, args.decode_len, max_seq,
                                args.page_tokens, True, dev)

    same = all(
        np.array_equal(a.tokens, b.tokens)
        for a, b in zip(cold.request_results, warm.request_results)
    )
    print(f"cold:  {cold.total_s:.2f}s, {cold.prefill_tokens} prefill tokens, "
          f"{cold_launches} kernel launches")
    print(f"warm:  {warm.total_s:.2f}s, {warm.prefill_tokens} prefill tokens, "
          f"{warm_launches} kernel launches, "
          f"{warm.prefix_hits} hits / "
          f"{warm.prefix_hits + warm.prefix_misses} lookups "
          f"(hit rate {warm.prefix_hit_rate:.0%})")
    print(f"tokens identical: {same}")
    assert same


if __name__ == "__main__":
    main()
