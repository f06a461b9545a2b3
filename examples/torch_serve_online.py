"""Online serving through the request-lifecycle API of the PyTorch port.

Builds a ``Server`` (the facade over the module-batching engine), submits
an open-loop Poisson stream of mixed greedy/sampled requests, streams one
request's tokens through a callback, and prints per-request latency
metrics (TTFT / TPOT / queue wait) -- the online protocol the offline
``serve_dataset`` wrapper cannot measure.

    PYTHONPATH=src python examples/torch_serve_online.py [--rate 4.0] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.dag_builder import Plan
from repro_torch.data.datasets import DatasetSpec, synthetic_requests
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving import arrivals
from repro_torch.serving.scheduler import SamplingParams, ServeConfig, Server, StreamConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--decode-len", type=int, default=12)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, seed=0, device=dev)
    requests = synthetic_requests(
        DatasetSpec("online", args.requests, 24, args.decode_len),
        cfg.vocab_size,
        prompt_lens=[24, 11, 17],
        arrivals=arrivals.poisson(args.requests, args.rate, seed=0),
    )
    # mixed batch: odd requests sample, even requests stay greedy
    for i, r in enumerate(requests):
        if i % 2:
            r.sampling = SamplingParams(temperature=args.temperature,
                                        top_k=args.top_k, seed=i)

    server = Server(
        cfg, params, Plan(B=4, b_a=4, b_e=64, omega=0.0),
        serve=ServeConfig(scheduler="continuous", decode_len=args.decode_len),
        stream=StreamConfig(),
        device=dev,
    )
    handles = [
        server.submit(r, on_token=(
            (lambda h, tok: print(f"  request 0 token: {tok}")) if i == 0 else None
        ))
        for i, r in enumerate(requests)
    ]
    print(f"submitted {len(handles)} requests "
          f"(poisson @ {args.rate}/s, last due {requests[-1].arrival_s:.2f}s)")
    report = server.run()

    print(f"\n{'req':>3} {'arrive':>7} {'wait':>6} {'ttft':>6} "
          f"{'tpot_ms':>8} {'tokens':>6} {'policy':>9}")
    for r in report.request_results:
        policy = "sampled" if requests[r.index].sampling else "greedy"
        print(f"{r.index:>3} {r.arrival_s:>7.2f} {r.queue_wait_s:>6.2f} "
              f"{r.ttft_s:>6.2f} {r.tpot_s * 1e3:>8.1f} "
              f"{r.tokens.size:>6} {policy:>9}")
    print(f"\ndecode throughput: {report.decode_throughput:.1f} tok/s; "
          f"TTFT p50/p95 {report.ttft_percentile(50):.2f}/"
          f"{report.ttft_percentile(95):.2f}s; "
          f"occupancy {report.occupancy:.0%}")


if __name__ == "__main__":
    main()
