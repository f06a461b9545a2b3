"""End-to-end offline inference on the PyTorch port (the paper's workload,
Table 4).

Serves a synthetic GSM8K-shaped dataset through the module-batching engine
with a fixed strategy, reporting completion time and throughput.

    PYTHONPATH=src python examples/torch_offline_serve.py [--requests 24] [--device cpu]
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.core.dag_builder import Plan
from repro_torch.data.datasets import DatasetSpec, synthetic_requests
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serving.scheduler import serve_dataset


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, seed=0, device=dev)
    spec = DatasetSpec("gsm8k-shaped", args.requests, args.prompt_len, args.decode_len)
    requests = synthetic_requests(spec, cfg.vocab_size)
    plan = Plan(B=args.batch, b_a=4, b_e=128, omega=0.0)
    print(f"serving {len(requests)} requests of {args.prompt_len}+"
          f"{args.decode_len} tokens on {cfg.name} with {plan.describe()}")
    report = serve_dataset(cfg, params, requests, plan, args.decode_len, device=dev)
    print(f"batches:            {len(report.results)}")
    print(f"total time:         {report.total_s:.2f}s")
    print(f"decode tokens:      {report.decode_tokens}")
    print(f"decode throughput:  {report.decode_throughput:.1f} tokens/s")


if __name__ == "__main__":
    main()
