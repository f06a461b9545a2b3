"""Does a token's routing depend on the batch it comes in?  The f32 router
product, one plain ``x @ router`` against ``models.moe.router_logits``.

    python3 tools/router_invariance.py

Needs one CUDA card.  Part 1 takes OLMoE-1B-7B's router shape (D 2048, E
64) on seeded rows and asks, for each way of computing the product, whether
rows computed inside batches of other sizes and offsets (32..16000 rows) get
the bits they get inside one batch of 16384, and times it by CUDA events at
64, 5000 and 14000 rows (a decode tick at B 64, a prefill micro-batch of
serve's and of a long prompt).  Part 2 prefills ``chip_smoke.py``'s 64
serve requests on full-size OLMoE-1B-7B (bf16, seeded weights) in one wave
and in two waves of the even and the odd requests (two replicas' waves),
with the plain product patched in and with the port's, and compares each
request's first-token logits: the largest and median difference over the
row peak and the rows that are bit-identical.  Part 1 also holds the form
``router_logits`` takes under autograd (a router weight that requires grad)
to the served bits at every batch.  The last line is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def time_ms(fn, x, iters: int = 50) -> float:
    import torch

    for _ in range(3):
        fn(x)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn(x)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def products(dev) -> dict:
    import torch

    from repro_torch.models import moe

    g = torch.Generator(device=dev).manual_seed(0)
    D, E = 2048, 64
    x = torch.randn((16384, D), generator=g, device=dev).bfloat16()
    r = torch.randn((D, E), generator=g, device=dev) * D ** -0.5
    ways = {"plain": lambda z: z.float() @ r, "router_logits": lambda z: moe.router_logits(r, z)}
    out = {}
    spans = ((0, 32), (32, 64), (0, 64), (100, 5100), (0, 5000), (7, 1007), (0, 16000),
             (3000, 14000))
    for name, fn in ways.items():
        ref = fn(x)
        out[name] = {"invariant": all(torch.equal(ref[lo:hi], fn(x[lo:hi])) for lo, hi in spans),
                     **{f"ms_rows_{m}": time_ms(fn, x[:m]) for m in (64, 5000, 14000)}}
    # the form autograd records (inputs that require grad): the served bits
    rg = r.clone().requires_grad_(True)
    served = moe.router_logits(r, x)
    out["router_logits"]["differentiable_bit_identical"] = all(
        torch.equal(moe.router_logits(rg, x[lo:hi]).detach(), served[lo:hi])
        for lo, hi in spans)
    return out


def waves(dev) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.core.engine import ModuleBatchingEngine
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.server import pad_requests

    cfg, plan, lens, dec = cs.serve_setup(cs.short_lengths(), 32)
    reqs = cs.serve_requests(cfg, lens, dec)
    params = M.init_params(cfg, seed=0, device=dev)
    n = len(reqs)

    def first_logits(groups):
        eng = ModuleBatchingEngine(cfg, params, plan, max_seq=max(lens) + dec, device=dev)
        eng.init_cache(n)
        out = torch.empty((n, cfg.vocab_size))
        for rows in groups:
            toks, lengths = pad_requests([reqs[i] for i in rows])
            out[rows] = eng.prefill_slots(toks, list(range(len(rows))),
                                          lengths=lengths).float().cpu()
        return out

    port = moe.router_logits
    res = {}
    try:
        for name, fn in (("plain", lambda w, z: z.float() @ w), ("router_logits", port)):
            moe.router_logits = fn
            one = first_logits([list(range(n))])
            two = first_logits([list(range(0, n, 2)), list(range(1, n, 2))])
            rel = (two - one).abs().amax(-1) / one.abs().amax(-1)
            res[name] = {"rel_err_max": float(rel.max()), "rel_err_median": float(rel.median()),
                         "bit_identical_rows": int((rel == 0).sum()), "rows": n}
    finally:
        moe.router_logits = port
    return res


def main() -> int:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("router_invariance: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"products": products(dev)}), flush=True)
    print(json.dumps({"waves": waves(dev)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
