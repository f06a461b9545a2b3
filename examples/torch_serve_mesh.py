"""Expert-parallel + data-parallel serving on the PyTorch port.

The JAX example splits the host into 8 virtual XLA devices.  Here the
expert-parallel group is ``--ep`` rank processes joined by a gloo group
(``launch.mesh.spawn``), all on the one card (or the CPU): rank r holds
experts ``[r*E/ep, (r+1)*E/ep)`` and the MoE decode stage exchanges routed
copies by pipelined all-to-all; in each rank ``ReplicaServer`` fans one
arrival queue over ``--dp`` data-parallel replicas of that engine -- what
``python -m repro_torch.launch.serve --mesh DP,EP`` runs.

The run serves the same requests twice -- single-device and on the mesh --
and checks the generated tokens match token-for-token (distribution changes
WHERE experts run, never WHICH tokens come out).

    PYTHONPATH=src python examples/torch_serve_mesh.py [--dp 2] [--ep 2] [--device cpu]
"""
import argparse
import time
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.core.dag_builder import Plan
from repro_torch.data.datasets import DatasetSpec, synthetic_requests
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.launch.serve import mesh_rank


def rank_args(device: str, decode_len: int, dp: int, ep: int) -> argparse.Namespace:
    """The serve launcher's arguments that ``launch.serve.mesh_rank`` reads."""
    return argparse.Namespace(
        mesh=f"{dp},{ep}", device=device, seed=0, scheduler="static",
        decode_len=decode_len, expert_path="grouped", kv_page_tokens=0,
        device_kv_gb=None, prefix_cache=False, faults=None)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--dp", type=int, default=2,
                    help="data-parallel Server replicas")
    ap.add_argument("--ep", type=int, default=2,
                    help="expert-parallel ranks (shards num_experts)")
    ap.add_argument("--ep-chunks", type=int, default=2,
                    help="pipelined all-to-all chunks per decode step")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-len", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    spec = DatasetSpec("mesh-demo", args.requests, args.prompt_len, args.decode_len)
    requests = synthetic_requests(spec, cfg.vocab_size)
    plan = Plan(B=8, b_a=8, b_e=64, decode_chunk=4)

    base, _ = mesh_rank(0, 1, None, rank_args(args.device, args.decode_len, 1, 1), cfg,
                        plan, requests)

    mesh_plan = replace(plan, ep_chunks=args.ep_chunks)
    print(f"mesh: dp={args.dp} replicas x ep={args.ep} expert ranks "
          f"({cfg.num_experts // args.ep} experts/rank), "
          f"ep_chunks={args.ep_chunks}")
    margs = rank_args(args.device, args.decode_len, args.dp, args.ep)
    t0 = time.perf_counter()
    if args.ep > 1:
        outs = mesh.spawn(mesh_rank, args.ep, (margs, cfg, mesh_plan, requests))
    else:
        outs = [mesh_rank(0, 1, None, margs, cfg, mesh_plan, requests)]
    spawn_s = time.perf_counter() - t0
    rep = outs[0][0]

    same = all(
        (a.tokens == b.tokens).all()
        for a, b in zip(base.request_results, rep.request_results)
    )
    ranks_agree = all(
        (a.tokens == b.tokens).all()
        for o in outs[1:] for a, b in zip(rep.request_results, o[0].request_results)
    )
    print(f"tokens identical to single-device serve: {same} "
          f"(ranks agree: {ranks_agree})")
    print(f"decode throughput (this host): {rep.decode_throughput:.1f} tok/s "
          f"({spawn_s:.1f}s for the ranks, with their start and weights)")
    print(f"a2a exchanged: {rep.a2a_bytes / 1e9:.4f}GB over "
          f"{rep.collective_dispatches} collective dispatches")
    assert same and ranks_agree, "mesh serving must be token-identical"


if __name__ == "__main__":
    main()
