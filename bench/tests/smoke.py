"""Smoke-size copies of the benchmark's cells: every width cut, the traffic
short, so that the harness runs on the CPU in seconds."""
import dataclasses

import torch

from bench import spec

SMOKE = dict(hidden_size=256, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=64, vocab_size=512)


def conf(name: str, dtype: str = "bfloat16", **kw) -> dict:
    c = dict(spec.read_json("configs", name), **SMOKE, torch_dtype=dtype)
    c["num_experts" if "num_experts" in c else "num_local_experts"] = 4
    c["num_experts_per_tok"] = 2
    c.update(kw)
    return c


def cell(name: str, dtype: str = "bfloat16", **pin) -> spec.Cell:
    c = spec.cell(name)
    cf = conf(c.config, dtype)
    mix = dict(c.mix, prompt_len={"dist": "loguniform", "lo": 8, "hi": 40},
               decode_len={"dist": "uniform", "lo": 4, "hi": 12})
    # a host of 10 MB keeps the planner's batch search as short as the model
    pinned = dict(c.pinned, B=4, b_e=4, warmup_finished=4, sample=3,
                  profile=dict(c.pinned["profile"], host_mem_bytes=1e7),
                  streamed_stacks=min(1, int(c.pinned.get("streamed_stacks", 0))), **pin)
    return dataclasses.replace(c, conf=cf, sizes=spec.Sizes.of(cf), mix=mix, pinned=pinned)


def threads():
    torch.set_num_threads(2)
