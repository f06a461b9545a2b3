"""The frozen reference against the program's CPU path, on the smoke
configurations in float32: the same weights drawn from the seed, the
same logits."""
import numpy as np
import pytest
import torch

from bench import harness, reference, spec
from bench import weights as W
from bench.tests import smoke


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_reference_logits_match_the_program_f32(name):
    from repro_torch.models import model as M

    smoke.threads()
    conf = smoke.conf(name, "float32")
    sz, seed = spec.Sizes.of(conf), 2**32 + 77
    cfg = harness.model_config(conf)
    params = {"layers": [_f32(W.layer(sz, seed, i, "cpu")) for i in range(sz.n_layers)],
              **_f32(W.base(sz, seed, "cpu"))}
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, sz.vocab, n) for n in (19, 33)]
    S = max(len(s) for s in seqs)
    toks = np.zeros((2, S), np.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    with torch.no_grad():
        got = M.forward(cfg, params, torch.from_numpy(toks), differentiable=False,
                        lengths=torch.tensor([len(s) for s in seqs]))[0]
    ref = reference.logits(sz, seed, seqs, [np.arange(len(s)) for s in seqs], "cpu")[0]
    for i, s in enumerate(seqs):
        r = ref[i]
        err = (got[i, :len(s)].float() - r).abs().max().item()
        assert err <= 1e-4 * r.abs().max().item(), err


def test_rope_theta_is_the_configurations():
    assert harness.model_config(spec.read_json("configs", "mixtral-8x7b")).rope_theta == 1e6
    assert harness.model_config(spec.read_json("configs", "olmoe-1b-7b")).rope_theta == 1e4


def test_control_rounds_to_float8():
    t = torch.linspace(-3, 3, 1001).reshape(7, 143)
    q = reference.q8(t, -1)
    assert 0 < (q - t).abs().max() <= 0.07 * t.abs().max()
    assert torch.equal(reference.q8(q, -1), q)


def test_witness_rounds_to_bfloat16():
    t = torch.linspace(-3, 3, 1001).reshape(7, 143)
    b = reference.LOWER[reference.WITNESS](t, -1)
    assert b.dtype == torch.float32 and torch.equal(b, t.to(torch.bfloat16).float())
    assert 0 < (b - t).abs().max() <= 2**-8 * t.abs().max()
