"""The traffic generator: seeded, and the same work for every seed."""
import numpy as np
import pytest

from bench import spec
from bench import traffic as T

MIXES = ["offline_chat", "offline_streamed", "offline_longdoc"]
BIG = 2**33 + 12345          # seeds above 32 bits


def _lens(specs):
    return [len(s.prompt) for s in specs], [s.decode_len for s in specs]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    m = spec.read_json("traffic", mix)
    a = T.Stream(m, BIG, 50304).take(300)
    b = T.Stream(m, BIG, 50304).take(300)
    assert _lens(a) == _lens(b)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_the_sizes_of_a_deck(mix):
    m = spec.read_json("traffic", mix)
    n = int(m["deck"])
    a, b = T.Stream(m, 1, 512).take(n), T.Stream(m, BIG, 512).take(n)
    assert sorted(_lens(a)[0]) == sorted(_lens(b)[0])
    assert sorted(_lens(a)[1]) == sorted(_lens(b)[1])
    assert _lens(a) != _lens(b)                    # another order
    lo, hi = m["prompt_len"].get("lo", 0), T.max_len(m["prompt_len"])
    assert lo <= min(_lens(a)[0]) and max(_lens(a)[0]) <= hi
    assert max(len(s.prompt) + s.decode_len for s in a) <= T.max_seq(m)
    assert all(0 <= s.prompt.min() and s.prompt.max() < 512 for s in a)


def test_quantiles_of_each_distribution():
    assert T.quantiles({"dist": "const", "value": 16}, 4).tolist() == [16] * 4
    assert T.quantiles({"dist": "uniform", "lo": 32, "hi": 35}, 4).tolist() == [32, 33, 34, 35]
    q = T.quantiles({"dist": "loguniform", "lo": 64, "hi": 1024}, 2)
    assert q.tolist() == [128, 512]
    mean = T.quantiles({"dist": "loguniform", "lo": 64, "hi": 1024}, 4096).mean()
    assert abs(mean - 960 / np.log(16)) < 1


def test_only_closed_loop_mixes_are_generated():
    m = {"deck": 10, "prompt_len": {"dist": "const", "value": 5},
         "decode_len": {"dist": "const", "value": 3}}
    assert {len(x.prompt) for x in T.Stream(m, 3, 100).take(40)} == {5}
    with pytest.raises(ValueError):
        T.Stream(dict(m, loop="open", rate_per_s=5.0), 3, 100)
