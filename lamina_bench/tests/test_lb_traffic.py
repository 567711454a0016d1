"""The traffic generator: determinism by seed, one set of lengths for
every seed, caps, means, residual first requests."""
import json

import numpy as np
import pytest

from _tiny import BENCH
from lamina_bench import traffic

MIXES = ["lamina-decode", "chat-azure"]


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    a, b = traffic.Stream(mix(name), 5, 1000), traffic.Stream(mix(name), 5,
                                                               1000)
    for _ in range(20):
        x, y = a.next(), b.next()
        assert (x.context, x.out_len, x.tokens, x.first_token, x.template) \
            == (y.context, y.out_len, y.tokens, y.first_token, y.template)
    assert a.first() == b.first()


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_work(name):
    """Lengths and their order are the mix's own, past the end of the set
    too; the seed draws only what the requests hold."""
    m = mix(name)
    n = m["set_size"]
    runs = []
    for seed in (1, 2**31 + 11):
        s = traffic.Stream(m, seed, 1000)
        firsts = [s.first() for _ in range(4)]
        rest = [s.next() for _ in range(n + 8)]
        runs.append(firsts + rest)
    lengths = [[(r.context, r.out_len) for r in run] for run in runs]
    assert lengths[0] == lengths[1]
    assert sorted(lengths[0][4:4 + n]) == sorted(
        zip(*[a.tolist() for a in traffic.length_set(m)]))
    assert [r.tokens for r in runs[0]] != [r.tokens for r in runs[1]]


@pytest.mark.parametrize("name", MIXES)
def test_caps_and_means(name):
    m = mix(name)
    prompts, outputs = traffic.length_set(m)
    assert prompts.max() <= m["prompt"]["max"]
    assert outputs.max() <= m["output"]["max"]
    assert prompts.min() >= m["prompt"]["min"]
    assert outputs.min() >= m["output"]["min"]
    # the draw before the caps has the mix's mean; the caps only lower it
    rng = np.random.default_rng(m["set_seed"])
    raw = traffic.lognormal_lengths(rng, m["prompt"]["mean"], m["set_size"],
                                    m["prompt"]["sigma"], m["prompt"]["min"])
    raw_out = traffic.lognormal_lengths(rng, m["output"]["mean"],
                                        m["set_size"], m["output"]["sigma"],
                                        m["output"]["min"])
    assert abs(raw.mean() / m["prompt"]["mean"] - 1) < 0.1
    assert abs(raw_out.mean() / m["output"]["mean"] - 1) < 0.1
    assert (prompts == np.minimum(raw, m["prompt"]["max"])).all()
    assert (outputs == np.minimum(raw_out, m["output"]["max"])).all()


def test_copy_matches_the_port_trace_arithmetic():
    from repro_torch.data import traces
    a = traces._lognormal_lengths(np.random.default_rng(3), 342.6, 500)
    b = traffic.lognormal_lengths(np.random.default_rng(3), 342.6, 500)
    assert (a == b).all()


@pytest.mark.parametrize("name", MIXES)
def test_first_requests_are_residual_lives(name):
    m = mix(name)
    s = traffic.Stream(m, 9, 1000)
    firsts = [s.first() for _ in range(300)]
    most = m["prompt"]["max"] + m["output"]["max"] - 1
    assert all(r.out_len >= 2 for r in firsts)
    assert all(r.context <= most for r in firsts)
    assert all(len(r.tokens) == r.context for r in firsts)
    # a residual life is shorter on average than a whole one
    _, outputs = traffic.length_set(m)
    assert np.mean([r.out_len for r in firsts]) < outputs.mean()
