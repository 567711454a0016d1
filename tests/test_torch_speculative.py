"""Greedy-exact speculative decoding (``serving/speculative.py``) on the
port, on the CPU: the reference's two tests of it
(``tests/test_extensions.py``) ported, and the port's tokens and
``SpecStats`` equal to the JAX package's for the same weights (crossed
over with ``params_from_jax``), prompt and k. Greedy choices are argmaxes
of fp32 logits that agree with the reference's to ~1e-5; the seeds give
no near-tie, so tokens and counts compare exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import speculative as jspec
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving.speculative import (SpecStats, greedy_generate,
                                             speculative_generate)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

DRAFT = dict(num_layers=1, d_model=128, d_ff=256)


@pytest.fixture(scope="module")
def models():
    tcfg = treg.get_smoke_config("tinyllama-1.1b")
    dcfg = treg.get_smoke_config("tinyllama-1.1b", **DRAFT)
    return (tcfg, ttf.init_params(0, tcfg, device="cpu"),
            dcfg, ttf.init_params(7, dcfg, device="cpu"))


def test_speculative_equals_greedy(models):
    tcfg, tp, dcfg, dp = models
    prompt = [3, 1, 4, 1, 5]
    want = greedy_generate(tp, tcfg, prompt, 12, device="cpu")
    for k in (1, 3, 5):
        got, stats = speculative_generate(tp, tcfg, dp, dcfg, prompt, 12,
                                          k=k, device="cpu")
        assert got == want, (k, got, want)
        assert stats.target_calls <= 12  # never worse than plain greedy
        assert 0.0 <= stats.acceptance_rate <= 1.0


def test_speculative_perfect_draft_maximises_acceptance(models):
    """Draft == target: every proposal accepted, target calls = N/(k+1)."""
    tcfg, tp, _, _ = models
    got, stats = speculative_generate(tp, tcfg, tp, tcfg, [1, 2, 3], 12,
                                      k=3, device="cpu")
    assert stats.acceptance_rate == 1.0
    assert stats.target_calls == 3  # 12 tokens / (3 accepted + 1 bonus)
    assert stats.tokens_per_target_call == 4.0
    assert got == greedy_generate(tp, tcfg, [1, 2, 3], 12, device="cpu")


def test_tokens_and_stats_equal_the_reference():
    k = 3
    jt = jreg.get_smoke_config("tinyllama-1.1b")
    jd = jreg.get_smoke_config("tinyllama-1.1b", **DRAFT)
    jtp = jtf.init_params(jax.random.PRNGKey(0), jt)
    jdp = jtf.init_params(jax.random.PRNGKey(7), jd)
    tt = treg.get_smoke_config("tinyllama-1.1b")
    td = treg.get_smoke_config("tinyllama-1.1b", **DRAFT)
    ttp = ttf.params_from_jax(jax.tree.map(np.asarray, jtp), tt, "cpu")
    tdp = ttf.params_from_jax(jax.tree.map(np.asarray, jdp), td, "cpu")
    prompt = [3, 1, 4, 1, 5, 9, 2]
    jout, jstats = jspec.speculative_generate(jtp, jt, jdp, jd, prompt, 8,
                                              k=k)
    tout, tstats = speculative_generate(ttp, tt, tdp, td, prompt, 8, k=k,
                                        device="cpu")
    assert tout == jout
    assert isinstance(tstats, SpecStats)
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
    assert tstats.acceptance_rate == jstats.acceptance_rate
    assert greedy_generate(ttp, tt, prompt, 8, device="cpu") == jout


def test_entry_points_default_to_the_card(models):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    tcfg, tp, _, _ = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        greedy_generate(tp, tcfg, [1, 2], 1)
