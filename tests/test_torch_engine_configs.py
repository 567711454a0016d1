"""Greedy engine parity, port against the JAX package, for the dense and
vlm configs this slice adds to the port's registry: glm4-9b (with its
full-width group size G = 16: 32 heads over 2 kv heads), pixtral-12b,
tinyllama-1.1b and llama3-70b, at smoke size on the CPU. Each serves the
same requests through ``LLMEngine`` homogeneous over a full-precision
pool, and through Lamina's ``attention_pool`` head partition over 2
workers on an int8 pool; greedy tokens must equal the reference engine's
(fp32 logits that agree to ~1e-5; the seeds give no near-tie), and the
pool's wire log and per-worker KV bytes must equal the reference's.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.models import transformer as jtf
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import LLMEngine as JLLMEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import registry as treg
from repro_torch.models import transformer as ttf
from repro_torch.serving import (EngineConfig, LLMEngine, Request,
                                 SamplingParams)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = {"glm4-9b": {"num_heads": 32, "num_kv_heads": 2},
         "pixtral-12b": {}, "tinyllama-1.1b": {}, "llama3-70b": {}}
ENGINES = {"homogeneous": dict(),
           "lamina-head-int8": dict(placement="attention_pool",
                                    partition="head", attention_workers=2,
                                    kv_dtype="int8")}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_greedy_tokens_match_reference(arch, engine):
    jcfg = jreg.get_smoke_config(arch, **ARCHS[arch])
    tcfg = treg.get_smoke_config(arch, **ARCHS[arch])
    jp = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    tp = ttf.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=n).tolist()
               for n in (19, 12, 7)]
    kw = dict(max_batch=4, block_size=8, num_blocks=48, **ENGINES[engine])
    jreqs = [JRequest(prompt=list(p), params=JSamplingParams(
        max_new_tokens=5)) for p in prompts]
    jeng = JLLMEngine(jcfg, jp, JEngineConfig(**kw))
    jeng.submit(jreqs)
    jeng.run()
    treqs = [Request(prompt=list(p), params=SamplingParams(
        max_new_tokens=5)) for p in prompts]
    teng = LLMEngine(tcfg, tp, EngineConfig(**kw), device="cpu")
    teng.submit(treqs)
    teng.run()
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert all(len(r.output) == 5 for r in treqs)
    if engine != "homogeneous":
        assert dataclasses.asdict(teng.pool.log) == \
            dataclasses.asdict(jeng.pool.log)
        assert teng.pool.per_worker_kv_bytes == \
            jeng.pool.per_worker_kv_bytes
    assert teng.stats.kv_pool_bytes_resident == \
        jeng.stats.kv_pool_bytes_resident
