"""The port's analytic core against the JAX package's, on the CPU: the cost
model (``core/costmodel.py``), the analytic FLOP counts
(``launch/analytic.py``), ``worker_pool.min_bandwidth_moe``, and the
port's versions of the reference's cost-model claims (``test_costmodel.py``)
and property sweeps (``test_properties.py``, hypothesis, 30 examples each).

The port's functions are the reference's formulas over the port's
``ModelConfig``; every figure is held to the reference's at rel 1e-12
(the same float operations in the same order: equal but for the last
bit). The port's ``HARDWARE`` keeps the paper's GPU rows (``h100``,
``h20``) and its network stacks the paper's four; both equal the
reference's entries field for field.
"""
import dataclasses

import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro.core import costmodel as jcm
from repro.launch import analytic as jan
from repro.serving import worker_pool as jwp
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg
from repro_torch.core import costmodel as cm
from repro_torch.launch import analytic as an
from repro_torch.serving import worker_pool as twp
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REL = 1e-12
ARCHS = treg.ASSIGNED + ["llama3-70b"]
BATCHES = (1, 8, 128)
LENS = (1024, 8192)
HW = ("h100", "h20")


def _eq(got, want):
    if isinstance(want, (int, float)):
        assert got == pytest.approx(want, rel=REL, abs=0.0), (got, want)
    elif dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _eq(getattr(got, f.name), getattr(want, f.name))
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _eq(got[k], want[k])
    else:
        assert got == want, (got, want)


def _cfgs(arch):
    return treg.get_config(arch), jreg.get_config(arch)


def test_hardware_rows_equal_the_reference():
    assert set(cm.HARDWARE) == {"h100", "h20"}
    for name in cm.HARDWARE:
        t, j = cm.HARDWARE[name], jcm.HARDWARE[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.flops, t.mem_bw, t.mem_bytes) == (j.flops, j.mem_bw,
                                                    j.mem_bytes)
    assert set(cm.NETWORK_STACKS) == {"fhbn", "nccl", "nccl_no_gdr", "gloo"}
    for name, s in cm.NETWORK_STACKS.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(
            jcm.NETWORK_STACKS[name])
    assert cm.BYTES_PER_EL == jcm.BYTES_PER_EL


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_equals_the_reference(arch, hw):
    t, j = _cfgs(arch)
    th, jh = cm.HARDWARE[hw], jcm.HARDWARE[hw]
    other_t, other_j = cm.HARDWARE["h20"], jcm.HARDWARE["h20"]
    for fn in ("param_count", "active_param_count", "kv_bytes_per_token",
               "kv_quant_factor"):
        _eq(getattr(cm, fn)(t), getattr(jcm, fn)(j))
    for B in BATCHES:
        _eq(cm.transfer_bytes_per_iteration(t, B),
            jcm.transfer_bytes_per_iteration(j, B))
        _eq(cm.mfu_nonattention(t, B, th), jcm.mfu_nonattention(j, B, jh))
        for n_dev, eff in ((1, 0.8), (2, 1.0)):
            _eq(cm.mtime(t, B, th, n_dev, eff), jcm.mtime(j, B, jh, n_dev,
                                                          eff))
        for stack in cm.NETWORK_STACKS:
            for ov in (0.0, 0.3):
                _eq(cm.network_time_per_iteration(
                        t, B, cm.NETWORK_STACKS[stack], ov),
                    jcm.network_time_per_iteration(
                        j, B, jcm.NETWORK_STACKS[stack], ov))
        for l in LENS:
            for kvf in (1.0, cm.kv_quant_factor(t)):
                _eq(cm.atime(t, B, l, th, 2, 0.8, kvf),
                    jcm.atime(j, B, l, jh, 2, 0.8, kvf))
            if cm.kv_bytes_per_token(t):
                _eq(cm.mbu_attention(t, B, l, th),
                    jcm.mbu_attention(j, B, l, jh))
            for dop in ((1, 1), (2, 4)):
                _eq(cm.minimum_bandwidth(t, B, l, th, other_t, 0.2, dop),
                    jcm.minimum_bandwidth(j, B, l, jh, other_j, 0.2, dop))
            _eq(cm.estimate_vllm(t, l, th, 4, batch=B),
                jcm.estimate_vllm(j, l, jh, 4, batch=B))
            _eq(cm.estimate_lamina(t, l, th, other_t, (2, 4), batch=B),
                jcm.estimate_lamina(j, l, jh, other_j, (2, 4), batch=B))
    for l in LENS:
        _eq(cm.max_batch_homogeneous(t, l, th, 4),
            jcm.max_batch_homogeneous(j, l, jh, 4))
        for kvf in (1.0, 0.53):
            _eq(cm.max_batch_disaggregated(t, l, th, 4, kv_byte_factor=kvf),
                jcm.max_batch_disaggregated(j, l, jh, 4, kv_byte_factor=kvf))
            _eq(cm.estimate_lamina(t, l, other_t, th, (2, 4),
                                   kv_byte_factor=kvf,
                                   stack=cm.NETWORK_STACKS["nccl"],
                                   pipelined=False),
                jcm.estimate_lamina(j, l, other_j, jh, (2, 4),
                                    kv_byte_factor=kvf,
                                    stack=jcm.NETWORK_STACKS["nccl"],
                                    pipelined=False))
        _eq(cm.estimate_vllm(t, l, th, 4), jcm.estimate_vllm(j, l, jh, 4))
    for payload in (0, 1024, 1 << 30):
        for stack in cm.NETWORK_STACKS:
            _eq(cm.pingpong_rtt_us(cm.NETWORK_STACKS[stack], payload),
                jcm.pingpong_rtt_us(jcm.NETWORK_STACKS[stack], payload))


def test_input_shapes_equal_the_reference():
    assert list(tbase.INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, shp in tbase.INPUT_SHAPES.items():
        assert dataclasses.asdict(shp) == dataclasses.asdict(
            jbase.INPUT_SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_the_reference(arch):
    t, j = _cfgs(arch)
    for shape in tbase.INPUT_SHAPES:
        assert an.tokens_processed(t, shape) == jan.tokens_processed(j, shape)
        _eq(an.model_flops(t, shape), jan.model_flops(j, shape))
        _eq(an.recurrence_corrections(t, shape),
            jan.recurrence_corrections(j, shape))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b"])
def test_min_bandwidth_moe_equals_the_reference(arch):
    t, j = _cfgs(arch)
    for B in BATCHES:
        for l in LENS:
            for alpha in (0.1, 0.2):
                _eq(twp.min_bandwidth_moe(t, B, l, cm.HARDWARE["h100"],
                                          cm.HARDWARE["h20"], alpha),
                    jwp.min_bandwidth_moe(j, B, l, jcm.HARDWARE["h100"],
                                          jcm.HARDWARE["h20"], alpha))


def test_moe_offload_bandwidth_is_modest():
    """``test_extensions.py:119`` on the port: the MoE boundary needs far
    less than DCN rates (paper §7)."""
    cfg = treg.get_config("qwen3-moe-30b-a3b")
    bw = twp.min_bandwidth_moe(cfg, 128, 8192, cm.HARDWARE["h100"],
                               cm.HARDWARE["h20"])
    assert bw < 50e9  # under 400 GbE
    assert twp.transfer_bytes_moe(cfg, 1) == \
        2 * 2 * cfg.d_model * cfg.num_layers


# ---------------------------------------------------------------------------
# the reference's cost-model claims (tests/test_costmodel.py) on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def l70():
    return treg.get_config("llama3-70b")


def test_paper_table2_param_count(l70):
    assert 68e9 < cm.param_count(l70) < 73e9


def test_fig2_low_mfu_at_small_batch(l70):
    h100 = cm.HARDWARE["h100"]
    assert cm.mfu_nonattention(l70, 8, h100) < 0.05
    assert cm.mfu_nonattention(l70, 32, h100) < 0.20
    assert cm.mfu_nonattention(l70, 500, h100) > 0.8


def test_fig3_attention_stays_bandwidth_bound(l70):
    h20 = cm.HARDWARE["h20"]
    for B in (4, 20, 100, 400):
        assert cm.mbu_attention(l70, B, 8192, h20) > 0.95


def test_fig4_minimum_bandwidth_under_30gbs(l70):
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    for B in (32, 100, 300):
        bw = cm.minimum_bandwidth(l70, B, 4096, h100, h20, alpha=0.2,
                                  dop=(1, 1))
        assert bw < 30e9, (B, bw / 1e9)


def test_kv_capacity_claim(l70):
    per_req = cm.kv_bytes_per_token(l70) * 8192
    n = cm.HARDWARE["h100"].mem_bytes / per_req
    assert 25 < n < 40


def test_equal_cost_throughput_gain(l70):
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    v = cm.estimate_vllm(l70, 4096, h100, 4)
    lam = cm.estimate_lamina(l70, 4096, h100, h20, (2, 4))
    gain = lam.throughput_tok_s / v.throughput_tok_s - 1
    assert 0.10 < gain < 1.0, gain
    assert lam.cost_hr < v.cost_hr
    assert 1.5 < lam.batch / v.batch < 3.5
    assert lam.tbt_s < 0.25


def test_network_stack_fig13():
    fhbn, nccl = cm.NETWORK_STACKS["fhbn"], cm.NETWORK_STACKS["nccl"]
    assert cm.pingpong_rtt_us(fhbn, 1024) < 0.55 * cm.pingpong_rtt_us(
        nccl, 1024)
    assert fhbn.peak_gbs / 50.0 > 0.9
    big = 1 << 30
    assert cm.pingpong_rtt_us(fhbn, big) < cm.pingpong_rtt_us(nccl, big)


def test_overlap_reduces_network_time(l70):
    stack = cm.NETWORK_STACKS["fhbn"]
    t0 = cm.network_time_per_iteration(l70, 128, stack, overlap_fraction=0.0)
    t1 = cm.network_time_per_iteration(l70, 128, stack, overlap_fraction=0.3)
    assert t1 == pytest.approx(0.7 * t0)


def test_dop_sweep_shape(l70):
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    base = cm.estimate_lamina(l70, 4096, h100, h20, (2, 2))
    more_attn = cm.estimate_lamina(l70, 4096, h100, h20, (2, 4))
    more_model = cm.estimate_lamina(l70, 4096, h100, h20, (3, 2))
    gain_attn = more_attn.throughput_tok_s / base.throughput_tok_s
    gain_model = more_model.throughput_tok_s / base.throughput_tok_s
    assert gain_attn > gain_model
    assert gain_attn > 1.3


def test_rwkv_attention_free_zero_atime():
    cfg = treg.get_config("rwkv6-7b")
    assert cm.kv_bytes_per_token(cfg) == 0.0
    assert cm.atime(cfg, 64, 4096, cm.HARDWARE["h20"]) == 0.0


# ---------------------------------------------------------------------------
# the reference's cost-model property sweeps (tests/test_properties.py)
# ---------------------------------------------------------------------------
@settings(deadline=None, max_examples=30)
@given(b1=st.integers(1, 512), b2=st.integers(1, 512))
def test_mtime_monotone_in_batch(b1, b2):
    cfg = treg.get_config("llama3-70b")
    hw = cm.HARDWARE["h100"]
    lo, hi = sorted((b1, b2))
    assert cm.mtime(cfg, lo, hw) <= cm.mtime(cfg, hi, hw) + 1e-12


@settings(deadline=None, max_examples=30)
@given(b=st.integers(1, 512), l=st.integers(128, 32768))
def test_atime_linear_in_batch_and_seq(b, l):
    cfg = treg.get_config("llama3-70b")
    hw = cm.HARDWARE["h20"]
    t1 = cm.atime(cfg, b, l, hw)
    assert cm.atime(cfg, 2 * b, l, hw) == pytest.approx(2 * t1, rel=1e-6)
    assert cm.atime(cfg, b, 2 * l, hw) == pytest.approx(2 * t1, rel=1e-6)


@settings(deadline=None, max_examples=30)
@given(b=st.integers(1, 300), l=st.sampled_from([1024, 4096, 8192]),
       alpha=st.floats(0.05, 0.5))
def test_min_bandwidth_decreases_with_alpha(b, l, alpha):
    cfg = treg.get_config("llama3-70b")
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    bw1 = cm.minimum_bandwidth(cfg, b, l, h100, h20, alpha=alpha)
    bw2 = cm.minimum_bandwidth(cfg, b, l, h100, h20, alpha=alpha * 2)
    assert bw2 == pytest.approx(bw1 / 2, rel=1e-6)


def test_lamina_estimate_internally_consistent():
    cfg = treg.get_config("llama3-70b")
    h100, h20 = cm.HARDWARE["h100"], cm.HARDWARE["h20"]
    est = cm.estimate_lamina(cfg, 4096, h100, h20, (2, 4))
    assert est.cost_hr == pytest.approx(2 * h100.price_hr + 4 * h20.price_hr)
    assert est.throughput_tok_s * est.tbt_s >= est.batch * 0.99
    assert est.tok_per_dollar == pytest.approx(
        est.throughput_tok_s * 3600 / est.cost_hr)
