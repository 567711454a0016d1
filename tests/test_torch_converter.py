"""The port's automated model converter (``core/converter.py``) and
rotational staggered pipelining (``core/pipeline.py``) against the JAX
package's, on the CPU.

Structure is held exactly: slices, programs (the Q-early topological
orders), sends, saved contexts and cut bytes of the smoke llama3-8b and
gemma2-27b blocks at batch 1, 4 and 8, of the reference tests' two-layer
chain and cheapest-edge graphs, and of random graphs; the schedule's
events (exact ``Fraction`` s), ``validate``, ``utilisation`` and
``throughput_speedup``. Execution: the port's block graph runs fp32 torch
ops on weights carried across from ``blocks.init_dense_block`` (exact) and
equals the reference's numpy ops at atol 1e-5 (``residual2``: an O(1)
residual through two fp32 matmul chains of width d_ff); ``run_rotational``
over 4 batches equals the reference's to 1e-6 of the residual's largest
entry (O(10): sums in another order) and the port's own direct runs bit
for bit.
"""
import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.configs import registry as jreg
from repro.core import converter as jconv
from repro.core import pipeline as jpipe
from repro.models import blocks as jblocks
from repro_torch.configs import registry as treg
from repro_torch.core import converter as conv
from repro_torch.core import pipeline as pipe
from repro_torch.models import blocks as tblocks
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5    # executed residual2, torch fp32 vs numpy fp32
ROT_TOL = 1e-6   # run_rotational vs the reference, of the largest entry


def _weights(arch, seed=0):
    jcfg, tcfg = jreg.get_smoke_config(arch), treg.get_smoke_config(arch)
    jw = jblocks.init_dense_block(jax.random.PRNGKey(seed), jcfg)
    tw = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jw)
    return jcfg, tcfg, jw, tw


def _same_program(tsp, jsp):
    assert tsp.cut_bytes == jsp.cut_bytes
    assert len(tsp.slices) == len(jsp.slices)
    for a, b in zip(tsp.slices, jsp.slices):
        assert (a.index, a.program, a.context_in, a.context_out, a.sends,
                a.recv_attn) == (b.index, b.program, b.context_in,
                                 b.context_out, b.sends, b.recv_attn)


def _same_graph(tg, jg):
    assert tg.order == jg.order
    for name in jg.order:
        a, b = tg.ops[name], jg.ops[name]
        assert (a.kind, a.inputs, a.out_bytes) == (b.kind, b.inputs,
                                                   b.out_bytes), name


@pytest.mark.parametrize("batch", [1, 4, 8])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_block_graph_and_slices_equal_the_reference(arch, batch):
    jcfg, tcfg, _, _ = _weights(arch)
    tg = conv.build_block_graph(tcfg, batch=batch)
    jg = jconv.build_block_graph(jcfg, batch=batch)
    _same_graph(tg, jg)
    tsp, jsp = conv.split_at_attention(tg), jconv.split_at_attention(jg)
    _same_program(tsp, jsp)
    # the reference test's claims on the port
    assert tsp.slices[0].context_out == ["x"]
    assert tsp.cut_bytes == [batch * tcfg.d_model * 2]
    prog = tsp.slices[0].program
    assert prog.index("q_proj") < prog.index("k_proj") < \
        prog.index("v_proj")
    assert tsp.slices[0].sends == {"q_proj": "q", "k_proj": "kv",
                                   "v_proj": "kv"}
    assert tsp.slices[1].recv_attn == "attention"


def _chain(mod, d, q_dim, kv_dim, B=4, e=2):
    """``test_converter.py:67``'s two-layer chain."""
    g = mod.OpGraph()
    g.add("x", "input", [], B * d * e)
    prev = "x"
    for layer in range(2):
        p = f"l{layer}_"
        g.add(p + "norm1", "norm", [prev], B * d * e)
        g.add(p + "q_proj", "q_proj", [p + "norm1"], B * q_dim * e)
        g.add(p + "k_proj", "kv_proj", [p + "norm1"], B * kv_dim * e)
        g.add(p + "v_proj", "kv_proj", [p + "norm1"], B * kv_dim * e)
        g.add(p + "attention", "attention",
              [p + "q_proj", p + "k_proj", p + "v_proj"], B * q_dim * e)
        g.add(p + "o_proj", "proj", [p + "attention"], B * d * e)
        g.add(p + "res1", "add", [prev, p + "o_proj"], B * d * e)
        g.add(p + "norm2", "norm", [p + "res1"], B * d * e)
        g.add(p + "ffn", "proj", [p + "norm2"], B * d * e)
        g.add(p + "res2", "add", [p + "res1", p + "ffn"], B * d * e)
        prev = p + "res2"
    return g


def _cheapest(mod):
    """``test_converter.py:101``'s cheapest-edge graph."""
    g = mod.OpGraph()
    g.add("x", "input", [], 100)
    g.add("narrow", "proj", ["x"], 10)
    g.add("q", "q_proj", ["narrow"], 50)
    g.add("k", "kv_proj", ["narrow"], 50)
    g.add("v", "kv_proj", ["narrow"], 50)
    g.add("attention", "attention", ["q", "k", "v"], 50)
    g.add("o", "proj", ["attention"], 50)
    g.add("merge", "add", ["narrow", "o"], 50)
    return g


def test_two_layer_chain_equals_the_reference():
    cfg = treg.get_smoke_config("llama3-8b")
    args = (cfg.d_model, cfg.q_dim, cfg.kv_dim)
    tsp = conv.split_at_attention(_chain(conv, *args))
    _same_program(tsp, jconv.split_at_attention(_chain(jconv, *args)))
    assert len(tsp.slices) == 3
    assert tsp.cut_bytes == [4 * cfg.d_model * 2] * 2
    assert tsp.slices[1].context_out == ["l0_res2"]
    assert "l0_o_proj" in tsp.slices[1].program
    assert "l1_q_proj" in tsp.slices[1].program


def test_cut_prefers_cheapest_edge_as_the_reference():
    tsp = conv.split_at_attention(_cheapest(conv))
    _same_program(tsp, jconv.split_at_attention(_cheapest(jconv)))
    assert tsp.slices[0].context_out == ["narrow"]
    assert tsp.cut_bytes[0] == 10


@settings(deadline=None, max_examples=30)
@given(n=st.integers(3, 12), m=st.integers(2, 30), seed=st.integers(0, 999))
def test_min_cut_equals_the_reference_on_random_graphs(n, m, seed):
    rng = np.random.default_rng(seed)
    nodes = [f"n{i}" for i in range(n)]
    edges = [(nodes[int(a)], nodes[int(b)], int(c)) for a, b, c in zip(
        rng.integers(0, n, m), rng.integers(0, n, m), rng.integers(1, 50, m))
        if a != b]
    assert conv._min_cut(nodes, edges, "n0", nodes[-1]) == \
        jconv._min_cut(nodes, edges, "n0", nodes[-1])


def _direct(graph, env, attn_fn):
    """The unsliced order: every op in graph order, attention inline."""
    env = dict(env)
    for name in graph.order:
        op = graph.ops[name]
        if op.kind == "input":
            continue
        env[name] = attn_fn(name, env) if op.kind == "attention" else \
            op.fn(*[env[i] for i in op.inputs])
    return env


def _t_attn(name, env):
    v = env["v_proj"]
    return v.repeat_interleave(env["q_proj"].shape[1] // v.shape[1], dim=1)


def _j_attn(name, env):
    v = env["v_proj"]
    return np.repeat(v, env["q_proj"].shape[1] // v.shape[1], axis=1)


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma2-27b"])
def test_sliced_execution_matches_the_reference(arch):
    jcfg, tcfg, jw, tw = _weights(arch)
    x = np.random.default_rng(0).standard_normal(
        (4, tcfg.d_model)).astype(np.float32)
    tg = conv.build_block_graph(tcfg, weights=tw, batch=4, device="cpu")
    jg = jconv.build_block_graph(jcfg, weights=jw, batch=4)
    trace, jtrace = [], []
    env = conv.split_at_attention(tg).run({"x": torch.from_numpy(x)},
                                          _t_attn, trace=trace)
    jenv = jconv.split_at_attention(jg).run({"x": x}, _j_attn,
                                            trace=jtrace)
    assert trace == jtrace
    assert trace.index("send_q:q_proj") < trace.index("send_kv:k_proj")
    assert env["residual2"].dtype == torch.float32
    np.testing.assert_allclose(env["residual2"].numpy(), jenv["residual2"],
                               atol=ATOL)
    # sliced = unsliced in the port, bit for bit
    direct = _direct(tg, {"x": torch.from_numpy(x)}, _t_attn)
    for name in tg.order:
        assert torch.equal(env[name], direct[name]), name


def test_block_graph_runs_the_ports_own_bf16_block_weights():
    """A tree from the port's ``blocks.init_dense_block`` (bf16, the
    serving dtype) runs as fp32 ops; sliced = unsliced bit for bit."""
    cfg = treg.get_config("llama3-8b").replace(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256)
    gen = torch.Generator().manual_seed(0)
    w = tblocks.init_dense_block(gen, cfg, "cpu")
    assert w["attn"]["wq"].dtype == torch.bfloat16
    g = conv.build_block_graph(cfg, weights=w, batch=3, device="cpu")
    x = {"x": torch.randn(3, cfg.d_model, generator=gen)}
    env = conv.split_at_attention(g).run(x, _t_attn)
    assert env["residual2"].dtype == torch.float32
    assert torch.isfinite(env["residual2"]).all()
    assert torch.equal(env["residual2"],
                       _direct(g, x, _t_attn)["residual2"])


def test_block_graph_executes_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, tcfg, _, tw = _weights("llama3-8b")
    conv.build_block_graph(tcfg, batch=2)              # structure only
    with pytest.raises(RuntimeError, match="device='cpu'"):
        conv.build_block_graph(tcfg, weights=tw, batch=2)


# ---------------------------------------------------------------------------
# rotational staggered pipelining
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("steps", [1, 7, 50])
@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_schedule_equals_the_reference(n, steps):
    s, js = pipe.rotational_schedule(n, steps), jpipe.rotational_schedule(
        n, steps)
    assert [(e.batch, e.step, e.device, e.start, e.end) for e in s.events] \
        == [(e.batch, e.step, e.device, e.start, e.end) for e in js.events]
    assert (s.t_model, s.t_attn, s.makespan) == (js.t_model, js.t_attn,
                                                 js.makespan)
    v = pipe.validate(s)
    assert v == jpipe.validate(js)
    assert all(v.values()), v
    assert pipe.utilisation(s) == jpipe.utilisation(js)
    assert pipe.throughput_speedup(n) == jpipe.throughput_speedup(n)
    for e in s.events:
        if e.device.startswith("model:"):
            assert e.device == f"model:{(e.batch + e.step) % (n - 1)}"


def test_schedule_refuses_one_batch():
    with pytest.raises(ValueError):
        pipe.rotational_schedule(1, 4)


def test_run_rotational_equals_the_reference_and_direct_runs():
    jcfg, tcfg, jw, tw = _weights("llama3-8b")
    n = 4
    tprogs, jprogs, tin, jin = [], [], [], []
    for j in range(n):
        tprogs.append(conv.split_at_attention(conv.build_block_graph(
            tcfg, weights=tw, batch=2, device="cpu")))
        jprogs.append(jconv.split_at_attention(jconv.build_block_graph(
            jcfg, weights=jw, batch=2)))
        x = np.random.default_rng(j).standard_normal(
            (2, tcfg.d_model)).astype(np.float32)
        tin.append({"x": torch.from_numpy(x)})
        jin.append({"x": x})
    envs, log = pipe.run_rotational(tprogs, tin,
                                    lambda j, nm, env: _t_attn(nm, env))
    jenvs, jlog = jpipe.run_rotational(jprogs, jin,
                                       lambda j, nm, env: _j_attn(nm, env))
    assert log == jlog
    for j in range(n):
        want = jenvs[j]["residual2"]
        np.testing.assert_allclose(envs[j]["residual2"].numpy(), want,
                                   atol=ROT_TOL * np.abs(want).max(),
                                   rtol=ROT_TOL)
        direct = tprogs[j].run(tin[j], _t_attn)
        assert torch.equal(envs[j]["residual2"], direct["residual2"])
    for j, k, replica in log:
        assert replica == (j + k) % (n - 1)
    assert sorted({(j, k) for j, k, _ in log}) == \
        [(j, k) for j in range(n) for k in range(len(tprogs[0].slices))]
