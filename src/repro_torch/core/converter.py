"""Automated model converter (paper §4.2). Port of
``repro/core/converter.py``: the graph, the Edmonds–Karp min cut, the
slicing and the Q-early order are the reference's; the block graph's ops
run in PyTorch (fp32, on the weights' device) instead of numpy.

Takes a transformer block expressed as a weighted operator graph, removes
each attention operator, computes the *minimum weighted cut* between the
attention input's side and the attention output's side (edge weight = bytes
of the tensor on that edge), and emits ``n+1`` executable model slices with
explicit ``SendQ`` / ``SendKV`` / ``RecvAttn`` instructions. Within each
slice the serial program is a topological order that hoists Q-Proj (and its
dependencies) as early as possible so the q transfer overlaps the K/V
projections (paper §4.2.2 / Fig. 7).

The graph is genuinely executable — ``SlicedProgram.run`` reproduces the
unsliced block bit-for-bit given an attention callback — which is how the
tests validate the cut. On the card the callback can launch the port's
dense decode kernel (``chip_smoke.py``'s converter phase).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.common import resolve_device


@dataclasses.dataclass
class OpNode:
    name: str
    kind: str                      # 'input' | 'attention' | compute kinds
    inputs: List[str]
    out_bytes: int                 # edge weight for every out-edge
    fn: Optional[Callable] = None  # (*input_arrays) -> array


class OpGraph:
    def __init__(self):
        self.ops: Dict[str, OpNode] = {}
        self.order: List[str] = []

    def add(self, name: str, kind: str, inputs: Sequence[str],
            out_bytes: int, fn: Optional[Callable] = None) -> str:
        assert name not in self.ops, name
        for i in inputs:
            assert i in self.ops, f"unknown input {i} of {name}"
        self.ops[name] = OpNode(name, kind, list(inputs), out_bytes, fn)
        self.order.append(name)
        return name

    def consumers(self) -> Dict[str, List[str]]:
        out = defaultdict(list)
        for op in self.ops.values():
            for i in op.inputs:
                out[i].append(op.name)
        return out

    def attention_ops(self) -> List[str]:
        return [n for n in self.order if self.ops[n].kind == "attention"]


# ---------------------------------------------------------------------------
# Max-flow / min-cut (Edmonds–Karp; graphs are ~10-100 nodes)
# ---------------------------------------------------------------------------
def _min_cut(nodes: List[str], edges: List[Tuple[str, str, int]],
             source: str, sink: str) -> Tuple[int, set]:
    """Returns (flow, set of nodes on the source side)."""
    cap: Dict[Tuple[str, str], int] = defaultdict(int)
    adj: Dict[str, set] = defaultdict(set)
    for u, v, c in edges:
        cap[(u, v)] += c
        adj[u].add(v)
        adj[v].add(u)  # residual
    flow = 0
    while True:
        parent = {source: None}
        q = deque([source])
        while q and sink not in parent:
            u = q.popleft()
            for v in adj[u]:
                if v not in parent and cap[(u, v)] > 0:
                    parent[v] = u
                    q.append(v)
        if sink not in parent:
            break
        # bottleneck
        path, v = [], sink
        while parent[v] is not None:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(cap[e] for e in path)
        for u, v in path:
            cap[(u, v)] -= aug
            cap[(v, u)] += aug
        flow += aug
    # source side = reachable in residual graph
    side = {source}
    q = deque([source])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if v not in side and cap[(u, v)] > 0:
                side.add(v)
                q.append(v)
    return flow, side


# ---------------------------------------------------------------------------
# Slicing
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Slice:
    index: int
    program: List[str]             # topologically ordered op names
    context_in: List[str]          # ops whose values arrive from prev slice
    context_out: List[str]         # ops whose values must be saved (min cut)
    sends: Dict[str, str]          # op name -> 'q' | 'kv' (transfer markers)
    recv_attn: Optional[str] = None  # attention op whose output this consumes


@dataclasses.dataclass
class SlicedProgram:
    graph: OpGraph
    slices: List[Slice]
    cut_bytes: List[int]           # saved-context bytes per boundary

    def run(self, inputs: Dict[str, object],
            attention_fn: Callable[[str, Dict[str, object]], object],
            trace: Optional[List[str]] = None) -> Dict[str, object]:
        """Execute the sliced program. ``attention_fn(op_name, env)`` plays
        the role of the remote attention workers."""
        env = dict(inputs)
        for sl in self.slices:
            if sl.recv_attn is not None:
                env[sl.recv_attn] = attention_fn(sl.recv_attn, env)
                if trace is not None:
                    trace.append(f"recv_attn:{sl.recv_attn}")
            for name in sl.program:
                op = self.graph.ops[name]
                if op.kind == "input":
                    continue
                env[name] = op.fn(*[env[i] for i in op.inputs])
                if trace is not None:
                    trace.append(name)
                    if name in sl.sends:
                        trace.append(f"send_{sl.sends[name]}:{name}")
        return env


def _ancestors(graph: OpGraph, target: str) -> set:
    anc, stack = set(), [target]
    while stack:
        n = stack.pop()
        for i in graph.ops[n].inputs:
            if i not in anc:
                anc.add(i)
                stack.append(i)
    return anc


def _topo_q_early(graph: OpGraph, members: set, q_ops: set) -> List[str]:
    """Kahn topological sort restricted to `members`; ops that q-proj depends
    on (and q-proj itself) are dequeued first (paper §4.2.2)."""
    indeg = {n: 0 for n in members}
    cons = defaultdict(list)
    for n in members:
        for i in graph.ops[n].inputs:
            if i in members:
                indeg[n] += 1
                cons[i].append(n)
    ready = sorted([n for n, d in indeg.items() if d == 0],
                   key=lambda n: (n not in q_ops, graph.order.index(n)))
    out = []
    while ready:
        n = ready.pop(0)
        out.append(n)
        for c in cons[n]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
        ready.sort(key=lambda x: (x not in q_ops, graph.order.index(x)))
    assert len(out) == len(members), "cycle in op graph"
    return out


def split_at_attention(graph: OpGraph) -> SlicedProgram:
    """Cut the graph at every attention op (paper Fig. 6): n attention ops
    yield n+1 slices. The saved context across each boundary is the minimum
    weighted edge cut of the graph with that attention op removed.

    The max-flow formulation adds an INF reverse edge per data edge: cutting
    "backwards" is impossible, which enforces dependency closure (if a
    consumer lands before the boundary, so does its producer).
    """
    attn_ops = graph.attention_ops()
    cons = graph.consumers()
    INF = 1 << 60
    assigned: set = set()          # ops executed in earlier slices
    slices: List[Slice] = []
    cut_bytes: List[int] = []
    prev_context: List[str] = []
    prev_attn: Optional[str] = None

    for idx, attn in enumerate(attn_ops):
        members = set(graph.order) - set(attn_ops[:idx]) - {attn}
        edges = []
        for n in members:
            for c in cons.get(n, []):
                if c in members:
                    edges.append((n, c, graph.ops[n].out_bytes))
                    edges.append((c, n, INF))  # dependency closure
        for n in members:
            if graph.ops[n].kind == "input" or n in assigned:
                edges.append(("__SRC__", n, INF))
        for i in graph.ops[attn].inputs:
            if i in members:  # attention inputs are computed pre-boundary
                edges.append(("__SRC__", i, INF))
        for t in cons.get(attn, []):
            if t in members:  # attention consumers are post-boundary
                edges.append((t, "__SNK__", INF))
        nodes = list(members) + ["__SRC__", "__SNK__"]
        _, side = _min_cut(nodes, edges, "__SRC__", "__SNK__")
        this_side = (side - {"__SRC__"}) & members
        for later in attn_ops[idx + 1:]:
            assert later not in this_side, \
                "converter: attention op landed inside a model slice"
        # saved context: values computed up to here but consumed after
        context = sorted({n for n in this_side
                          for c in cons.get(n, [])
                          if c in members and c not in this_side},
                         key=graph.order.index)
        cut_bytes.append(sum(graph.ops[n].out_bytes for n in context))

        program_members = this_side - assigned
        q_anc = set()
        for i in graph.ops[attn].inputs:
            if graph.ops[i].kind.startswith("q"):
                q_anc = _ancestors(graph, i) | {i}
        program = _topo_q_early(graph, program_members, q_anc)
        sends = {i: ("q" if i in q_anc else "kv")
                 for i in graph.ops[attn].inputs if i in program}
        slices.append(Slice(index=idx, program=program,
                            context_in=list(prev_context),
                            context_out=context, sends=sends,
                            recv_attn=prev_attn))
        prev_context = context
        prev_attn = attn
        assigned |= this_side

    final_members = set(graph.order) - assigned - set(attn_ops)
    program = _topo_q_early(graph, final_members, set())
    slices.append(Slice(index=len(attn_ops), program=program,
                        context_in=list(prev_context), context_out=[],
                        sends={}, recv_attn=prev_attn))
    return SlicedProgram(graph=graph, slices=slices, cut_bytes=cut_bytes)


# ---------------------------------------------------------------------------
# Concrete graph builder: one GQA transformer block, torch-executable
# ---------------------------------------------------------------------------
def build_block_graph(cfg, weights: Optional[Dict] = None, batch: int = 1,
                      *, device="cuda") -> OpGraph:
    """Builds the paper's Figure-6 graph for one transformer block of `cfg`.
    Edge weights are activation bytes for `batch` decode tokens. If `weights`
    (the port's dense-block tree, from ``blocks.init_dense_block`` or
    ``transformer.params_from_jax``) is given, ops are executable: fp32
    PyTorch ops on ``device`` (the weights are copied there as fp32 once),
    the reference's numpy lambdas op for op (``rms`` with eps 1e-6 and the
    ``(1 + gamma)`` scale, the einsums, SiLU·up). Without weights nothing
    runs and ``device`` is not touched."""
    e = 2  # bf16
    d = cfg.d_model
    hq, hkv = cfg.q_dim, cfg.kv_dim
    g = OpGraph()
    f32: Dict[str, object] = {}
    if weights is not None:
        dev = resolve_device(device)
        for key1, key2 in (("norm1", None), ("norm2", None), ("attn", "wq"),
                           ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
                           ("ffn", "w_gate"), ("ffn", "w_up"),
                           ("ffn", "w_down")):
            arr = weights[key1] if key2 is None else weights[key1][key2]
            f32[key2 or key1] = torch.as_tensor(arr).to(
                device=dev, dtype=torch.float32)

    def w(key):
        return f32[key]

    def rms(x, gamma):
        nx = x / torch.sqrt((x * x).mean(-1, keepdim=True) + 1e-6)
        return nx * (1.0 + gamma)

    def op(fn):
        return fn if weights is not None else None

    g.add("x", "input", [], batch * d * e)
    g.add("norm1", "norm", ["x"], batch * d * e,
          fn=op(lambda x: rms(x, w("norm1"))))
    g.add("q_proj", "q_proj", ["norm1"], batch * hq * e,
          fn=op(lambda h: torch.einsum("bd,dhk->bhk", h, w("wq"))))
    g.add("k_proj", "kv_proj", ["norm1"], batch * hkv * e,
          fn=op(lambda h: torch.einsum("bd,dhk->bhk", h, w("wk"))))
    g.add("v_proj", "kv_proj", ["norm1"], batch * hkv * e,
          fn=op(lambda h: torch.einsum("bd,dhk->bhk", h, w("wv"))))
    g.add("attention", "attention", ["q_proj", "k_proj", "v_proj"],
          batch * hq * e)
    g.add("o_proj", "proj", ["attention"], batch * d * e,
          fn=op(lambda a: torch.einsum("bhk,hkd->bd", a, w("wo"))))
    g.add("residual1", "add", ["x", "o_proj"], batch * d * e,
          fn=op(lambda x, o: x + o))
    g.add("norm2", "norm", ["residual1"], batch * d * e,
          fn=op(lambda x: rms(x, w("norm2"))))
    g.add("ffn_gate", "proj", ["norm2"], batch * cfg.d_ff * e,
          fn=op(lambda h: h @ w("w_gate")))
    g.add("ffn_up", "proj", ["norm2"], batch * cfg.d_ff * e,
          fn=op(lambda h: h @ w("w_up")))
    g.add("ffn_act", "act", ["ffn_gate", "ffn_up"], batch * cfg.d_ff * e,
          fn=op(lambda a, b: (a / (1 + torch.exp(-a))) * b))
    g.add("ffn_down", "proj", ["ffn_act"], batch * d * e,
          fn=op(lambda h: h @ w("w_down")))
    g.add("residual2", "add", ["residual1", "ffn_down"], batch * d * e,
          fn=op(lambda x, f: x + f))
    return g
