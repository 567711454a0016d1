"""Drive one cell: build the engine, fill it with the cell's own traffic,
warm up, then measure a window of the closed loop.

Two entry paths, chosen by the mix's ``arrival``:

* ``handoff`` — Lamina's decode instance: ``serving/cluster/engines.py``
  ``DecodeEngine``. A request arrives as a ``KVHandoffPayload`` of its
  context's K/V (a slice of a seeded pinned template) plus its first
  token, through ``enqueue_handoff``, as a prefill instance would send it.
* ``submit`` — a colocated engine: ``serving/llm_engine.py`` ``LLMEngine``
  with chunked prefill, through ``submit``.

Each client sends its next request as soon as its last one finishes (no
think time), after the engine's step that finished it. Set-up fills every
client at once: a decode instance lands the first payloads without its
per-step wire budget, so the batch starts full; a colocated engine
prefills them chunk by chunk. The loop then runs ``warmup_steps`` steps
of the same traffic (its graph keys are captured there, the rest after
it) before the window opens. The benchmark's spans are its own: a host clock around every
``step()`` and every client's submission.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lamina_bench import spec as spec_mod
from lamina_bench import traffic as traffic_mod
from lamina_bench import weights as weights_mod


class ConfigMismatch(RuntimeError):
    """The configuration file and the port's registry disagree."""


def port_config(cell: spec_mod.Cell):
    """The port's ``ModelConfig`` of the cell's ``arch``, checked field by
    field against the configuration file: its published shape and the
    departures it states."""
    from repro_torch.configs import registry
    mcfg = registry.get_config(cell.config["arch"])
    dims = spec_mod.model_dims(cell.config)
    bad = {k: (v, getattr(mcfg, k)) for k, v in dims.items()
           if getattr(mcfg, k) != v}
    if bad:
        raise ConfigMismatch(
            f"{cell.config_name}: the configuration file and "
            f"repro_torch.configs.registry disagree (file, registry): {bad}")
    if str(mcfg.dtype).split(".")[-1] != cell.config["torch_dtype"]:
        raise ConfigMismatch(f"{cell.config_name}: dtype {mcfg.dtype} != "
                             f"{cell.config['torch_dtype']}")
    return mcfg, dims


@dataclasses.dataclass
class Served:
    """One request the loop sent: what the generator made, the engine's
    ``Request``, and when it was sent."""
    spec: traffic_mod.RequestSpec
    req: object
    submit_s: float
    seen: int = 0
    admit_s: Optional[float] = None


@dataclasses.dataclass
class StepRecord:
    """One engine step in the window: its host span (perf_counter s), the
    tokens it decoded with their summed context and table entries, and
    the prefill chunks it ran as (start, tokens)."""
    t0: float = 0.0
    t1: float = 0.0
    decoded: int = 0
    ctx_sum: int = 0
    blocks: int = 0
    chunks: List = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Window:
    """What the metric readers read."""
    dims: Dict
    settings: Dict
    arrival: str
    setup_s: float = 0.0
    window_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    steps: List[StepRecord] = dataclasses.field(default_factory=list)
    output_tokens: int = 0
    gaps_s: List[float] = dataclasses.field(default_factory=list)
    ttfts_s: List[float] = dataclasses.field(default_factory=list)
    admit_waits_s: List[float] = dataclasses.field(default_factory=list)
    handoff_waits_s: List[float] = dataclasses.field(default_factory=list)
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    graph_captures: int = 0
    attempted: int = 0
    failed: int = 0
    profile: Optional[Dict] = None
    # a --trace 1 run: the traced slice after the window (its own steps,
    # seconds and profile), which the device metrics read
    traced: Optional["Window"] = None
    host: Dict = dataclasses.field(default_factory=dict)


class Driver:
    """One cell's engine and closed loop on ``device``."""

    def __init__(self, cell: spec_mod.Cell, seed: int, device):
        self.cell = cell
        self.device = torch.device(device)
        self.mcfg, self.dims = port_config(cell)
        self.s = cell.settings
        self.arrival = cell.traffic["arrival"]
        engines = {"handoff": "DecodeEngine", "submit": "LLMEngine"}
        if engines.get(self.arrival) != self.s["engine"]:
            raise ValueError(f"{cell.name}: arrival {self.arrival!r} is "
                             f"served by {engines.get(self.arrival)}, not "
                             f"{self.s['engine']!r}")
        self.bs = int(self.s["block_size"])
        self.setup_log: Dict[str, float] = {}
        t0 = time.perf_counter()
        self.weights = weights_mod.make_weights(
            self.dims, seed, self.mcfg.dtype, self.device)
        self.templates = None
        if self.arrival == "handoff":
            t = cell.traffic
            most = t["prompt"]["max"] + t["output"]["max"] - 1
            self.template_blocks = -(-most // self.bs)
            self.templates = weights_mod.make_kv_templates(
                self.dims, int(t["kv_templates"]), self.template_blocks,
                self.bs, seed + 1, self.mcfg.dtype, self.device)
        t1 = time.perf_counter()
        self.eng = self._engine()
        self.setup_log.update(weights_s=t1 - t0,
                              engine_s=time.perf_counter() - t1)
        self.stream = traffic_mod.Stream(cell.traffic, seed,
                                         self.dims["vocab_size"])
        self.clients: List[Served] = []     # each client's current request
        self.served: List[Served] = []      # every request sent
        self.by_rid: Dict[int, Served] = {}
        self._events = len(self.eng.event_log)
        self._sending = True
        self.widths: set = set()            # table widths the traffic used

    # ---------------------------------------------------------------
    def _engine(self):
        from repro_torch.serving.config import DisaggConfig, EngineConfig
        s = self.s
        econf = EngineConfig(
            placement=s["placement"], partition=s["partition"],
            attention_workers=int(s["attention_workers"]),
            num_blocks=int(s["num_blocks"]), block_size=self.bs,
            kv_dtype=s["kv_dtype"], max_batch=int(s["max_batch"]),
            prefill_chunk_tokens=s["prefill_chunk_tokens"])
        if self.arrival == "handoff":
            from repro_torch.serving.cluster import DecodeEngine
            # set-up lands the first payloads unbudgeted; _fill restores
            # the cell's transfer_blocks_per_step before any other step
            return DecodeEngine(self.mcfg, self.weights, econf,
                                DisaggConfig(role="decode",
                                             transfer_blocks_per_step=0),
                                device=self.device)
        from repro_torch.serving.llm_engine import LLMEngine
        return LLMEngine(self.mcfg, self.weights, econf, device=self.device)

    # ---------------------------------------------------------------
    def _send(self, spec: traffic_mod.RequestSpec) -> Served:
        from repro_torch.serving.request import Request, SamplingParams
        now = time.time()
        params = SamplingParams(max_new_tokens=spec.out_len)
        if self.arrival == "handoff":
            req = Request(prompt=spec.tokens, params=params,
                          output=[spec.first_token], token_times=[now],
                          first_token_s=now, arrival_s=now)
            self.eng.enqueue_handoff(req, self._payload(req.rid, spec))
        else:
            req = Request(prompt=spec.tokens, params=params, arrival_s=now)
            self.eng.submit(req)
        sv = Served(spec=spec, req=req, submit_s=now)
        self.served.append(sv)
        self.by_rid[req.rid] = sv
        return sv

    def _payload(self, rid: int, spec: traffic_mod.RequestSpec):
        from repro_torch.serving.kvcache import KVHandoffPayload
        n = -(-spec.context // self.bs)
        tk, tv = self.templates
        ids = tuple(range(n))
        return KVHandoffPayload(
            tables={rid: ids}, lengths={rid: spec.context}, block_ids=ids,
            k_blocks=tk[spec.template, :n].movedim(0, 2),
            v_blocks=tv[spec.template, :n].movedim(0, 2),
            block_size=self.bs)

    def prefix(self, spec: traffic_mod.RequestSpec):
        """The payload K/V of a handed-over request as the reference reads
        them: layer -> (k, v), (Hkv, context, hd) on the device."""
        n = -(-spec.context // self.bs)
        tk, tv = self.templates

        def get(layer: int):
            def one(t):
                x = t[spec.template, :n, layer].to(self.device)
                return x.transpose(0, 1).reshape(
                    x.shape[1], n * self.bs, -1)[:, :spec.context]
            return one(tk), one(tv)
        return get

    # ---------------------------------------------------------------
    def _fill(self) -> None:
        """Every client's first request (a residual life); a decode
        instance lands them in its first step, then takes the cell's
        wire budget."""
        for _ in range(int(self.s["clients"])):
            self.clients.append(self._send(self.stream.first()))
        if self.arrival == "handoff":
            self._step(None)
            self.eng.disagg = self.eng.disagg.replace(
                transfer_blocks_per_step=int(
                    self.s["transfer_blocks_per_step"]))

    def _step(self, rec: Optional[StepRecord]) -> None:
        """One engine step, then the loop's bookkeeping: new tokens of
        every client, admissions, and each finished client's next
        request."""
        t0 = time.perf_counter()
        self.eng.step()
        t1 = time.perf_counter()
        now = time.time()
        if rec is not None:
            rec.t0, rec.t1 = t0, t1
        log = self.eng.event_log
        for ev in log[self._events:]:
            if ev.kind == "admit" and ev.rid in self.by_rid:
                self.by_rid[ev.rid].admit_s = now
            elif ev.kind == "chunk" and rec is not None:
                rec.chunks.append((ev.info["start"], ev.info["tokens"]))
        self._events = len(log)
        widest = 0
        for i, sv in enumerate(self.clients):
            out = sv.req.output
            for j in range(max(sv.seen, 1), len(out)):
                ctx = sv.spec.context + j - 1
                nb = -(-ctx // self.bs)
                widest = max(widest, nb)
                if rec is not None:
                    rec.decoded += 1
                    rec.ctx_sum += ctx
                    rec.blocks += nb
            sv.seen = len(out)
            if sv.req.finish_s is not None and self._sending:
                self.clients[i] = self._send(self.stream.next())
        if widest:
            # a table holds the stored tokens' blocks, or one more where
            # admission reserved decode headroom
            self.widths.update((widest, widest + 1))

    def setup(self, warmup_steps: int) -> None:
        """Fill, then run the loop until every client's first request has
        its first token, then ``warmup_steps`` steps more. Counted in
        steps, not seconds, so every run's window opens at the same point
        of the same traffic."""
        t0 = time.perf_counter()
        captures = self.captures()
        self._fill()
        first = list(self.clients)
        while any(not sv.req.token_times for sv in first):
            self._step(None)
        self.widths.clear()     # only the steady traffic's widths count
        t1 = time.perf_counter()
        for _ in range(warmup_steps):
            self._step(None)
        self._warm_keys()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_log.update(fill_s=t1 - t0,
                              warmup_s=time.perf_counter() - t1,
                              setup_captures=self.captures() - captures)

    def _warm_keys(self) -> None:
        """Capture the graph keys the cell's traffic can reach that the
        warm-up may have missed, as a server captures its batch sizes at
        start-up: the decode step at every batch from ``max_batch -
        warm_batches`` to ``max_batch``, at every table width the
        warm-up's traffic reached; with chunked prefill, the chunk step at
        each of the engine's chunk buckets after every whole number of
        chunks below the mix's longest context. The keys are the
        engine's own: its bucket functions pad each call. Nothing is
        written to the pool: the engine writes a program's outputs, and
        these are dropped. An engine without these entry points is warmed
        by its traffic alone, and the window's ``graph_captures`` shows
        what that misses.

        ``warm_batches`` is the cell's: the warm-up's own batch sizes do
        not give it. In a chat cell they fall to two thirds of
        ``max_batch`` while the first requests' replacements wait for
        their chunks (the window's stay within 60-64 of 64), and a range
        taken from them warmed more graphs than the engine keeps (its LRU
        frees the oldest), so the window captured again."""
        eng = self.eng
        if getattr(eng, "compiled", None) is None:
            return
        if self.s["partition"] == "block":
            raise ValueError("key warm-up needs the block partition's "
                             "shard tables; not supported")
        try:
            from repro_torch.serving.compiled import (chunk_bucket,
                                                      width_bucket)
            cap = int(self.s["num_blocks"])
            widths = sorted({width_bucket(nb, cap) for nb in self.widths})
            top = int(self.s["max_batch"])
            low = max(1, top - int(self.s["warm_batches"]))
            for W in widths:
                for B in range(low, top + 1):
                    eng.compiled([0] * B, np.zeros((B, W), np.int32),
                                 np.full((B,), W * self.bs // 2, np.int32))
            chunk = self.s["prefill_chunk_tokens"]
            if chunk:
                t = self.cell.traffic
                most = t["prompt"]["max"] + t["output"]["max"] - 1
                sizes = sorted({chunk_bucket(C, chunk)
                                for C in range(1, chunk + 1)})
                for cursor in range(0, most, chunk):
                    for C in sizes:
                        eng.compiled_prefill.run_chunk(
                            [0] * C, [0] * (cursor // self.bs))
        except (ImportError, AttributeError, TypeError) as e:
            self.setup_log["warm_keys_skipped"] = 1.0
            print(f"lamina_bench: graph keys warmed by the traffic alone "
                  f"({type(e).__name__}: {e})", file=sys.stderr)

    def captures(self) -> int:
        eng = self.eng
        if eng.compiled is None:
            return 0
        return eng.compiled.captures + sum(
            p.captures for p in eng.compiled_prefill.programs().values())

    def window(self, seconds: float, profiler=None) -> Window:
        """The loop for ``seconds`` host seconds, closed after the step
        that crosses them, under ``profiler`` where one is given. Records
        the steps and every token, admission and handoff that falls in
        it. The loop goes on sending until :meth:`stop`."""
        w = Window(dims=self.dims, settings=self.s, arrival=self.arrival)
        stats = self.eng.stats
        n_batch, n_handoff = len(stats.batch_sizes), len(
            stats.handoff_latencies)
        captures0 = self.captures()
        n_served0 = len(self.served)
        gc.collect()
        gc.freeze()
        if profiler is not None:
            profiler.start()
        w.t_open = time.time()
        p_open = time.perf_counter()
        while time.perf_counter() - p_open < seconds:
            rec = StepRecord()
            self._step(rec)
            w.steps.append(rec)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        w.t_close = time.time()
        w.window_s = time.perf_counter() - p_open
        if profiler is not None:
            profiler.stop()
        gc.unfreeze()
        w.batch_sizes = list(stats.batch_sizes[n_batch:])
        w.handoff_waits_s = list(stats.handoff_latencies[n_handoff:])
        w.graph_captures = self.captures() - captures0
        w.attempted = len(self.served) - n_served0
        self._tokens(w)
        return w

    def stop(self) -> None:
        """No client sends a next request from here on."""
        self._sending = False

    def _tokens(self, w: Window) -> None:
        lo, hi = w.t_open, w.t_close
        first_own = 1 if self.arrival == "handoff" else 0
        for sv in self.served:
            times = sv.req.token_times
            for j, t in enumerate(times):
                if not lo <= t <= hi:
                    continue
                if j >= first_own:
                    w.output_tokens += 1
                if j:
                    w.gaps_s.append(t - times[j - 1])
                elif self.arrival == "submit":
                    w.ttfts_s.append(t - sv.submit_s)
            if sv.admit_s is not None and lo <= sv.admit_s <= hi:
                w.admit_waits_s.append(sv.admit_s - sv.submit_s)

    def finished_in(self, w: Window) -> List[Served]:
        """Requests that finished inside the window."""
        return [sv for sv in self.served if sv.req.finish_s is not None
                and w.t_open <= sv.req.finish_s <= w.t_close]

    def close(self) -> None:
        """Free the engine (its pool and graphs); the weights and the
        templates stay for the reference."""
        self.eng.cancel_all()
        self.eng = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

