"""Shard fault injection + health tracking for the attention-pool path.
Port of ``repro/serving/faults.py``; ``filter_decode`` takes and returns
torch tensors.

The paper's economics depend on attending over a fleet of *cheap*,
memory-optimized devices — and cheap, numerous devices straggle, corrupt
results, and die. This module is the engine's fault machinery:

  * :class:`FaultEvent` / :class:`FaultScenario` — a deterministic, seeded
    schedule of injected faults (shard death at step N with optional
    rejoin, transient probe failures, corrupted/NaN attention partials,
    straggler slow-steps), parseable from a compact CLI spec or a JSON
    file (``repro-serve --fault-scenario``);
  * :class:`FaultInjector` — the runtime hook :class:`LLMEngine` consults
    at the host-side pool boundary. Injection NEVER touches compiled code:
    shard death and transient unavailability surface as failed *probes*
    (the stand-in for a heartbeat/RPC timeout), and partial corruption is
    applied to the merged decode output AFTER the step returns — after
    the graph replay on the card, never inside a graph (the stand-in for
    a worker shipping garbage over the wire);
  * :class:`ShardHealthTracker` — the per-shard health state machine
    (``healthy → suspect → dead``): each failed probe/validation is a
    strike; a shard recovers to healthy when a retry succeeds before
    ``retry_limit`` strikes, and is declared DEAD (quarantine + request
    recovery, see ``llm_engine._handle_shard_death``) when it doesn't.

Recovery itself is NOT here — it is the §5 preempt-and-recompute path the
scheduler already owns: KV is recomputable from prompt + generated tokens,
so a dead shard's requests are evicted and re-prefilled onto surviving
shards with greedy outputs bit-identical to a fault-free run.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# health states
# ---------------------------------------------------------------------------
HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

FAULT_KINDS = ("shard_death", "transient", "corrupt", "straggle")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``kind``:
      * ``shard_death`` — the shard stops answering probes from ``step``
        on (until ``rejoin_step``, if set). Detection exhausts the retry
        budget and declares the shard dead; its requests are recovered.
      * ``transient``   — the shard fails ``failures`` consecutive probes
        at ``step`` then answers again (a blip, not a death — recovers via
        retry when ``failures`` is below the engine's retry limit).
      * ``corrupt``     — the merged decode output contains NaN for
        ``failures`` consecutive attempts at ``step`` (a worker shipped a
        garbage partial); clean on the next retry.
      * ``straggle``    — the shard answers ``delay_s`` late at ``step``
        (observability only: slow is not wrong, health returns to healthy).
    """

    kind: str
    shard: int
    step: int
    failures: int = 1                  # transient / corrupt
    rejoin_step: Optional[int] = None  # shard_death
    delay_s: float = 0.0               # straggle

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"fault kind must be one of {FAULT_KINDS}; "
                             f"got {self.kind!r}")
        if self.shard < 0:
            raise ValueError(f"fault shard must be >= 0; got {self.shard}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1 (engine steps are "
                             f"1-based); got {self.step}")
        if self.failures < 1:
            raise ValueError(f"fault failures must be >= 1; "
                             f"got {self.failures}")
        if self.rejoin_step is not None and self.rejoin_step <= self.step:
            raise ValueError(
                f"rejoin_step ({self.rejoin_step}) must be after the death "
                f"step ({self.step})")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0; got {self.delay_s}")


class FaultScenario:
    """An ordered, validated schedule of :class:`FaultEvent`\\ s."""

    def __init__(self, events: Sequence[FaultEvent]):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.step, e.shard)))

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def __repr__(self):
        return f"FaultScenario({list(self.events)!r})"

    # ------------------------------------------------------------------
    @classmethod
    def parse(cls, spec: str) -> "FaultScenario":
        """Build a scenario from the CLI spec.

        Two forms:
          * a path to a JSON file (a list of event objects:
            ``[{"kind": "shard_death", "shard": 1, "step": 6,
            "rejoin_step": 20}, ...]``);
          * an inline spec: ``;``-separated events, each
            ``kind:key=value,key=value`` — e.g.
            ``shard_death:shard=1,step=6,rejoin=20;``
            ``corrupt:shard=0,step=9,failures=2;``
            ``straggle:shard=1,step=3,delay_ms=5``.
        """
        spec = spec.strip()
        if os.path.isfile(spec):
            with open(spec) as f:
                raw = json.load(f)
            if not isinstance(raw, list):
                raise ValueError(
                    f"fault scenario file {spec!r} must hold a JSON list "
                    f"of event objects; got {type(raw).__name__}")
            return cls([FaultEvent(**ev) for ev in raw])
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, kvs = part.partition(":")
            kind = kind.strip()
            kw: Dict = {}
            for item in kvs.split(","):
                item = item.strip()
                if not item:
                    continue
                key, _, val = item.partition("=")
                key = key.strip()
                if not val:
                    raise ValueError(
                        f"fault spec item {item!r} needs key=value "
                        f"(in {part!r})")
                if key == "rejoin":
                    kw["rejoin_step"] = int(val)
                elif key == "delay_ms":
                    kw["delay_s"] = float(val) / 1e3
                elif key == "delay_s":
                    kw["delay_s"] = float(val)
                elif key in ("shard", "step", "failures"):
                    kw[key] = int(val)
                else:
                    raise ValueError(
                        f"unknown fault spec key {key!r} (in {part!r}); "
                        f"known: shard, step, failures, rejoin, delay_ms, "
                        f"delay_s")
            events.append(FaultEvent(kind=kind, **kw))
        if not events:
            raise ValueError(f"fault scenario spec {spec!r} holds no events")
        return cls(events)

    @classmethod
    def random(cls, seed: int, n_shards: int, horizon: int,
               n_events: int = 3) -> "FaultScenario":
        """A deterministic pseudo-random schedule: same seed, same faults —
        reproducible chaos testing without hand-writing scenarios."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = FAULT_KINDS[rng.integers(0, len(FAULT_KINDS))]
            shard = int(rng.integers(0, n_shards))
            step = int(rng.integers(1, max(2, horizon)))
            if kind == "shard_death":
                rejoin = None
                if rng.random() < 0.5:
                    rejoin = step + int(rng.integers(2, 10))
                events.append(FaultEvent(kind, shard, step,
                                         rejoin_step=rejoin))
            elif kind in ("transient", "corrupt"):
                events.append(FaultEvent(kind, shard, step,
                                         failures=int(rng.integers(1, 3))))
            else:
                events.append(FaultEvent(kind, shard, step,
                                         delay_s=float(rng.uniform(0, 2e-3))))
        return cls(events)


# ---------------------------------------------------------------------------
# the injector (host-side pool boundary — never inside a graph)
# ---------------------------------------------------------------------------
class FaultInjector:
    """Runtime fault source the engine consults once per step.

    Stateful and deterministic: each transient/corrupt event carries a
    remaining-failure budget that is consumed attempt by attempt, so a
    retry sequence plays out identically run after run. The injector
    stands in for the health channel a real RPC fabric would provide —
    ``probe`` is the heartbeat, ``filter_decode`` is the response
    validator that knows WHICH worker shipped the garbage partial (a real
    fabric gets this from per-shard checksums / sender identity).
    """

    def __init__(self, scenario: FaultScenario):
        if isinstance(scenario, (list, tuple)):
            scenario = FaultScenario(scenario)
        self.scenario = scenario
        self._deaths: Dict[int, FaultEvent] = {}
        for ev in scenario:
            if ev.kind == "shard_death":
                if ev.shard in self._deaths:
                    raise ValueError(
                        f"shard {ev.shard} has two shard_death events — "
                        f"one life per shard per scenario")
                self._deaths[ev.shard] = ev
        # per-event remaining failure budgets (transient / corrupt)
        self._budget: Dict[int, int] = {
            i: ev.failures for i, ev in enumerate(scenario)
            if ev.kind in ("transient", "corrupt")}
        self._step = 0

    # ------------------------------------------------------------------
    def begin_step(self, step: int) -> None:
        """Advance the injector's clock to engine step `step`."""
        self._step = step

    def rejoins(self, step: int) -> List[int]:
        """Shards whose scheduled rejoin lands at `step`."""
        return sorted(ev.shard for ev in self._deaths.values()
                      if ev.rejoin_step == step)

    def pending_rejoins(self, step: int) -> bool:
        """True when some dead shard is still scheduled to rejoin after
        `step` — the engine waits instead of declaring a permanent stall."""
        return any(ev.rejoin_step is not None and ev.rejoin_step > step
                   for ev in self._deaths.values())

    def straggles(self, step: int) -> List[Tuple[int, float]]:
        """(shard, delay_s) straggler events firing at `step`."""
        return [(ev.shard, ev.delay_s) for ev in self.scenario
                if ev.kind == "straggle" and ev.step == step]

    def probe(self, shard: int, step: int) -> bool:
        """One health probe of `shard` (the heartbeat / RPC liveness
        check). False = no answer. A dead shard never answers between its
        death step and its rejoin; a transient event consumes one failure
        per probe and answers again once its budget is spent."""
        death = self._deaths.get(shard)
        if death is not None and death.step <= step and \
                (death.rejoin_step is None or step < death.rejoin_step):
            return False
        for i, ev in enumerate(self.scenario):
            if ev.kind == "transient" and ev.shard == shard \
                    and ev.step == step and self._budget.get(i, 0) > 0:
                self._budget[i] -= 1
                return False
        return True

    def filter_decode(self, step: int, logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, Optional[int]]:
        """Apply any active corruption fault to the merged decode output
        (host-side, AFTER the step or its graph replay returns — compiled
        code is never touched; the step's own output is left as it is). Returns (possibly corrupted logits, faulty shard or
        None). Each call consumes one failure from the event's budget, so
        the engine's bounded retry deterministically rides it out."""
        for i, ev in enumerate(self.scenario):
            if ev.kind == "corrupt" and ev.step == step \
                    and self._budget.get(i, 0) > 0:
                self._budget[i] -= 1
                return torch.full_like(logits, float("nan")), ev.shard
        return logits, None


# ---------------------------------------------------------------------------
# per-shard health state machine
# ---------------------------------------------------------------------------
class ShardHealthTracker:
    """``healthy → suspect → dead`` per pool shard.

    Every failed probe / corrupted-output validation is a STRIKE: the
    first strike moves a healthy shard to ``suspect``; reaching
    ``retry_limit`` strikes without a success in between declares it
    ``dead`` (the engine quarantines it and recovers its requests). A
    success while suspect clears the strikes — transient blips recover.
    A rejoined shard is marked up and starts clean.
    """

    def __init__(self, n_shards: int, retry_limit: int = 3):
        if retry_limit < 1:
            raise ValueError(f"retry_limit must be >= 1; got {retry_limit}")
        self.n_shards = n_shards
        self.retry_limit = retry_limit
        self._state = [HEALTHY] * n_shards
        self._strikes = [0] * n_shards

    def state(self, shard: int) -> str:
        return self._state[shard]

    def strikes(self, shard: int) -> int:
        return self._strikes[shard]

    def is_dead(self, shard: int) -> bool:
        return self._state[shard] == DEAD

    @property
    def dead_shards(self) -> List[int]:
        return [s for s, st in enumerate(self._state) if st == DEAD]

    def strike(self, shard: int) -> str:
        """Record one failure; returns the shard's new state."""
        if self._state[shard] == DEAD:
            return DEAD
        self._strikes[shard] += 1
        self._state[shard] = (DEAD if self._strikes[shard] >=
                              self.retry_limit else SUSPECT)
        return self._state[shard]

    def clear(self, shard: int) -> None:
        """A retry succeeded: the suspect shard is healthy again."""
        if self._state[shard] != DEAD:
            self._state[shard] = HEALTHY
            self._strikes[shard] = 0

    def mark_up(self, shard: int) -> None:
        """A dead shard rejoined (fresh hardware / restarted worker)."""
        self._state[shard] = HEALTHY
        self._strikes[shard] = 0

    def __repr__(self):
        return (f"ShardHealthTracker({dict(enumerate(self._state))}, "
                f"retry_limit={self.retry_limit})")
