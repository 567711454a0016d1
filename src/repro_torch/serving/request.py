"""Request lifecycle for the serving engines.
Port (a copy) of ``repro/serving/request.py``."""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import List, Optional

_ids = itertools.count()


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    # evicted under pool pressure; blocks returned to the pool, generated
    # tokens kept — re-admission recomputes the KV by re-prefilling
    PREEMPTED = "preempted"
    # disaggregated cluster: prefill finished on the prefill engine, KV
    # blocks in flight to (or queued on) a decode replica — the request
    # belongs to no scheduler until transfer-complete admission
    TRANSFERRING = "transferring"
    FINISHED = "finished"


@dataclasses.dataclass
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 => greedy
    top_k: int = 0                 # 0 => full softmax
    eos_token: Optional[int] = None
    # per-request sampling stream seed; None falls back to the engine's
    # EngineConfig.seed (LLMEngine draws token i from a generator seeded by
    # (seed, i) — batch-composition independent)
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    prompt: List[int]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    rid: int = dataclasses.field(default_factory=lambda: next(_ids))
    state: State = State.WAITING
    output: List[int] = dataclasses.field(default_factory=list)
    arrival_s: float = dataclasses.field(default_factory=time.time)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    token_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)

    def done(self) -> bool:
        p = self.params
        if p.eos_token is not None and self.output and \
                self.output[-1] == p.eos_token:
            return True
        return len(self.output) >= p.max_new_tokens

    def record_token(self, tok: int) -> None:
        now = time.time()
        if self.first_token_s is None:
            self.first_token_s = now
        self.output.append(int(tok))
        self.token_times.append(now)
        if self.done():
            self.state = State.FINISHED
            self.finish_s = now

    def tbt_s(self) -> float:
        """Mean time between tokens."""
        if len(self.token_times) < 2:
            return 0.0
        diffs = [b - a for a, b in zip(self.token_times, self.token_times[1:])]
        return sum(diffs) / len(diffs)
