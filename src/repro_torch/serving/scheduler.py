"""Continuous-batching scheduler (own copy of ``repro/serving/scheduler.py``;
DESIGN.md §Serving contract).

Admission queue + per-decode-step admit/retire over a fixed set of decode
slots.  A finished (EOS / per-request ``max_new_tokens``) request releases
its pages and frees its slot the same step, so a waiting prefill refills
it instead of the slot idling until the whole batch drains — the
heterogeneity-aware idea of the paper (adapt per-device work to device
spread) applied to heterogeneous *request* lengths at inference time.

Admission policy: a request is admitted only when (a) a decode slot is
free, (b) its arrival time has passed, and (c) the page pool can cover
its FULL worst-case footprint (prompt + max_new_tokens).  Full
reservation means a live request can never OOM mid-decode — there is no
preemption path to reason about — while retiring still returns pages
early when a request finishes short of its budget.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.serving.page_manager import PageError, PageManager, pages_for


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int
    arrival: float = 0.0               # engine-clock time the request exists
    extra_inputs: Optional[dict] = None


@dataclass
class RequestOutput:
    rid: int
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = ""            # "eos" | "length"
    t_arrival: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrival

    @property
    def tpot(self) -> float:
        """Mean per-token latency after the first token."""
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


@dataclass
class Slot:
    request: Request
    out: RequestOutput
    kv_len: int                        # tokens currently in the cache
    produced: int = 0


class Scheduler:
    """Owns the waiting queue, the decode slots, and the page pool."""

    def __init__(self, *, max_slots: int, page_manager: PageManager,
                 table_width: int, clock=time.perf_counter):
        self.max_slots = int(max_slots)
        self.pm = page_manager
        self.table_width = int(table_width)
        self.clock = clock
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Slot]] = [None] * self.max_slots
        self.finished: Dict[int, RequestOutput] = {}

    # -- queries ----------------------------------------------------------
    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or self.num_active > 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    # -- admit / retire ----------------------------------------------------
    def admit(self, now: Optional[float] = None) -> List[int]:
        """Admit waiting requests into free slots; returns the slot ids
        admitted this call (the engine prefills each one).  FIFO order is
        preserved: if the head of the queue cannot be admitted (pages),
        nothing behind it jumps ahead (no starvation of long requests)."""
        if now is None:
            now = self.clock()
        admitted = []
        for i in range(self.max_slots):
            if self.slots[i] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            if req.arrival > now:
                break  # arrivals are sorted by construction in the bench
            budget = len(req.prompt) + req.max_new_tokens
            if pages_for(budget, self.pm.page_size) > self.pm.free_pages:
                break
            try:
                self.pm.alloc(req.rid, budget)
            except PageError:
                break
            self.waiting.popleft()
            out = RequestOutput(rid=req.rid, prompt_len=len(req.prompt),
                                t_arrival=req.arrival, t_admitted=now)
            self.slots[i] = Slot(request=req, out=out, kv_len=len(req.prompt))
            admitted.append(i)
        return admitted

    def record_token(self, slot_id: int, token: int, eos_id: int,
                     now: Optional[float] = None) -> bool:
        """Record one sampled token for a live slot; retires the slot (and
        releases its pages) when the request finishes.  Returns True if
        the slot is still live afterwards.  ``eos_id=-1`` is the explicit
        never-stops sentinel (no real token id is negative)."""
        if now is None:
            now = self.clock()
        slot = self.slots[slot_id]
        slot.out.tokens.append(int(token))
        if slot.produced == 0:
            slot.out.t_first_token = now
        slot.produced += 1
        hit_eos = eos_id >= 0 and int(token) == eos_id
        if hit_eos or slot.produced >= slot.request.max_new_tokens:
            slot.out.finish_reason = "eos" if hit_eos else "length"
            slot.out.t_done = now
            self.finished[slot.request.rid] = slot.out
            self.pm.release(slot.request.rid)
            self.slots[slot_id] = None
            return False
        slot.kv_len += 1
        return True

    def table(self) -> np.ndarray:
        """(max_slots, table_width) int32 page table; retired rows null."""
        t = np.zeros((self.max_slots, self.table_width), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                t[i] = self.pm.table_row(s.request.rid, self.table_width)
        return t

    def kv_lens(self) -> np.ndarray:
        """(max_slots,) int32 live KV lengths; 0 for empty slots (their
        decode reads are fully masked and their writes hit the null page)."""
        return np.array([0 if s is None else s.kv_len for s in self.slots],
                        np.int32)
