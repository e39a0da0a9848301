"""Coordinator failover and straggler deadlines, paper Sec. 3.2 (own copy
of ``repro/runtime/failover.py``, numpy).

The HCEF coordinator keeps no state between rounds: it rebuilds a round's
state from the device reports, so failover is a re-election.
``CoordinatorRegistry`` models a fleet of edge servers with per-round
fail / recover draws and elects the lowest-id live server;
``runtime/chaos.FaultPlan`` embeds it.  ``straggler_deadline`` is the
per-round compute deadline, the quantile of the live devices' times.
The draws are the reference's: the same seed gives the same trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Set

import numpy as np


@dataclass
class CoordinatorRegistry:
    num_servers: int
    fail_prob: float = 0.0      # per-round failure probability per server
    recover_prob: float = 0.5
    seed: int = 0
    down: Set[int] = field(default_factory=set)
    elections: int = 0
    _current: Optional[int] = None

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)
        self._current = 0

    def step(self) -> int:
        """One round of fail / recover draws; returns the coordinator."""
        for s in range(self.num_servers):
            if s in self.down:
                if self.rng.random() < self.recover_prob:
                    self.down.discard(s)
            elif self.rng.random() < self.fail_prob:
                self.down.add(s)
        if len(self.down) == self.num_servers:  # keep one alive (quorum)
            self.down.discard(int(self.rng.integers(self.num_servers)))
        if self._current in self.down:
            self._current = min(s for s in range(self.num_servers)
                                if s not in self.down)
            self.elections += 1
        return self._current

    @property
    def current(self) -> int:
        return self._current

    def state_dict(self) -> Dict:
        return {"down": sorted(self.down), "elections": self.elections,
                "current": self._current,
                "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: Dict) -> None:
        self.down = set(int(s) for s in state["down"])
        self.elections = int(state["elections"])
        self._current = int(state["current"])
        self.rng.bit_generator.state = state["rng"]


def straggler_deadline(mu: np.ndarray, tau: int, quantile: float = 0.9,
                       alive: Optional[np.ndarray] = None) -> float:
    """The round's compute deadline: the ``quantile`` of mu * tau over the
    live devices (``alive``, an (N,) mask; None: all).  No live device
    gives inf, one live device its own time."""
    t = np.asarray(mu, np.float64) * tau
    if alive is not None:
        alive = np.asarray(alive, bool)
        if alive.shape != t.shape:
            raise ValueError(f"alive mask shape {alive.shape} != mu shape "
                             f"{t.shape}")
        t = t[alive]
    if t.size == 0:
        return float(np.inf)
    if t.size == 1:
        return float(t[0])
    return float(np.quantile(t, quantile))
