"""Device heterogeneity and dynamic-state models, paper Sec. 6.1 (own copy
of ``repro/fl/heterogeneity.py``, numpy).

``paper_edge``: phone-class devices, CPU frequency ~ U(1, 2) GHz redrawn
every round and scaled by each device's persistent capability, bandwidth
~ U(1, 5) Mbps, transmit power ~ U(0.1, 1) W.  ``tpu_pod``: per-replica
step time with lognormal jitter.

Population mode (DESIGN.md §Cohort contract): with ``population`` set the
model describes N >= R logical clients, each with a persistent capability
and availability propensity drawn once, while the dynamic state is drawn
population-wide every round from the (seed, round) stream.
``sample_round(round, ids=)`` gives the reports of a cohort;
``sample_cohort`` draws a mesh-sized cohort from the clients that this
round's availability churn (``available``) left reachable.  The draws are
the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.controller import DeviceReports


@dataclass
class HeterogeneityModel:
    num_devices: int  # cohort (mesh) size R
    profile: str = "paper_edge"
    seed: int = 0
    model_bits: float = 269_722 * 32  # full-model upload size (bits)
    flops_per_iter: float = 123.9e6 * 50 * 3  # fwd+bwd, batch 50
    base_step_time: float = 1.0  # tpu_pod: mean step seconds
    backhaul_mbps: float = 50.0
    # population mode: N logical clients behind an R-slot mesh
    population: int = 0  # 0: population == num_devices (no sampling)
    avail_lo: float = 0.6   # client i is reachable w.p. avail_p[i] a round
    avail_hi: float = 0.95

    def __post_init__(self):
        if self.population and self.population < self.num_devices:
            raise ValueError(
                f"population {self.population} smaller than the cohort "
                f"size {self.num_devices}")
        N = self.population_size
        rng = np.random.default_rng(self.seed)
        # static part of heterogeneity: relative capability, persistent
        # per client, drawn first (the fixed roster's stream unchanged)
        self.capability = rng.uniform(0.5, 1.0, N)
        self.avail_p = rng.uniform(self.avail_lo, self.avail_hi, N)

    @property
    def population_size(self) -> int:
        return self.population or self.num_devices

    # ------------------------------------------------------------------
    def sample_round(self, round_idx: int, ids=None) -> DeviceReports:
        """Per-round reports of the cohort ``ids`` (default: clients 0 ..
        R-1), drawn population-wide from the (seed, round) stream and
        indexed, so a client's report does not depend on its cohort."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, round_idx]))
        N = self.population_size
        if self.profile == "paper_edge":
            # dynamic U(1, 2) GHz throttle on top of the persistent
            # capability: a cap-0.5 phone spans [0.5, 1] GHz effective,
            # a cap-1.0 phone [1, 2] GHz — persistent speed identity
            # (the paper's U(1, 2)-only model made every device
            # exchangeable across rounds).
            freq = rng.uniform(1.0, 2.0, N) * self.capability
            mu = 150.0 / freq
            alpha = 1.5 * freq ** 2
            bw = rng.uniform(1.0, 5.0, N) * 1e6  # bit/s
            nu = self.model_bits / bw
            p = rng.uniform(0.1, 1.0, N)
        elif self.profile == "tpu_pod":
            jitter = rng.lognormal(0.0, 0.25, N)
            mu = self.base_step_time * jitter / self.capability
            alpha = 200.0 * mu  # ~200 W replica draw
            bw = rng.uniform(0.5, 1.0, N) * 100e9  # 100 Gb/s class links
            nu = self.model_bits / bw
            p = np.full(N, 300.0)
        else:
            raise ValueError(self.profile)
        ids = (np.arange(self.num_devices) if ids is None
               else np.asarray(ids, np.int64))
        if ids.size and (ids.min() < 0 or ids.max() >= N):
            raise ValueError(f"cohort ids out of range(population={N})")
        # sigma2/G2 placeholders; overwritten by measured values in training
        return DeviceReports(sigma2=np.ones(ids.size), G2=np.ones(ids.size),
                             mu=mu[ids], alpha=alpha[ids], nu=nu[ids],
                             p=p[ids])

    def available(self, round_idx: int) -> np.ndarray:
        """(N,) availability churn: client i is reachable this round w.p.
        avail_p[i], from a (seed, round) stream of its own."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7919, round_idx]))
        return rng.random(self.population_size) < self.avail_p

    def sample_cohort(self, round_idx: int, cohort: int,
                      seed: int = 0) -> np.ndarray:
        """A cohort of ``cohort`` ids drawn uniformly from this round's
        available clients, topped up from the rest when too few are
        available.  Slot order is the draw's order (slot r is in cluster
        r // Dev).  A function of (seed, round)."""
        if cohort > self.population_size:
            raise ValueError(f"cohort {cohort} exceeds population "
                             f"{self.population_size}")
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, 104_729, round_idx]))
        avail = np.flatnonzero(self.available(round_idx))
        if avail.size >= cohort:
            return rng.choice(avail, cohort, replace=False).astype(np.int64)
        rest = np.setdiff1d(np.arange(self.population_size), avail)
        fill = rng.choice(rest, cohort - avail.size, replace=False)
        ids = np.concatenate([avail, fill]).astype(np.int64)
        return rng.permutation(ids)

    def backhaul_time(self) -> float:
        return self.model_bits / (self.backhaul_mbps * 1e6)
