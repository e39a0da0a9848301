"""Device heterogeneity and dynamic-state models, paper Sec. 6.1 (own copy
of ``repro/fl/heterogeneity.py``, numpy).

``paper_edge``: phone-class devices, CPU frequency ~ U(1, 2) GHz redrawn
every round and scaled by each device's persistent capability, bandwidth
~ U(1, 5) Mbps, transmit power ~ U(0.1, 1) W.  ``tpu_pod``: per-replica
step time with lognormal jitter.  Population mode (N logical clients
behind the mesh, ``sample_round(ids=)``), availability churn and cohort
sampling (``available``, ``sample_cohort``) wait for the cohort slice
(ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.controller import DeviceReports


@dataclass
class HeterogeneityModel:
    num_devices: int
    profile: str = "paper_edge"
    seed: int = 0
    model_bits: float = 269_722 * 32  # full-model upload size (bits)
    flops_per_iter: float = 123.9e6 * 50 * 3  # fwd+bwd, batch 50
    base_step_time: float = 1.0  # tpu_pod: mean step seconds
    backhaul_mbps: float = 50.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # static part of heterogeneity: relative device capability,
        # persistent per device for the whole campaign
        self.capability = rng.uniform(0.5, 1.0, self.num_devices)

    # ------------------------------------------------------------------
    def sample_round(self, round_idx: int) -> DeviceReports:
        """Per-round device reports, drawn from the (seed, round) stream."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, round_idx]))
        N = self.num_devices
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
        # sigma2/G2 placeholders; overwritten by measured values in training
        return DeviceReports(sigma2=np.ones(N), G2=np.ones(N), mu=mu,
                             alpha=alpha, nu=nu, p=p)

    def backhaul_time(self) -> float:
        return self.model_bits / (self.backhaul_mbps * 1e6)
