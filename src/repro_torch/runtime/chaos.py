"""Fault injection for the round: seeded per-round availability traces
(own copy of ``repro/runtime/chaos.py``; the plan is numpy, the fold
torch).

Each round ``FaultPlan.step`` gives a ``RoundFaults`` record:

  * ``alive``        (R,) device liveness: i.i.d. dropout keyed by (seed,
                     round), plus the devices that miss the deadline (the
                     cost model's per-device times against
                     ``deadline_slack`` x the live devices'
                     ``failover.straggler_deadline``);
  * ``cluster_conn`` (C,) backhaul links, whole-cluster partitions with
                     Markov fail / recover draws on gossip rounds;
  * ``coordinator``  the elected coordinator of the embedded
                     ``CoordinatorRegistry``.

The draws are the reference's, so a seed gives the reference's trace round
by round, and ``state_dict`` / ``load_state_dict`` round-trip the Markov
state.  What the masks do to the aggregation (the live-count mean, the EF
carry-forward of dropped devices, partitions) lives in ``core/round``,
``dist/collectives`` and ``runtime/driver`` (DESIGN.md §Degraded-mode
contract).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.controller import DeviceReports
from repro_torch.runtime.failover import (CoordinatorRegistry,
                                          straggler_deadline)


@dataclass(frozen=True)
class ChaosConfig:
    """One fault-injection scenario (probabilities per round)."""

    seed: int = 0
    # device dropout
    dropout_prob: float = 0.0       # exogenous i.i.d. unavailability
    deadline_quantile: float = 0.9  # straggler deadline over live devices
    deadline_slack: float = 1.5     # drop devices slower than slack x it
    # cluster backhaul partitions (Markov fail / recover)
    partition_prob: float = 0.0
    partition_recover_prob: float = 0.5
    # coordinator churn (failover.CoordinatorRegistry)
    coordinator_servers: int = 3
    coordinator_fail_prob: float = 0.0
    coordinator_recover_prob: float = 0.5

    def __post_init__(self):
        if not 0.0 <= self.dropout_prob < 1.0:
            raise ValueError(f"dropout_prob {self.dropout_prob}")
        if self.deadline_slack < 1.0:
            raise ValueError(  # slack < 1 would drop the quantile device
                f"deadline_slack {self.deadline_slack} must be >= 1")
        if self.coordinator_servers < 1:
            raise ValueError("need at least one coordinator server")


@dataclass
class RoundFaults:
    """One round's availability trace (numpy, on the host)."""

    alive: np.ndarray          # (R,) bool: the device made the deadline
    cluster_conn: np.ndarray   # (C,) bool: the backhaul link is up
    coordinator: int
    deadline: float            # seconds (inf without per-device times)
    n_deadline_missed: int

    @property
    def participation(self) -> float:
        return float(np.mean(self.alive))


class FaultPlan:
    """Seeded per-round fault generator over R devices and C clusters."""

    def __init__(self, cfg: ChaosConfig, num_devices: int,
                 num_clusters: int):
        self.cfg = cfg
        self.R = int(num_devices)
        self.C = int(num_clusters)
        self.registry = CoordinatorRegistry(
            num_servers=cfg.coordinator_servers,
            fail_prob=cfg.coordinator_fail_prob,
            recover_prob=cfg.coordinator_recover_prob, seed=cfg.seed)
        self.partitioned: set = set()
        # partitions draw from their own stream; the dropout is keyed by
        # (seed, round), so it needs no state
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 0xC1A0]))

    def sample_available(self, round_idx: int) -> np.ndarray:
        """Exogenous device availability for this round, i.i.d. from a
        (seed, round)-keyed stream; at least one device stays alive."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, round_idx, 0xD0]))
        alive = rng.random(self.R) >= self.cfg.dropout_prob
        if not alive.any():
            alive[int(rng.integers(self.R))] = True
        return alive

    def step(self, round_idx: int, *, gossip_round: bool = False,
             per_device_time: Optional[np.ndarray] = None,
             alive: Optional[np.ndarray] = None) -> RoundFaults:
        """Advance the Markov faults one round and drop the devices that
        miss the deadline on top of ``alive`` (``sample_available``'s
        mask; drawn here when None).  The quantile device itself survives
        (slack >= 1).  Partitions move on gossip rounds only."""
        if alive is None:
            alive = self.sample_available(round_idx)
        alive = np.asarray(alive, bool).copy()
        deadline = float(np.inf)
        n_missed = 0
        if per_device_time is not None and alive.any():
            t = np.asarray(per_device_time, np.float64)
            deadline = straggler_deadline(t, 1, self.cfg.deadline_quantile,
                                          alive=alive)
            missed = alive & (t > self.cfg.deadline_slack * deadline)
            n_missed = int(missed.sum())
            alive &= ~missed
        if not alive.any():  # never an all-dead round
            keep = (int(np.argmin(per_device_time))
                    if per_device_time is not None else 0)
            alive[keep] = True
        if gossip_round:
            for c in range(self.C):
                if c in self.partitioned:
                    if self.rng.random() < self.cfg.partition_recover_prob:
                        self.partitioned.discard(c)
                elif self.rng.random() < self.cfg.partition_prob:
                    self.partitioned.add(c)
        conn = np.array([c not in self.partitioned for c in range(self.C)],
                        bool)
        coord = self.registry.step()
        return RoundFaults(alive=alive, cluster_conn=conn, coordinator=coord,
                           deadline=deadline, n_deadline_missed=n_missed)

    def state_dict(self) -> Dict:
        return {"partitioned": sorted(self.partitioned),
                "rng": self.rng.bit_generator.state,
                "registry": self.registry.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.partitioned = set(int(c) for c in state["partitioned"])
        self.rng.bit_generator.state = state["rng"]
        self.registry.load_state_dict(state["registry"])


def controls_on_live(controller, reports, budget, alive):
    """P2 solved over the live devices only: a dead device neither
    constrains the survivors' allowance nor gets real controls.  Dead
    entries take the controller's (rho_min, theta_min) floors.  All alive
    is exactly ``controller.controls``."""
    alive = np.asarray(alive, bool)
    if alive.all():
        return controller.controls(reports, budget)
    live = np.flatnonzero(alive)
    sub = DeviceReports(
        sigma2=np.asarray(reports.sigma2)[live],
        G2=np.asarray(reports.G2)[live],
        mu=np.asarray(reports.mu)[live],
        alpha=np.asarray(reports.alpha)[live],
        nu=np.asarray(reports.nu)[live],
        p=np.asarray(reports.p)[live],
        energy_cap=(None if reports.energy_cap is None
                    else np.asarray(reports.energy_cap)[live]))
    rho_l, theta_l = controller.controls(sub, budget)
    rho = np.full(alive.size, controller.rho_min, np.float64)
    theta = np.full(alive.size, controller.theta_min, np.float64)
    rho[live] = np.asarray(rho_l, np.float64)
    theta[live] = np.asarray(theta_l, np.float64)
    return rho, theta


def fold_dropped_updates(comp, ef_new, alive):
    """Dropped devices' compression outputs folded into their EF.

    ``comp`` / ``ef_new``: dicts of (R, ...) tensors, Q's exact split of
    each device's delta + ef_old.  A dropped device's update does not
    reach the aggregator and is not lost either: its contribution is 0
    and its EF takes comp + ef_new, so for every device

        contribution + ef_out == delta + ef_old.

    A ``torch.where`` per leaf, with nothing computed on live rows: all
    alive is the identity, bit for bit.  ``alive``: (R,) mask (numpy or
    tensor).  Returns (contribution, ef_out), dicts like the inputs."""
    contrib, ef_out = {}, {}
    masks = {}  # the mask on each device, made once
    for k, c in comp.items():
        e = ef_new[k]
        if c.device not in masks:
            masks[c.device] = torch.as_tensor(
                alive if isinstance(alive, torch.Tensor)
                else np.asarray(alive), device=c.device).bool()
        a = masks[c.device].view((c.shape[0],) + (1,) * (c.ndim - 1))
        contrib[k] = torch.where(a, c, torch.zeros_like(c))
        ef_out[k] = torch.where(a, e, c + e)
    return contrib, ef_out
