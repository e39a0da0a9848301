"""Time (Eq. 8) and energy (Eq. 9) of one edge round (own copy of
``repro/fl/cost_model.py``, numpy).

With ``wire_dtype=None`` a theta-compressed upload costs ``theta * nu``;
with a wire dtype the effective fraction is the exact byte ratio of the
sparse (value, offset) encoding (``core.wire_format``), capped at 1.0.
The gossip backhaul term is charged per cluster at its own level.
Degraded mode: ``alive`` (an (N,) device mask) charges live devices only,
``conn`` (a (C,) backhaul mask) skips a partitioned cluster's gossip.
The overlapped engine (DESIGN.md §Overlap contract): ``overlap_round_time``
charges a stale cluster max(compute, gossip) + fold, and
``decide_stale_clusters`` picks the clusters whose gossip does not fit
before the straggler deadline.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.wire_format import compression_ratio_bytes
from repro_torch.runtime.failover import straggler_deadline


def wire_fraction(theta, *, wire_dtype=None, wire_block=1024, dense_bits=16):
    """Fraction of the dense payload a theta-compressed upload occupies.

    Capped at 1.0: any level whose sparse (value, offset) encoding would
    reach the dense bytes takes the dense-wire fallback on the real wire
    (``dist/collectives.wire_ships_dense``) — e.g. the f32 wire's offsets
    would 2x the payload at theta = 1 — so the model must never charge
    more than a dense upload either."""
    if wire_dtype is None:
        return np.asarray(theta, np.float64)
    return np.minimum(
        compression_ratio_bytes(theta, wire_dtype=wire_dtype,
                                wire_block=wire_block,
                                dense_bits=dense_bits), 1.0)


def per_device_time(rho, theta, mu, nu, tau, *, wire_dtype=None,
                    wire_block=1024, dense_bits=16):
    """Per-device wall time of one edge round: rho*tau*mu + eff(theta)*nu
    (``round_time``'s per-device term; ``runtime/chaos.FaultPlan`` holds
    it to the straggler deadline)."""
    eff = wire_fraction(theta, wire_dtype=wire_dtype, wire_block=wire_block,
                        dense_bits=dense_bits)
    return rho * tau * mu + eff * nu


def round_time(rho, theta, mu, nu, tau, cluster_of, *, backhaul=0.0,
               gossip=False, wire_dtype=None, wire_block=1024,
               dense_bits=16, alive=None, conn=None):
    """Expected wall time of one edge round.

    Per device: rho*tau*mu + eff(theta)*nu; per cluster: max over its
    devices, plus — on gossip rounds — the cluster's OWN backhaul
    transfer; round: max over clusters.  ``backhaul`` is the FULL-model
    inter-cluster transfer time; with a wire format each cluster's gossip
    payload is its wire-encoded intra-mean at that cluster's level (the
    max over its devices — sender-sized edges, core/round.py), so a
    low-level cluster finishes its send early instead of being charged
    the global max level.  Returns (round_time, per_cluster_times) with
    the backhaul term folded into per_cluster_times.

    ``alive``: the round waits only for the devices that made the
    deadline, and a fully dead cluster adds 0.  ``conn``: a partitioned
    cluster skips its gossip transfer."""
    eff = wire_fraction(theta, wire_dtype=wire_dtype, wire_block=wire_block,
                        dense_bits=dense_bits)
    per_dev = rho * tau * mu + eff * nu
    m = int(cluster_of.max()) + 1
    live = (np.ones(len(per_dev), bool) if alive is None
            else np.asarray(alive, bool))
    per_cluster = np.array([
        per_dev[(cluster_of == i) & live].max(initial=0.0) for i in range(m)])
    if gossip:
        eff_c = (np.array([eff[(cluster_of == i) & live].max(initial=0.0)
                           for i in range(m)])
                 if wire_dtype else np.ones(m))
        if conn is not None:
            eff_c = eff_c * np.asarray(conn, np.float64)
        per_cluster = per_cluster + float(backhaul) * eff_c
    t = float(per_cluster.max())
    return t, per_cluster


def overlap_round_time(rho, theta, mu, nu, tau, cluster_of, *,
                       backhaul=0.0, gossip=False, wire_dtype=None,
                       wire_block=1024, dense_bits=16, alive=None,
                       conn=None, stale_clusters=(), fold=0.0):
    """Expected wall time of one edge round under the overlapped engine.

    A stale cluster ships its start-of-round model, so its backhaul
    transfer runs during the tau local steps: it costs max(compute,
    gossip) + ``fold`` (the constant cost of the stale fold) where a
    fresh cluster costs compute + gossip.  A round without gossip is
    ``round_time``'s.  Returns (round_time, per_cluster_times)."""
    eff = wire_fraction(theta, wire_dtype=wire_dtype, wire_block=wire_block,
                        dense_bits=dense_bits)
    per_dev = rho * tau * mu + eff * nu
    m = int(cluster_of.max()) + 1
    live = (np.ones(len(per_dev), bool) if alive is None
            else np.asarray(alive, bool))
    compute = np.array([
        per_dev[(cluster_of == i) & live].max(initial=0.0)
        for i in range(m)])
    if not gossip:
        return float(compute.max()), compute
    eff_c = (np.array([eff[(cluster_of == i) & live].max(initial=0.0)
                       for i in range(m)])
             if wire_dtype else np.ones(m))
    if conn is not None:
        eff_c = eff_c * np.asarray(conn, np.float64)
    wire = float(backhaul) * eff_c
    stale = np.zeros(m, bool)
    if len(stale_clusters):
        stale[np.asarray(sorted(stale_clusters), np.int64)] = True
    per_cluster = np.where(stale, np.maximum(compute, wire) + float(fold),
                           compute + wire)
    return float(per_cluster.max()), per_cluster


def decide_stale_clusters(rho, theta, mu, nu, tau, cluster_of, *,
                          backhaul=0.0, wire_dtype=None, wire_block=1024,
                          dense_bits=16, alive=None, quantile=0.9):
    """The clusters that run stale this gossip round: those whose compute
    plus backhaul transfer (at the cluster's own wire level) passes the
    straggler deadline, the ``quantile`` of the live devices' round times
    (``runtime.failover.straggler_deadline``).  A sorted tuple, empty when
    every cluster fits (the overlapped engine then runs the synchronous
    program)."""
    eff = wire_fraction(theta, wire_dtype=wire_dtype, wire_block=wire_block,
                        dense_bits=dense_bits)
    per_dev = rho * tau * mu + eff * nu
    deadline = straggler_deadline(per_dev, 1, quantile=quantile,
                                  alive=alive)
    if not np.isfinite(deadline):
        return ()
    m = int(cluster_of.max()) + 1
    live = (np.ones(len(per_dev), bool) if alive is None
            else np.asarray(alive, bool))
    out = []
    for i in range(m):
        sel = (cluster_of == i) & live
        compute = per_dev[sel].max(initial=0.0)
        eff_i = eff[sel].max(initial=0.0) if wire_dtype else 1.0
        if compute + float(backhaul) * eff_i > deadline:
            out.append(i)
    return tuple(out)


def per_device_energy(rho, theta, mu, nu, alpha, p, tau, *, wire_dtype=None,
                      wire_block=1024, dense_bits=16, alive=None):
    """Per-device energy of one edge round: rho*tau*alpha + p*eff(theta)*nu;
    ``alive`` zeroes the dropped devices (they never ran)."""
    eff = wire_fraction(theta, wire_dtype=wire_dtype, wire_block=wire_block,
                        dense_bits=dense_bits)
    e = rho * tau * alpha + p * eff * nu
    if alive is not None:
        e = e * np.asarray(alive, np.float64)
    return e


def round_energy(rho, theta, mu, nu, alpha, p, tau, *, wire_dtype=None,
                 wire_block=1024, dense_bits=16, alive=None):
    """Expected total energy of one edge round (sum over devices); dropped
    devices (``alive``) are not charged."""
    return float(np.sum(per_device_energy(
        rho, theta, mu, nu, alpha, p, tau, wire_dtype=wire_dtype,
        wire_block=wire_block, dense_bits=dense_bits, alive=alive)))
