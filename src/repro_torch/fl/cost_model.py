"""Time (Eq. 8) and energy (Eq. 9) of one edge round (own copy of
``repro/fl/cost_model.py``, numpy).

With ``wire_dtype=None`` a theta-compressed upload costs ``theta * nu``;
with a wire dtype the effective fraction is the exact byte ratio of the
sparse (value, offset) encoding (``core.wire_format``), capped at 1.0.
The gossip backhaul term is charged per cluster at its own level.
Degraded mode: ``alive`` (an (N,) device mask) charges live devices only,
``conn`` (a (C,) backhaul mask) skips a partitioned cluster's gossip.
``overlap_round_time`` and ``decide_stale_clusters`` wait for the overlap
slice (ROADMAP.md, modules to port, item 3).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.wire_format import compression_ratio_bytes


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
