"""Chaos smoke: seeded fault injection on the smoke smollm's round step
(port of ``repro/launch/chaos_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke --rounds 12
    PYTHONPATH=src python -m repro_torch.launch.chaos_smoke --device cpu

Runs the smoke smollm round step on the host topology (2 x 2) three
times, fault-free, under chaos (dropout, partitions, coordinator churn)
and a replay of the chaos run with the same seed, on the card unless
``--device cpu``, and exits nonzero unless every degraded-mode contract
holds (DESIGN.md §Degraded-mode contract):

  * the chaos run has finite losses, parameters and EF;
  * the replay is bit for bit the chaos run;
  * participation is reported every round and falls below 1;
  * a fully dropped, partitioned cluster keeps its model bit for bit
    while its EF takes the pending updates;
  * the chaos run's final loss is within --loss-tol of the fault-free
    run's at equal rounds.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.configs.base import FLTopology, HCEFConfig
from repro_torch.core.round import init_state, make_round_step
from repro_torch.device import resolve
from repro_torch.dist.collectives import participation_weights
from repro_torch.fl.cost_model import per_device_time
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.models import lm
from repro_torch.runtime.chaos import ChaosConfig, FaultPlan
from repro_torch.tree import flatten


def finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in flatten(tree).values())


def _run(cfg, hcef, topo, rounds, chaos_cfg, het, dev, seed=0):
    """One training cell; returns (state, losses, participations)."""
    R = topo.num_devices
    C, Dev = topo.clusters, topo.devices_per_cluster
    params0 = lm.init(cfg, seed=seed, device=dev)
    state = init_state(cfg, hcef, topo, params0, device=dev)
    plan = FaultPlan(chaos_cfg, R, C) if chaos_cfg is not None else None
    steps = {g: make_round_step(cfg, hcef, topo, gossip=g)
             for g in (True, False)}
    rng = np.random.default_rng(seed)
    rho, theta = np.ones(R), np.full(R, 0.3)
    losses, parts = [], []
    for rnd in range(rounds):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (R * hcef.tau * 2, 32)))}
        gossip = (rnd + 1) % hcef.q == 0
        masks = {}
        if plan is not None:
            reports = het.sample_round(rnd)
            faults = plan.step(rnd, gossip_round=gossip,
                               per_device_time=per_device_time(
                                   rho, theta, reports.mu, reports.nu,
                                   hcef.tau))
            parts.append(faults.participation)
            alive, conn = faults.alive, faults.cluster_conn
            if not (alive.all() and conn.all()):
                masks = dict(alive=alive.astype(np.float32),
                             alive_w=participation_weights(
                                 alive, clusters=C, dev=Dev),
                             conn=conn.astype(np.float32))
        state, m = steps[gossip](state, batch, rho, theta, 1000 + rnd,
                                 **masks)
        losses.append(float(m["loss"].mean()))
        tag = f" part={parts[-1]:.2f}" if plan is not None else ""
        print(f"  round {rnd:2d} loss={losses[-1]:7.4f}{tag}", flush=True)
    return state, losses, parts


def dead_cluster_check(cfg, hcef, topo, dev):
    """One gossip round with cluster 1 fully dropped and partitioned:
    returns (its parameters kept bit for bit, its EF nonzero)."""
    R, C, Dev = topo.num_devices, topo.clusters, topo.devices_per_cluster
    state0 = init_state(cfg, hcef, topo, lm.init(cfg, seed=0, device=dev),
                        device=dev)
    before = {k: v.clone() for k, v in flatten(state0.params).items()}
    step = make_round_step(cfg, hcef, topo, gossip=True)
    alive = np.array([1, 1, 0, 0], np.float32)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (R * hcef.tau * 2, 32)))}
    s1, _ = step(state0, batch, np.ones(R), np.full(R, 0.3), 3,
                 alive=alive,
                 alive_w=participation_weights(alive, clusters=C, dev=Dev),
                 conn=np.array([1.0, 0.0], np.float32))
    kept = all(torch.equal(before[k][Dev:], p[Dev:])
               for k, p in flatten(s1.params).items())
    moved = any(float(e[Dev:].abs().max()) > 0
                for e in flatten(s1.ef).values())
    return kept, moved


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--dropout", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss-tol", type=float, default=0.05,
                    help="largest fractional final-loss gap to the "
                         "fault-free run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = smoke_model(get_config("smollm_135m").model).replace(
        d_model=64, d_ff=128)
    topo = FLTopology(clusters=2, devices_per_cluster=2)
    hcef = HCEFConfig(tau=2, q=2, eta=0.1, momentum=0.0)
    het = HeterogeneityModel(num_devices=topo.num_devices, seed=args.seed)
    chaos = ChaosConfig(seed=args.seed, dropout_prob=args.dropout,
                        partition_prob=0.2, partition_recover_prob=0.5,
                        coordinator_fail_prob=0.3)
    failures = []

    print("fault-free run:")
    _, l_ref, _ = _run(cfg, hcef, topo, args.rounds, None, het, dev)
    print("chaos run:")
    s_ch, l_ch, parts = _run(cfg, hcef, topo, args.rounds, chaos, het, dev)
    print("chaos replay:")
    s_rp, _, parts_rp = _run(cfg, hcef, topo, args.rounds, chaos, het, dev)

    if not (finite(s_ch.params) and finite(s_ch.ef)
            and np.all(np.isfinite(l_ch))):
        failures.append("NaN/inf in chaotic run")
    pa, pb = flatten(s_ch.params), flatten(s_rp.params)
    if not all(torch.equal(pa[k], pb[k]) for k in pa):
        failures.append("chaos replay is not bit-identical")
    if parts != parts_rp:
        failures.append("fault trace replay diverged")
    if len(parts) != args.rounds:
        failures.append("participation missing for some rounds")
    if not any(p < 1.0 for p in parts):
        failures.append(f"dropout={args.dropout} never dropped a device")
    kept, moved = dead_cluster_check(cfg, hcef, topo, dev)
    if not kept:
        failures.append("partitioned dead cluster did not keep its model")
    if not moved:
        failures.append("dropped devices' EF did not absorb their updates")
    gap = abs(l_ch[-1] - l_ref[-1]) / max(abs(l_ref[-1]), 1e-9)
    print(f"final loss: fault-free={l_ref[-1]:.4f} chaos={l_ch[-1]:.4f} "
          f"gap={100 * gap:.2f}% (tol {100 * args.loss_tol:.0f}%)  "
          f"mean participation={np.mean(parts):.2f}")
    if gap > args.loss_tol:
        failures.append(f"loss gap {100 * gap:.2f}% exceeds tolerance")
    if failures:
        for f in failures:
            print(f"CHAOS SMOKE FAIL: {f}", file=sys.stderr)
        return 1
    print("chaos smoke: all degraded-mode contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
