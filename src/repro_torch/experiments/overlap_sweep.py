"""Convergence against staleness for the overlapped round engine (port of
``benchmarks/overlap_sweep.py``).

    PYTHONPATH=src python -m repro_torch.experiments.overlap_sweep 10

Runs the smoke LM (smollm's smoke config at d_model 64, 2 x 2 devices, tau
= q = 2) for the same rounds, batches and bits under the synchronous
step (staleness 0) and the bounded-stale overlapped step (staleness 1,
every cluster stale: the worst case), and records the two loss
trajectories.  Beside them the cost model prices each round under both
engines on the ``tpu_pod`` heterogeneity profile, where the inter-cluster
transfer is comparable to tau local steps: staleness 1 pays a bounded
quality gap a round and buys back wall clock by hiding the gossip behind
local compute.  Writes ``overlap_sweep.json`` under ``common.RESULTS``.

The reference draws its tokens and keys with ``jax.random``; here round
``rnd``'s tokens come from ``default_rng(100 + rnd)`` and its masked-step
bits from ``bits_fn(200 + rnd, rho)``.  ``params0`` (default: the port's
init seeded 0), ``batches`` (a token array a round) and ``bits_fn`` take
the reference's; on the card unless ``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.configs.base import FLTopology, HCEFConfig
from repro_torch.core.round import (init_overlap_state, init_state,
                                    make_overlap_round_step, make_round_step)
from repro_torch.experiments.common import save_json
from repro_torch.fl.cost_model import overlap_round_time, round_time
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.models.registry import get_model

SEQ = 32  # tokens a sequence (31 positions and the next token)


def sweep_setup():
    """(cfg, topo, hcef) of the sweep."""
    cfg = smoke_model(get_config("smollm_135m").model).replace(
        d_model=64, d_ff=128)
    topo = FLTopology(clusters=2, devices_per_cluster=2)
    hcef = HCEFConfig(tau=2, q=2, eta=0.1, momentum=0.0)
    return cfg, topo, hcef


def default_batches(rounds: int, R: int, vocab: int):
    """Round ``rnd``'s (R * tau * 2, SEQ) tokens from ``default_rng(100 +
    rnd)``."""
    return [np.random.default_rng(100 + rnd).integers(0, vocab,
                                                      (R * 2 * 2, SEQ))
            for rnd in range(rounds)]


def _run(staleness: int, rounds: int, cfg, topo, hcef, *, params0=None,
         batches=None, bits_fn=None, device=None):
    R = topo.num_devices
    if params0 is None:
        params0 = get_model(cfg).init(cfg, seed=0, device=device)
    if batches is None:
        batches = default_batches(rounds, R, cfg.vocab_size)
    if staleness:
        hcef = dataclasses.replace(hcef, overlap=True, staleness=1)
        state = init_overlap_state(cfg, hcef, topo, params0, device=device)
    else:
        state = init_state(cfg, hcef, topo, params0, device=device)
    steps = {g: (make_overlap_round_step if staleness else make_round_step)(
        cfg, hcef, topo, gossip=g, bits_fn=bits_fn) for g in (False, True)}
    rho = np.ones(R, np.float32)
    theta = np.full(R, 0.25, np.float32)
    losses = []
    for rnd in range(rounds):
        batch = {"tokens": torch.as_tensor(np.array(batches[rnd]),
                                           dtype=torch.int64)}
        gossip = (rnd + 1) % hcef.q == 0
        state, m = steps[gossip](state, batch, rho, theta, 200 + rnd)
        losses.append(float(m["loss"].mean()))
    return losses


def modeled_times(rounds: int, topo, hcef):
    """Each engine's cumulative modeled wall clock a round on the
    ``tpu_pod`` profile with smollm-scale weights, where the ~43 s
    inter-cluster transfer over the 50 Mbps backhaul is comparable to tau
    local steps (on ``paper_edge`` local compute dominates by 1000x):
    staleness 1 turns compute + gossip into max(compute, gossip) for the
    stale clusters."""
    R = topo.num_devices
    het = HeterogeneityModel(num_devices=R, profile="tpu_pod",
                             base_step_time=10.0, model_bits=135e6 * 16)
    cluster_of = np.repeat(np.arange(topo.clusters),
                           topo.devices_per_cluster)
    rho_m, th_m = np.ones(R), np.full(R, 0.25)
    bh = het.backhaul_time()
    t0 = t1 = 0.0
    times = {"0": [], "1": []}
    for rnd in range(rounds):
        rep = het.sample_round(rnd)
        gossip = (rnd + 1) % hcef.q == 0
        ts, _ = round_time(rho_m, th_m, rep.mu, rep.nu, hcef.tau,
                           cluster_of, gossip=gossip, backhaul=bh)
        tv, _ = overlap_round_time(rho_m, th_m, rep.mu, rep.nu, hcef.tau,
                                   cluster_of, gossip=gossip, backhaul=bh,
                                   stale_clusters=tuple(
                                       range(topo.clusters)))
        t0, t1 = t0 + ts, t1 + tv
        times["0"].append(t0)
        times["1"].append(t1)
    return times


def main(rounds: int = 10, **run_kw):
    """``run_kw``: ``_run``'s ``params0``, ``batches``, ``bits_fn`` and
    ``device``, the same for both engines."""
    cfg, topo, hcef = sweep_setup()
    out = {"rounds": rounds, "tau": hcef.tau, "q": hcef.q,
           "losses": {s: _run(int(s), rounds, cfg, topo, hcef, **run_kw)
                      for s in ("0", "1")}}
    times = modeled_times(rounds, topo, hcef)
    t0, t1 = times["0"][-1], times["1"][-1]
    out["modeled_time_s"] = times
    out["modeled_speedup"] = t0 / t1

    p = save_json("overlap_sweep", out)
    f0, f1 = out["losses"]["0"][-1], out["losses"]["1"][-1]
    print(f"overlap sweep ({rounds} rounds): final loss "
          f"staleness0={f0:.4f} staleness1={f1:.4f} "
          f"(gap {f1 - f0:+.4f}); modeled wall-clock "
          f"{t0:.0f}s -> {t1:.0f}s ({out['modeled_speedup']:.2f}x)")
    print(f"wrote {p}")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
