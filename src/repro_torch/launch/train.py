"""Federated training launcher, on the card unless ``--device cpu`` (port of
``repro/launch/train.py``, its ``--mesh host`` path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \
        --full --rounds 4 --seq 511
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
        --full --rounds 4 --seq 2047

runs the HCEF round step (``core/round.py``) on 2 clusters x 2 devices,
with the architecture's HCEF configuration, the online controller, the
Eq. 8/9 time and energy accounting against its budgets, and the
device-skewed synthetic token corpus, and prints one line per round: mean
loss, mean rho and theta, simulated time, wall ms and its split, and peak
device memory on the card.  ``--smoke`` (the default) runs the reduced
same-family config, ``--full`` the architecture itself.  ``--profile``
traces the rounds after the first with torch.profiler and prints the
device's busy share and its kernels by device time.

``--sparse-gossip`` (with ``--wire-dtype``) keeps the reference's
``--mesh host`` meaning: no policy, so the round takes the off-mesh
aggregate, while theta is quantized up to the level grid and the
simulated time and energy charge the wire's bytes (``dense_bits=16``).
``--wire-ef`` needs a policy and raises, as in the reference.  The fused
branch with the wire runs from ``make_round_step(..., policy=...)``
(``chip_smoke.py`` phase 12).

The numpy stream is the reference's: the corpus, then per round
``rng.integers(0, n_seq, (R, b_per_dev))`` from ``default_rng(0)``.  The
weights (``init`` from a seeded ``torch.Generator``) and the masked-step
bits (``bits_fn(1000 + round, rho)``) cannot be the reference's
``jax.random`` draws.

The dense archs (smollm-135M, qwen2-7b) train through the attention
kernels, forward and backward; ``--full --arch qwen2_7b`` needs four
7.6B replicas with f32 momentum, more than one card holds, and the memory
is the caller's problem, as in the reference.

Not ported, each exits naming its ROADMAP.md item: ``--mesh
single|multi`` (more than one rank), the overlap engine, population
mode, fault injection and checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.configs.base import FLTopology
from repro_torch.core.compression import quantize_theta
from repro_torch.core.controller import BudgetState
from repro_torch.core.round import init_state, make_round_step
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.device import resolve
from repro_torch.dist.collectives import MULTI_RANK
from repro_torch.fl.baselines import CONTROLLERS, make_controller
from repro_torch.fl.cost_model import round_energy, round_time
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.launch.profiling import activities, print_profile
from repro_torch.models.lm import param_count
from repro_torch.models.registry import get_model

_OVERLAP = "ROADMAP.md, modules to port, item 3 (overlap engine)"
_COHORTS = "ROADMAP.md, modules to port, item 2 (degraded mode and cohorts)"
# flag -> where it is ported; giving any of them exits
NOT_PORTED = {
    "overlap": _OVERLAP, "staleness": _OVERLAP, "stale_quantile": _OVERLAP,
    "population": _COHORTS, "cohort_seed": _COHORTS, "store_root": _COHORTS,
    "chaos": _COHORTS, "chaos_dropout": _COHORTS,
    "chaos_partition": _COHORTS, "chaos_coord_fail": _COHORTS,
    "chaos_seed": _COHORTS,
    "ckpt_dir": "ROADMAP.md, modules to port, item 7 (smokes and "
                "launchers: train checkpoints)",
}
N_SEQ = 32  # sequences per device in the corpus (train.py)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_1p3b", choices=ARCH_IDS)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--controller", default="hcef",
                    choices=sorted(CONTROLLERS))
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the rounds after the first and print the "
                         "device busy share and kernels by time")
    ap.add_argument("--sparse-gossip", action="store_true",
                    help="quantize theta to the level grid and charge the "
                         "gossip wire's bytes")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "int8", "int4", "fp8"])
    ap.add_argument("--wire-ef", action="store_true",
                    help="CHOCO wire error feedback (needs a policy: "
                         "raises on --mesh host, as in the reference)")
    for flag in ("--overlap", "--chaos"):
        ap.add_argument(flag, action="store_true", default=None,
                        help="not ported")
    for flag in ("--staleness", "--stale-quantile",
                 "--population", "--cohort-seed", "--store-root",
                 "--chaos-dropout", "--chaos-partition", "--chaos-coord-fail",
                 "--chaos-seed", "--ckpt-dir"):
        ap.add_argument(flag, default=None, help="not ported")
    return ap


def main(argv=None):
    """Run the launcher; returns {"history", "round_ms", "timings",
    "n_params", "cfg", "peak_mem_gb"}."""
    ap = parser()
    args = ap.parse_args(argv)
    for dest, where in NOT_PORTED.items():
        if getattr(args, dest) is not None:
            ap.error(f"--{dest.replace('_', '-')} is not ported yet: {where}")
    if args.mesh != "host":
        ap.error(f"--mesh {args.mesh} is not ported yet: {MULTI_RANK}")
    bundle = get_config(args.arch)
    cfg = smoke_model(bundle.model) if args.smoke else bundle.model
    hcef = bundle.hcef
    if args.sparse_gossip or args.wire_dtype or args.wire_ef:
        hcef = dataclasses.replace(
            hcef, sparse_gossip=hcef.sparse_gossip or args.sparse_gossip,
            wire_dtype=args.wire_dtype or hcef.wire_dtype,
            wire_ef=hcef.wire_ef or args.wire_ef)
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is f32

    topo = FLTopology(clusters=2, devices_per_cluster=2)
    R = topo.num_devices
    cluster_of = np.repeat(np.arange(topo.clusters), topo.devices_per_cluster)
    gen = torch.Generator(device=dev).manual_seed(0)
    params0 = get_model(cfg).init(cfg, gen, device=dev)
    n_params = param_count(params0)
    state = init_state(cfg, hcef, topo, params0, device=dev)
    del params0
    steps = {g: make_round_step(cfg, hcef, topo, gossip=g)
             for g in (False, True)}
    controller = make_controller(args.controller, hcef.tau,
                                 theta_min=hcef.theta_min,
                                 rho_min=hcef.rho_min)
    het = HeterogeneityModel(num_devices=R, model_bits=n_params * 16)
    budget = BudgetState(
        time_budget=hcef.time_budget or np.inf,
        energy_budget=hcef.energy_budget or np.inf,
        phi=max(args.rounds // hcef.q, 1), q=hcef.q,
        backhaul_time=het.backhaul_time())
    corpus = synthetic_tokens(cfg.vocab_size, n_seq=N_SEQ,
                              seq_len=args.seq + 1, n_devices=R, beta=0.5)
    rng = np.random.default_rng(0)
    b_per_dev = hcef.tau * 2
    # dense_bits=16: het's model_bits above is n_params * 16 (bf16)
    wire_kw = (dict(wire_dtype=hcef.wire_dtype, wire_block=hcef.wire_block,
                    dense_bits=16) if hcef.sparse_gossip else {})

    print(f"arch={args.arch} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}) mesh=host R={R} controller={args.controller} "
          f"params/replica={n_params:,} seq={args.seq + 1} on {dev}",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    history, round_ms, timings = [], [], {}

    def one_round(rnd):
        nonlocal state
        t0 = time.perf_counter()
        reports = het.sample_round(rnd)
        rho, theta = controller.controls(reports, budget)
        gossip = (rnd + 1) % hcef.q == 0
        if hcef.sparse_gossip:  # the wire ships grid levels only
            theta = quantize_theta(theta, hcef.theta_levels)
        idx = rng.integers(0, N_SEQ, (R, b_per_dev))
        tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
        state, m = steps[gossip](state, {"tokens": torch.from_numpy(tokens)},
                                 rho, theta, 1000 + rnd, timings=timings)
        t, _ = round_time(rho, theta, reports.mu, reports.nu, hcef.tau,
                          cluster_of, gossip=gossip,
                          backhaul=het.backhaul_time(), **wire_kw)
        e = round_energy(rho, theta, reports.mu, reports.nu, reports.alpha,
                         reports.p, hcef.tau, **wire_kw)
        budget.charge(t, e, gossip)
        loss = float(m["loss"].mean())  # waits for the round
        round_ms.append((time.perf_counter() - t0) * 1e3)
        rec = {"round": rnd, "loss": loss, "gossip": gossip,
               "rho_mean": float(np.mean(rho)),
               "theta_mean": float(np.mean(theta)),
               "time": budget.time_spent_prev + budget.time_spent_this,
               "energy": budget.energy_spent_prev + budget.energy_spent_this}
        split = "/".join(f"{timings[k][-1]:.0f}"
                         for k in ("device_round", "compress", "aggregate"))
        mem = (f" peak={torch.cuda.max_memory_allocated(dev) / 1e9:.2f}GB"
               if dev.type == "cuda" else "")
        print(f"round {rnd:3d} loss={loss:7.4f} rho={rec['rho_mean']:.2f} "
              f"theta={rec['theta_mean']:.2f} sim_t={rec['time']:9.0f}s "
              f"wall={round_ms[-1]:.0f}ms (device_round/compress/aggregate "
              f"{split} ms){mem}", flush=True)
        return rec

    prof, t_prof = None, 0.0
    with contextlib.ExitStack() as stack:
        for rnd in range(args.rounds):
            if args.profile and rnd == 1:  # after a warm-up round
                prof = stack.enter_context(torch.profiler.profile(
                    activities=activities(dev)))
                t_prof = time.perf_counter()
            history.append(one_round(rnd))
        wall = time.perf_counter() - t_prof
    if prof is not None:
        print_profile(prof, wall)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    return {"history": history, "round_ms": round_ms, "timings": timings,
            "n_params": n_params, "cfg": cfg, "peak_mem_gb": peak}


if __name__ == "__main__":
    main()
