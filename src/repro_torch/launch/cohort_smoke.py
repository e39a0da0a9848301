"""Cohort smoke: population-scale paging on the smoke smollm's round step
(port of ``repro/launch/cohort_smoke.py``).

    PYTHONPATH=src python -m repro_torch.launch.cohort_smoke \\
        --population 100000
    PYTHONPATH=src python -m repro_torch.launch.cohort_smoke --device cpu \\
        --population 1000 --rounds 2

On the card unless ``--device cpu``; exits nonzero unless every cohort
contract holds (DESIGN.md §Cohort contract):

  * a population much larger than R (default 100k logical clients behind
    R = 64 slots) runs with finite losses, parameters and EF, and a
    working set within ``resident_max``, never O(population);
  * the population-global EF sum (float64, in id order) is the same,
    under ==, before and after every cohort swap;
  * page files exist only for clients that took part;
  * population == R is bit for bit the fixed roster (parameters, EF and
    losses).
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.configs.base import FLTopology, HCEFConfig
from repro_torch.core.round import (client_template, init_state,
                                    make_round_step, split_state)
from repro_torch.device import resolve
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.launch.chaos_smoke import finite
from repro_torch.models import lm
from repro_torch.runtime.elastic import cohort_swap
from repro_torch.runtime.population import PopulationStore
from repro_torch.tree import flatten


def _run(cfg, hcef, topo, rounds, dev, *, population=0, cohort_seed=0,
         store_root=None, resident_max=None, seed=0):
    """One training cell (population=0: the fixed roster).  Returns
    (state, losses, store, max_resident, ef_conserved)."""
    R = topo.num_devices
    state = init_state(cfg, hcef, topo, lm.init(cfg, seed=seed, device=dev),
                       device=dev)
    step = {g: make_round_step(cfg, hcef, topo, gossip=g)
            for g in (True, False)}
    het = HeterogeneityModel(num_devices=R, population=population,
                             seed=seed)
    store = cohort_ids = None
    if population:
        # 2R resident: a multi-round run spills pages, still O(cohort)
        store = PopulationStore(population, client_template(state),
                                root=store_root,
                                resident_max=resident_max or 2 * R)
    rng = np.random.default_rng(seed)
    losses = []
    max_resident = 0
    ef_conserved = True
    for rnd in range(rounds):
        if store is not None:
            new_ids = (het.sample_cohort(rnd, R, seed=cohort_seed)
                       if population > R else np.arange(R, dtype=np.int64))
            _, client = split_state(state)
            if cohort_ids is None:
                store.gather(new_ids, out=client)
            else:
                before = store.aggregate("ef", extra_ids=cohort_ids,
                                         extra=client)
                cohort_swap(client, cohort_ids, new_ids, store)
                after = store.aggregate("ef", extra_ids=new_ids,
                                        extra=client)
                ef_conserved &= bool(before == after)
            cohort_ids = new_ids
            max_resident = max(max_resident, store.resident_count)
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (R * hcef.tau * 2, 32)))}
        gossip = (rnd + 1) % hcef.q == 0
        state, m = step[gossip](state, batch, np.ones(R), np.full(R, 0.3),
                                1000 + rnd)
        if store is not None:
            store.record_round(cohort_ids, rnd)
        losses.append(float(m["loss"].mean()))
        res = (f" res={store.resident_count}/{store.resident_max}"
               if store is not None else "")
        print(f"  round {rnd:2d} loss={losses[-1]:7.4f}{res}", flush=True)
    return state, losses, store, max_resident, ef_conserved


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--population", type=int, default=100_000)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cohort-seed", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    # a tiny smollm: pages of about 100 KB a client
    cfg = smoke_model(get_config("smollm_135m").model).replace(
        d_model=32, d_ff=64)
    hcef = HCEFConfig(tau=2, q=2, eta=0.1, momentum=0.0)
    failures = []

    topo = FLTopology(clusters=8, devices_per_cluster=8)  # R = 64
    R = topo.num_devices
    if args.population <= R:
        raise SystemExit(f"--population must exceed R={R}")
    with tempfile.TemporaryDirectory(prefix="cohort_smoke_") as td:
        print(f"population run: N={args.population:,} R={R}")
        state, losses, store, max_res, ef_ok = _run(
            cfg, hcef, topo, args.rounds, dev, population=args.population,
            cohort_seed=args.cohort_seed, store_root=Path(td),
            seed=args.seed)
        if not (finite(state.params) and finite(state.ef)
                and np.all(np.isfinite(losses))):
            failures.append("NaN/inf in population run")
        if max_res > store.resident_max:
            failures.append(f"working set {max_res} exceeded resident_max "
                            f"{store.resident_max}")
        if not ef_ok:
            failures.append("EF aggregate NOT conserved across cohort swap")
        pages = {int(p.name[7:15]) for p in Path(td).glob("client_*.npy")}
        took_part = set(np.flatnonzero(store.rounds_participated > 0))
        print(f"  touched={len(store.touched)} page files for "
              f"{len(pages)} clients, participated={len(took_part)} "
              f"max_resident={max_res}")
        if len(store.touched) > args.rounds * R:
            failures.append(f"{len(store.touched)} clients hold state; at "
                            f"most rounds*R={args.rounds * R} took part")
        if not pages <= took_part:
            failures.append(f"page files for clients that never took "
                            f"part: {sorted(pages - took_part)[:8]}")

    topo_s = FLTopology(clusters=2, devices_per_cluster=2)
    print("identity run (fixed roster):")
    s_ref, l_ref, *_ = _run(cfg, hcef, topo_s, 6, dev, seed=args.seed)
    print("identity run (population == R, store engaged):")
    s_pop, l_pop, *_ = _run(cfg, hcef, topo_s, 6, dev, seed=args.seed,
                            population=topo_s.num_devices)
    if l_ref != l_pop:
        failures.append("population == R losses diverged from the roster")
    for name, a, b in (("params", s_ref.params, s_pop.params),
                       ("ef", s_ref.ef, s_pop.ef)):
        fa, fb = flatten(a), flatten(b)
        if not all(torch.equal(fa[k], fb[k]) for k in fa):
            failures.append(f"population == R {name} not bit-identical")

    if failures:
        for f in failures:
            print(f"COHORT SMOKE FAIL: {f}", file=sys.stderr)
        return 1
    print("cohort smoke: all population-engine contracts hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
