"""Cohort-engine benchmarks: paging throughput and a FedProx sweep (port of
``benchmarks/cohort_bench.py``).

    PYTHONPATH=src python -m repro_torch.experiments.cohort_bench

``bench_rows()`` times ``elastic.cohort_swap`` against the population
store in its two regimes:

  * ``cohort_swap_resident``: the whole rotation hits the LRU working set
    (host copies only);
  * ``cohort_swap_paged``: the residency is below the rotation, so every
    swap spills outgoing clients to ``.npy`` pages and reads incoming
    ones back (a large population's steady state).

Here the slots' state lies on the device (the card unless ``device``
says otherwise), so a swap also moves it between card and host.  The
derived column is clients/s through the swap (R out and R in a call).

``sweep()`` is the cohort regime's convergence check: plain SGD against
the FedProx proximal objective on a FedSim whose population is six times
its cohort, where cohort sampling makes client drift real; it prints the
equal-rounds loss gap.  The reference draws the sweep model's weights
and the masked-step bits with ``jax.random``; ``params0`` and
``bits_fn`` take them, and default to a ``torch.Generator`` seeded 0 and
``core.round.bernoulli_bits``.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.data.synthetic import client_image_shard
from repro_torch.device import resolve
from repro_torch.fl.baselines import make_controller
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.runtime.driver import FedSim, FedSimConfig
from repro_torch.runtime.elastic import cohort_swap, verified_swap
from repro_torch.runtime.population import PopulationStore


def _mk_store(population, d, root=None, resident_max=256):
    meta = torch.empty((d,), dtype=torch.float32, device="meta")
    return PopulationStore(population, {"ef": meta, "mom": meta},
                           root=root, resident_max=resident_max)


def _time_swaps(store, R, d, n_iter, seed=0, device=None, checks=None):
    dev = resolve(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    rng = np.random.default_rng(seed)
    ids = rng.choice(store.population, R, replace=False)
    state = {k: torch.from_numpy(rng.normal(0, 1, (R, d)).astype(
        np.float32)).to(dev) for k in ("ef", "mom")}
    # warm: the first cohort in place, so that the timing is steady state
    new = rng.choice(store.population, R, replace=False)
    state = cohort_swap(state, ids, new, store)
    sync()
    t0 = time.perf_counter()
    prev = new
    for _ in range(n_iter):
        new = rng.choice(store.population, R, replace=False)
        state = cohort_swap(state, prev, new, store)
        prev = new
    sync()
    dt = time.perf_counter() - t0
    us = dt / n_iter * 1e6
    clients_per_s = 2 * R * n_iter / dt  # R out + R in a swap
    if checks is not None:  # one more swap, between the population's sums
        new = rng.choice(store.population, R, replace=False)
        checks.append(verified_swap(
            lambda: cohort_swap(state, prev, new, store), store, state,
            prev, new))
    return us, clients_per_s


def bench_rows(smoke: bool = True, device=None, checks=None):
    """(name, us_per_call, derived) rows.  ``checks``: a list that gains
    the ``elastic.verified_swap`` record of one swap after each timing."""
    R, d = 64, 25_000  # ~100 KB f32 a client a field
    pop = 10_000
    n_iter = 10 if smoke else 50
    rows = []

    store = _mk_store(pop, d)  # root=None: fully resident
    us, cps = _time_swaps(store, R, d, n_iter, device=device, checks=checks)
    rows.append(("cohort_swap_resident", us,
                 f"{cps / 1e3:.1f}k_clients_per_s_R{R}_d{d}"))

    with tempfile.TemporaryDirectory(prefix="cohort_bench_") as td:
        # residency below 2R: every rotation evicts and pages from disk
        store = _mk_store(pop, d, root=Path(td), resident_max=R)
        us, cps = _time_swaps(store, R, d, n_iter, device=device,
                              checks=checks)
        rows.append(("cohort_swap_paged", us,
                     f"{cps / 1e3:.1f}k_clients_per_s_R{R}_d{d}"))
    return rows


def sweep_model():
    """(init_fn(gen), loss_fn, acc_fn) of the sweep's 48-32-10 tanh MLP."""
    def init_fn(gen):
        return {"w1": torch.randn((48, 32), generator=gen) * 0.1,
                "b1": torch.zeros(32),
                "w2": torch.randn((32, 10), generator=gen) * 0.1}

    def logits(p, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        return torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]

    def loss_fn(p, batch):
        logp = torch.log_softmax(logits(p, batch), dim=-1)
        return -torch.mean(torch.gather(
            logp, -1, batch["labels"].long()[:, None])[:, 0])

    def acc_fn(p, batch):
        return torch.mean((torch.argmax(logits(p, batch), -1)
                           == batch["labels"].long()).float())

    return init_fn, loss_fn, acc_fn


def shard(cid):
    """Client ``cid``'s 64 heavily non-IID images, 4x4x3 = 48 features:
    cohort drift is the point."""
    xs, ys = client_image_shard("cifar", 64, cid, beta=0.1, seed=0)
    return np.ascontiguousarray(xs[:, ::8, ::8]), ys


def sweep(rounds: int = 8, population: int = 48, cohort: int = 8, *,
          params0=None, bits_fn=None, device=None,
          verify_conservation=False, on_sim=None):
    """Cohort-regime smoke: SGD against the FedProx local objective, equal
    rounds.  Returns {objective: (final loss, final accuracy)};
    ``on_sim(objective, sim)`` sees each FedSim after its run."""
    init_fn, loss_fn, acc_fn = sweep_model()
    if params0 is None:
        params0 = init_fn(torch.Generator().manual_seed(0))
    test = shard(population)  # a held-out pseudo-client
    out = {}
    for objective in ("sgd", "fedprox"):
        cfg = FedSimConfig(n_devices=cohort, n_clusters=4, tau=4, q=2,
                           batch_size=16, seed=0, population=population,
                           local_objective=objective, prox_mu=0.1)
        het = HeterogeneityModel(num_devices=cohort, population=population,
                                 seed=0, model_bits=1e5)
        sim = FedSim(cfg, params0=params0, loss_fn=loss_fn, acc_fn=acc_fn,
                     device_data=None, data_fn=shard, test_data=test,
                     controller=make_controller("hcef", 4), het=het,
                     time_budget=1e6, energy_budget=1e7, phi=1000,
                     bits_fn=bits_fn, device=device,
                     verify_conservation=verify_conservation)
        hist = sim.run(rounds, eval_every=rounds)
        out[objective] = (hist[-1]["loss"], hist[-1].get("acc", 0.0))
        if on_sim is not None:
            on_sim(objective, sim)
        print(f"  {objective:8s} loss={hist[-1]['loss']:.4f} "
              f"acc={hist[-1].get('acc', 0.0):.3f} "
              f"(population={population} cohort={cohort})")
    gap = out["sgd"][0] - out["fedprox"][0]
    print(f"  fedprox equal-rounds loss delta vs sgd: {gap:+.4f}")
    return out


def main(rounds: int = 8, device=None):
    rows = bench_rows(smoke=True, device=device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    print("cohort sweep: sgd vs fedprox under cohort sampling")
    sweep(rounds=rounds, device=device)
    return rows


if __name__ == "__main__":
    main()
