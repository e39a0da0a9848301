"""Quickstart: HCEF federated training of a small LM (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.experiments.quickstart [--device cpu]

Four FL devices in two clusters cooperatively train the reduced smollm on
a synthetic corpus; per-device (rho, theta) controls come from the HCEF
controller under the reference's time / energy budgets (3e4 s, 4e3 J over
phi = 12 global rounds).  tau = 4 local steps, gossip every q = 2 rounds,
12 rounds, the reference's printed table.  The corpus and the batches are
the reference's numpy stream; the weights (``lm.init`` seeded 0) and the
masked-step bits (``core.round.bernoulli_bits`` of key 100 + round)
cannot be the reference's ``jax.random`` draws, so ``run`` takes both
(``params0``, ``bits_fn``).  On the card unless ``--device`` says
otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.configs.base import FLTopology, HCEFConfig
from repro_torch.core.controller import BudgetState
from repro_torch.core.round import init_state, make_round_step
from repro_torch.data.synthetic import synthetic_tokens
from repro_torch.fl.baselines import make_controller
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.models import lm
from repro_torch.tree import flatten

ROUNDS = 12


def setup():
    """(cfg, topo, hcef): the reduced smollm, 2 clusters of 2, tau 4, q 2."""
    cfg = smoke_model(get_config("smollm_135m").model)
    topo = FLTopology(clusters=2, devices_per_cluster=2)
    hcef = HCEFConfig(tau=4, q=2, eta=0.1, momentum=0.9)
    return cfg, topo, hcef


def rounds_iter(rounds: int = ROUNDS, *, device=None, params0=None,
                bits_fn=None):
    """The example's loop, one round a step: yields (row, state) after
    each round, the row's loss, rho_mean, theta_mean and the running
    simulated time and energy.  The state is updated in place (the round
    step's), so a caller may write into it between rounds."""
    cfg, topo, hcef = setup()
    R = topo.num_devices
    if params0 is None:
        params0 = lm.init(cfg, seed=0, device="cpu")
    state = init_state(cfg, hcef, topo, params0, device=device)
    steps = {g: make_round_step(cfg, hcef, topo, gossip=g, bits_fn=bits_fn)
             for g in (False, True)}

    corpus = synthetic_tokens(cfg.vocab_size, n_seq=64, seq_len=33,
                              n_devices=R, beta=0.5)
    controller = make_controller("hcef", hcef.tau)
    het = HeterogeneityModel(num_devices=R, model_bits=2.3e6 * 32)
    budget = BudgetState(time_budget=3e4, energy_budget=4e3, phi=12,
                         q=hcef.q, backhaul_time=het.backhaul_time())

    rng = np.random.default_rng(0)
    for rnd in range(rounds):
        reports = het.sample_round(rnd)
        rho, theta = controller.controls(reports, budget)
        idx = rng.integers(0, corpus.shape[1], (R, hcef.tau * 2))
        batch = {"tokens": torch.from_numpy(
            np.concatenate([corpus[d, idx[d]] for d in range(R)]))}
        gossip = (rnd + 1) % hcef.q == 0
        state, m = steps[gossip](state, batch,
                                 np.asarray(rho, np.float32),
                                 np.asarray(theta, np.float32), 100 + rnd)
        t = float(np.max(rho * hcef.tau * reports.mu + theta * reports.nu))
        e = float(np.sum(rho * hcef.tau * reports.alpha
                         + reports.p * theta * reports.nu))
        budget.time_spent_this += t
        budget.energy_spent_this += e
        budget.r += 1
        if gossip:
            budget.time_spent_prev += budget.time_spent_this
            budget.energy_spent_prev += budget.energy_spent_this
            budget.time_spent_this = budget.energy_spent_this = 0.0
            budget.r = 0
            budget.l += 1
        yield ({"round": rnd, "loss": float(m["loss"].mean()),
                "rho_mean": float(np.mean(rho)),
                "theta_mean": float(np.mean(theta)),
                "time": budget.time_spent_prev + budget.time_spent_this,
                "energy": (budget.energy_spent_prev
                           + budget.energy_spent_this)}, state)


def run(rounds: int = ROUNDS, *, device=None, params0=None, bits_fn=None,
        verbose: bool = True):
    """The example, printing its table.  Returns (one row a round, the
    final state)."""
    rows, state = [], None
    if verbose:
        print("round  loss    rho(mean)  theta(mean)  sim_time  sim_energy")
    for row, state in rounds_iter(rounds, device=device, params0=params0,
                                  bits_fn=bits_fn):
        rows.append(row)
        if verbose:
            print(f"{row['round']:5d}  {row['loss']:6.3f}  "
                  f"{row['rho_mean']:9.2f}  {row['theta_mean']:11.2f}  "
                  f"{row['time']:8.0f}  {row['energy']:10.0f}")
    first = flatten(state.params)[min(flatten(state.params))]
    if verbose:
        print("done — edge models reached consensus within clusters:",
              bool(torch.allclose(first[0], first[1])))
    return rows, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    return run(args.rounds, device=args.device)


if __name__ == "__main__":
    main()
