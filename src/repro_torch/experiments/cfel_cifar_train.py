"""End-to-end driver of the paper's CFEL experiment at reduced scale (port
of ``examples/cfel_cifar_train.py``).

    PYTHONPATH=src python -m repro_torch.experiments.cfel_cifar_train \
        [--scheme hcef] [--rounds 30] [--ckpt-dir DIR] [--device cpu]

Runs HCEF (or a baseline) on synthetic CIFAR with the paper's device
heterogeneity, budget accounting, coordinator failover
(``runtime/failover.CoordinatorRegistry``) and a checkpoint every 5
rounds (``FedSim.save``; a ``FedSim.restore`` of it continues bit for
bit).  The checkpoints go under ``--ckpt-dir``, by default
``common.RESULTS / "cfel_ckpts"``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from repro_torch.experiments.common import RESULTS, SCHEMES, make_sim
from repro_torch.runtime.failover import CoordinatorRegistry

CKPT_EVERY = 5


def make_cfel_sim(scheme: str = "hcef", device=None, **kw):
    """The example's FedSim: 16 devices in 8 clusters on the ring, with its
    budgets."""
    return make_sim(scheme, dataset="cifar", n_devices=16, n_clusters=8,
                    time_budget=6e4, energy_budget=6e3, device=device, **kw)


def main(argv=None):
    """Run the example; returns the FedSim after its last round."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheme", default="hcef", choices=SCHEMES)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=str(RESULTS / "cfel_ckpts"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    sim = make_cfel_sim(args.scheme, device=args.device)
    registry = CoordinatorRegistry(num_servers=8, fail_prob=0.05)

    print(f"scheme={args.scheme}  16 devices / 8 clusters / ring backhaul "
          f"on {sim.device}")
    print("round  loss   acc    rho    theta  time(s)  energy(J)  coord")
    for r in range(args.rounds):
        coord = registry.step()
        rec = sim.run_round()
        if (r + 1) % CKPT_EVERY == 0:
            rec["acc"] = sim.eval_acc()
            sim.save(Path(args.ckpt_dir) / f"ckpt_{sim.round:06d}.npz")
        print(f"{rec['round']:5d}  {rec['loss']:5.2f}  "
              f"{rec.get('acc', float('nan')):5.3f}  "
              f"{rec['rho_mean']:5.2f}  {rec['theta_mean']:5.2f}  "
              f"{rec['time']:7.0f}  {rec['energy']:9.0f}  s{coord}")
    print(f"coordinator re-elections survived: {registry.elections}")
    print(f"final accuracy (averaged model): {sim.eval_acc():.3f}")
    return sim


if __name__ == "__main__":
    main()
