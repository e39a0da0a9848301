"""Paper Fig. 6/7: the inter-cluster (q) and intra-cluster (tau)
aggregation periods against the cost to the target accuracy (port of
``benchmarks/fig67_periods.py``).

    PYTHONPATH=src python -m repro_torch.experiments.fig67_periods 40

Writes ``fig67_periods.json`` under ``common.RESULTS``."""
from __future__ import annotations

import sys

from repro_torch.experiments.common import (_DATASETS, calibrate_budgets,
                                            cost_to_target, run_scheme,
                                            save_json)


def main(rounds=50):
    target = _DATASETS["cifar"]["target_acc"]
    out = {}
    print("name,param,value,scheme,time_s,energy_J")
    for q in (2, 5, 10):
        tb, eb, cef_hist = calibrate_budgets("cifar", rounds=rounds, q=q)
        for scheme in ("hcef", "cef"):
            hist = (cef_hist if scheme == "cef" else run_scheme(
                scheme, dataset="cifar", q=q, rounds=rounds,
                time_budget=tb, energy_budget=eb))
            t, e = cost_to_target(hist, target)
            out[f"{scheme}_q{q}"] = {"time": t, "energy": e}
            print(f"fig6,q,{q},{scheme},{t},{e}")
    for tau in (2, 5, 10):
        tb, eb, cef_hist = calibrate_budgets("cifar", rounds=rounds, tau=tau)
        for scheme in ("hcef", "cef"):
            hist = (cef_hist if scheme == "cef" else run_scheme(
                scheme, dataset="cifar", tau=tau, rounds=rounds,
                time_budget=tb, energy_budget=eb))
            t, e = cost_to_target(hist, target)
            out[f"{scheme}_tau{tau}"] = {"time": t, "energy": e}
            print(f"fig7,tau,{tau},{scheme},{t},{e}")
    save_json("fig67_periods", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
