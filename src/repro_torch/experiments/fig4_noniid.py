"""Paper Fig. 4: time and energy to the target accuracy against the non-IID
level beta (port of ``benchmarks/fig4_noniid.py``).

    PYTHONPATH=src python -m repro_torch.experiments.fig4_noniid 40

Writes ``fig4_noniid.json`` under ``common.RESULTS``."""
from __future__ import annotations

import sys

from repro_torch.experiments.common import (_DATASETS, calibrate_budgets,
                                            cost_to_target, run_scheme,
                                            save_json)


def main(rounds=50):
    target = _DATASETS["cifar"]["target_acc"]
    out = {}
    print("name,beta,scheme,time_s,energy_J")
    for beta in (0.1, 0.5, 1.0):
        tb, eb, cef_hist = calibrate_budgets("cifar", rounds=rounds,
                                             beta=beta)
        for scheme in ("hcef", "cef", "cef_f"):
            hist = (cef_hist if scheme == "cef" else run_scheme(
                scheme, dataset="cifar", beta=beta, rounds=rounds,
                time_budget=tb, energy_budget=eb))
            t, e = cost_to_target(hist, target)
            out[f"{scheme}_beta{beta}"] = {
                "time": t, "energy": e,
                "best_acc": max((h.get("acc", 0) for h in hist), default=0)}
            print(f"fig4,{beta},{scheme},{t},{e}")
    save_json("fig4_noniid", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
