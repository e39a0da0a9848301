"""Paper Fig. 2 (CIFAR-10) and Fig. 3 (FEMNIST): accuracy against time and
energy for HCEF, CEF, CEF-F, CEF-C and MLL-SGD, plus Table 2 (the
resources spent to reach the target accuracy) and Fig. 8 (the sigma^2 and
G^2 traces in HCEF's history); port of ``benchmarks/fig2_3_convergence.py``.

    PYTHONPATH=src python -m repro_torch.experiments.fig2_3_convergence 60

Times and energies are the cost model's simulated seconds and joules (Eq.
8/9).  Writes ``fig23_{dataset}.json`` under ``common.RESULTS``."""
from __future__ import annotations

import sys

from repro_torch.experiments.common import (SCHEMES, _DATASETS,
                                            calibrate_budgets,
                                            cost_to_target, run_scheme,
                                            save_json)


def run(dataset: str, rounds: int = 60, seed: int = 0):
    target = _DATASETS[dataset]["target_acc"]
    tb, eb, cef_hist = calibrate_budgets(dataset, rounds=rounds, seed=seed)
    out = {"dataset": dataset, "target_acc": target,
           "time_budget": tb, "energy_budget": eb,
           "histories": {"cef": cef_hist}}
    for scheme in SCHEMES:
        if scheme == "cef":
            continue
        out["histories"][scheme] = run_scheme(
            scheme, dataset=dataset, rounds=rounds, seed=seed,
            time_budget=tb, energy_budget=eb, target_acc=None)
    table2 = {}
    for scheme, hist in out["histories"].items():
        t, e = cost_to_target(hist, target)
        best = max((h.get("acc", 0.0) for h in hist), default=0.0)
        table2[scheme] = {"time_to_target": t, "energy_to_target": e,
                          "best_acc": best}
    out["table2"] = table2
    save_json(f"fig23_{dataset}", out)
    return out


def main(rounds=60):
    rows = []
    for ds in ("cifar", "femnist"):
        out = run(ds, rounds=rounds)
        for scheme, row in out["table2"].items():
            t = row["time_to_target"]
            e = row["energy_to_target"]
            rows.append(f"table2_{ds}_{scheme},"
                        f"{t if t else 'nan'},{e if e else 'nan'},"
                        f"{row['best_acc']:.3f}")
    print("name,time_s,energy_J,best_acc")
    for r in rows:
        print(r)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 60)
