"""Paper Fig. 5: the backhaul topology, an Erdos-Renyi graph over p_edge
(port of ``benchmarks/fig5_topology.py``).

    PYTHONPATH=src python -m repro_torch.experiments.fig5_topology 40

Writes ``fig5_topology.json`` under ``common.RESULTS``."""
from __future__ import annotations

import sys

from repro_torch.experiments.common import (_DATASETS, calibrate_budgets,
                                            cost_to_target, run_scheme,
                                            save_json)


def main(rounds=50):
    target = _DATASETS["cifar"]["target_acc"]
    out = {}
    print("name,p_edge,scheme,time_s,energy_J")
    for p_edge in (0.2, 0.6, 1.0):
        tb, eb, cef_hist = calibrate_budgets(
            "cifar", rounds=rounds, backhaul="erdos_renyi", p_edge=p_edge)
        for scheme in ("hcef", "cef"):
            hist = (cef_hist if scheme == "cef" else run_scheme(
                scheme, dataset="cifar", backhaul="erdos_renyi",
                p_edge=p_edge, rounds=rounds, time_budget=tb,
                energy_budget=eb))
            t, e = cost_to_target(hist, target)
            out[f"{scheme}_p{p_edge}"] = {"time": t, "energy": e}
            print(f"fig5,{p_edge},{scheme},{t},{e}")
    save_json("fig5_topology", out)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
