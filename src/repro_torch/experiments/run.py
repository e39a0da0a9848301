"""The experiments' entry point (port of ``benchmarks/run.py``).

    PYTHONPATH=src python -m repro_torch.experiments.run [--smoke|--full]

Prints ``name,us_per_call,derived`` CSV blocks and the sweeps' lines:
  1. the kernel microbenchmarks (``kernels_bench``, one timed call a row
     under ``--smoke``; it writes ``common.RESULTS / "kernels.json"``),
     the serving rows (continuous against static batching) and the
     cohort engine's paging rows;
  2. the overlap sweep and the cohort sweep;
  3. unless ``--smoke``, the paper's reproduction: Fig. 2/3 and Table 2
     at 40 rounds (60 under ``--full``), then under ``--full`` the Fig.
     4-7 sweeps at 40 rounds, and last the roofline summary of the dry
     run's cells (``roofline``; skipped when there are none).
The serving and cohort rows go to ``common.RESULTS / "run_rows.json"``.
On the card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.experiments import common


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    common.DEVICE = args.device  # the figure scripts' FedSims
    t0 = time.time()

    print("== kernel microbenchmarks ==")
    from repro_torch.experiments import kernels_bench
    kargs = ["--smoke"] if args.smoke else []
    if args.device:
        kargs += ["--device", args.device]
    kernels_bench.main(kargs)

    print("\n== serving: continuous vs static batching ==")
    from repro_torch.experiments import serving_bench
    rows, _ = serving_bench.bench_rows(smoke=True, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")

    print("\n== cohort engine: population paging throughput ==")
    from repro_torch.experiments import cohort_bench
    crows = cohort_bench.bench_rows(smoke=True, device=args.device)
    for name, us, derived in crows:
        print(f"{name},{us:.1f},{derived}")
    rows = rows + crows
    p = common.save_json("run_rows", {
        name: {"us_per_call": round(us, 1), "derived": derived}
        for name, us, derived in rows})
    print(f"wrote {p}")

    print("\n== overlap: convergence vs staleness ==")
    from repro_torch.experiments import overlap_sweep
    overlap_sweep.main(rounds=10, device=args.device)

    print("\n== cohort sweep: sgd vs fedprox under sampling ==")
    cohort_bench.sweep(rounds=8, device=args.device)

    if args.smoke:
        print(f"\ntotal time: {time.time() - t0:.0f}s")
        return

    print("\n== paper reproduction: Fig. 2/3 + Table 2 ==")
    from repro_torch.experiments import fig2_3_convergence
    fig2_3_convergence.main(rounds=40 if not args.full else 60)

    if args.full:
        print("\n== Fig. 4 (non-IID) ==")
        from repro_torch.experiments import fig4_noniid
        fig4_noniid.main(rounds=40)
        print("\n== Fig. 5 (topology) ==")
        from repro_torch.experiments import fig5_topology
        fig5_topology.main(rounds=40)
        print("\n== Fig. 6/7 (q, tau) ==")
        from repro_torch.experiments import fig67_periods
        fig67_periods.main(rounds=40)

    print("\n== roofline (from the dry run's cells) ==")
    from repro_torch.experiments import roofline
    try:
        roofline.main()
    except Exception as e:  # the dry run's cells may be absent
        print(f"roofline skipped: {e}")
    print(f"\ntotal time: {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
