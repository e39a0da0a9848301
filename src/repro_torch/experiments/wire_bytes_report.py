"""Per-wire-format gossip byte report from the dry run's cells (port of
``benchmarks/wire_bytes_report.py``).

Reads the JSON that ``python -m repro_torch.launch.dryrun --sparse-gossip
--wire-dtype <fmt>`` writes for several wire value formats of the SAME
cell, takes the gossip bytes of the lowest and highest theta level from
its ``gossip_bytes_scale_with_theta`` section (a gossip round's wire
bytes at each level, ``dist.step_analysis.round_gossip_bytes``), and
prints a compact per-format table.

``--require a/b:ratio`` asserts format ``a``'s theta_min wire is at
least ``ratio`` times format ``b``'s (``int8/int4:2.0`` is the v2
acceptance bar: int4 values and packed offsets at least halve the int8
wire at the lowest level; DESIGN.md section Wire format v2).  Exits
nonzero when a requirement fails or a cell carries a failed verdict.

    PYTHONPATH=src python -m repro_torch.experiments.wire_bytes_report \
        experiments_out/dryrun/smollm_135m.train_4k.host.int*.json \
        --require int8/int4:2.0 --out experiments_out/wire_bytes_report.json
"""
import argparse
import json
import sys
from pathlib import Path


def summarize(res: dict) -> dict:
    v = res.get("gossip_bytes_scale_with_theta")
    if not isinstance(v, dict):
        raise SystemExit(f"cell {res.get('arch')}/{res.get('shape')} has no "
                         f"gossip_bytes_scale_with_theta verdict (was it "
                         f"counted with --sparse-gossip?)")
    lo = sum(s["branch_permute_bytes"][0] for s in v["switches"])
    hi = sum(s["branch_permute_bytes"][-1] for s in v["switches"])
    return {
        "arch": res["arch"], "shape": res["shape"], "mesh": res["mesh"],
        "levels": v["levels"],
        "theta_min_permute_bytes": lo,
        "theta_max_permute_bytes": hi,
        "n_switches": v["n_switches"],
        "verdict_ok": bool(v["ok"]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="+",
                    help="dry-run JSON files, one per wire format")
    ap.add_argument("--require", action="append", default=[],
                    metavar="A/B:RATIO",
                    help="assert theta_min bytes of format A >= RATIO x "
                         "format B's (repeatable)")
    ap.add_argument("--out", default=None, help="write the report JSON here")
    args = ap.parse_args(argv)

    report = {}
    for path in args.cells:
        res = json.loads(Path(path).read_text())
        fmt = res.get("wire_dtype")
        if fmt is None:
            raise SystemExit(f"{path}: no wire_dtype in the cell result")
        report[fmt] = summarize(res)

    fail = []
    w = max(len(f) for f in report)
    print(f"{'format':<{w}}  theta_min_bytes  theta_max_bytes  verdict")
    for fmt, row in sorted(report.items()):
        print(f"{fmt:<{w}}  {row['theta_min_permute_bytes']:>15.3e}  "
              f"{row['theta_max_permute_bytes']:>15.3e}  "
              f"{'ok' if row['verdict_ok'] else 'FAIL'}")
        if not row["verdict_ok"]:
            fail.append(f"{fmt}: gossip_bytes_scale_with_theta verdict failed")

    for spec in args.require:
        pair, _, ratio = spec.partition(":")
        a, _, b = pair.partition("/")
        ratio = float(ratio or 1.0)
        if a not in report or b not in report:
            fail.append(f"--require {spec}: missing format "
                        f"{a if a not in report else b}")
            continue
        ba = report[a]["theta_min_permute_bytes"]
        bb = report[b]["theta_min_permute_bytes"]
        got = ba / bb if bb else float("inf")
        ok = got >= ratio
        print(f"require {a}/{b} >= {ratio}: got {got:.3f}x "
              f"({'ok' if ok else 'FAIL'})")
        if not ok:
            fail.append(f"--require {spec}: got {got:.3f}x")
        report.setdefault("_requirements", []).append(
            {"spec": spec, "ratio": got, "ok": ok})

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    if fail:
        print("REPORT FAILED: " + "; ".join(fail))
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
