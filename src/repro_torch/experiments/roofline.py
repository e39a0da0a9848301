"""Roofline of the dry run's cells (port of ``benchmarks/roofline.py``).

    PYTHONPATH=src python -m repro_torch.experiments.roofline

Reads the dry run's cells (``experiments_out/dryrun/*.json``, written by
``python -m repro_torch.launch.dryrun``) and derives, per cell:

  compute term    = counted FLOPs / peak FLOP/s
  memory term     = (counted dot bytes + argument bytes) / HBM rate
  collective term = 0: one process runs no collective; the sharded
                    program's collective bytes over the link rate wait for
                    the multi-rank mesh (ROADMAP.md, modules to port,
                    item 5)

The constants are one NVIDIA H100 SXM5 80GB's: dense bf16 989e12 FLOP/s
(``chip_smoke.py``'s ``PEAK_FLOPS``) and HBM3 at 3.35e12 B/s (the bound
of PERF.md's kernel table).  The counted FLOPs and bytes are
``dist.step_analysis.analyze_step``'s over the step the port runs (the
plain routes on ``meta``, a checkpointed layer's recomputed forward
included); as in the reference, the memory term is a structural proxy
(dots' operands and results and the arguments read once, elementwise
traffic not counted).  ``model_flops`` is the analytic useful work
(6 N_active T for training, 2 N_active T for prefill, 2 N_active B for
decode, plus the attention terms), copied from the reference; the ratio
model_flops / counted FLOPs exposes recompute and masked-block work.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import get_config, smoke_model
from repro_torch.launch.dryrun import RESULTS_DIR as RESULTS

PEAK_FLOPS = 989e12  # H100 SXM5, dense bf16
HBM_BW = 3.35e12     # H100 SXM5, HBM3


def _expert_params(cfg) -> int:
    if not cfg.num_experts:
        return 0
    return cfg.num_layers * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff


def active_fraction_params(cfg, param_count: int) -> float:
    """N_active: replace total expert params by the top-k active slice."""
    ep = _expert_params(cfg)
    if not ep:
        return float(param_count)
    active = ep * cfg.experts_per_token / cfg.num_experts
    return float(param_count - ep + active)


def attn_flops_fwd(cfg, B, S) -> float:
    """Causal attention score+value matmul FLOPs (global, forward)."""
    if cfg.family == "ssm":
        # SSD chunked: within-chunk (attention-like over chunk) + state ops
        L, H, P, N = (cfg.num_layers, cfg.ssm_heads, cfg.ssm_head_dim,
                      cfg.ssm_state)
        Q = cfg.ssm_chunk
        per_tok = H * (Q * (N + P) + 2 * P * N)  # scores/y_diag + states
        return 2.0 * B * S * per_tok * L
    n_attn = cfg.num_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern
        n_groups = cfg.num_layers // len(pat)
        n_attn = n_groups * sum(1 for p in pat if p == "attn")
        # RG-LRU layers are linear: folded into the param term
    eff = min(S, cfg.window) if cfg.window else S
    per_layer = 2.0 * B * S * (eff / (2 if not cfg.window else 1)) \
        * cfg.num_heads * cfg.head_dim * 2
    total = per_layer * n_attn
    if cfg.family == "encdec":
        total += per_layer * cfg.enc_layers  # bidirectional encoder (full S)
        total += per_layer * cfg.num_layers / 2  # cross attention
    return total


def model_flops(cfg, kind, B, S, param_count, tau=1) -> float:
    n_act = active_fraction_params(cfg, param_count)
    T = B * S
    if kind == "train":
        return (6.0 * n_act * T + 3.0 * attn_flops_fwd(cfg, B, S)) * 1.0
    if kind == "prefill":
        return 2.0 * n_act * T + attn_flops_fwd(cfg, B, S)
    # decode: one token per sequence; attention reads the whole cache
    cache_eff = min(S, cfg.window) if cfg.window else S
    attn = 2.0 * B * cache_eff * cfg.num_heads * cfg.head_dim * 2 \
        * cfg.num_layers if cfg.family != "ssm" else \
        2.0 * B * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 2 \
        * cfg.num_layers
    return 2.0 * n_act * B + attn


def load_cells(results: Path = RESULTS):
    return [json.loads(f.read_text()) for f in sorted(results.glob("*.json"))]


def analyze(cell) -> dict:
    cfg = get_config(cell["arch"]).model
    if cell.get("smoke"):
        cfg = smoke_model(cfg)
    n = cell["n_chips"]
    hlo_flops = cell["hlo"]["flops"]  # per device
    mem_bytes = cell["hlo"]["dot_bytes"] + cell["memory"]["argument_bytes"]
    t_c = hlo_flops / PEAK_FLOPS
    t_m = mem_bytes / HBM_BW
    t_n = 0.0  # no collective at one process (ROADMAP.md item 5)
    mf = model_flops(cfg, cell["kind"], cell["global_batch"],
                     cell["seq_len"], cell["param_count"]) / n
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_n)),
              key=lambda kv: kv[1])
    bound = max(t_c, t_m, t_n)
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_n,
        "dominant": dom[0],
        "model_flops_dev": mf, "hlo_flops_dev": hlo_flops,
        "useful_ratio": mf / hlo_flops if hlo_flops else 0.0,
        # roofline fraction: useful work at peak vs achievable step time
        "roofline_frac": (mf / PEAK_FLOPS) / bound if bound else 0.0,
        "peak_gib": cell["memory"]["peak_est_bytes"] / 2**30,
    }


def main(results: Path = RESULTS):
    rows = []
    for cell in load_cells(results):
        if cell["status"] != "ok":
            if cell["status"] == "skipped":
                rows.append({"arch": cell["arch"], "shape": cell["shape"],
                             "mesh": cell["mesh"], "dominant": "SKIPPED"})
            continue
        rows.append(analyze(cell))
    hdr = ("arch,shape,mesh,compute_s,memory_s,collective_s,dominant,"
           "useful_ratio,roofline_frac,peak_GiB")
    print(hdr)
    for r in rows:
        if r["dominant"] == "SKIPPED":
            print(f"{r['arch']},{r['shape']},{r['mesh']},,,,skipped,,,")
            continue
        print(f"{r['arch']},{r['shape']},{r['mesh']},"
              f"{r['compute_s']:.4e},{r['memory_s']:.4e},"
              f"{r['collective_s']:.4e},{r['dominant']},"
              f"{r['useful_ratio']:.3f},{r['roofline_frac']:.3f},"
              f"{r['peak_gib']:.1f}")
    ok = [r for r in rows if r["dominant"] != "SKIPPED"]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_frac"])
        collb = max(ok, key=lambda r: r["collective_s"]
                    / max(r["compute_s"], 1e-12))
        print(f"# worst roofline fraction: {worst['arch']}x{worst['shape']}"
              f"x{worst['mesh']} ({worst['roofline_frac']:.3f})")
        print(f"# most collective-bound: {collb['arch']}x{collb['shape']}"
              f"x{collb['mesh']}")
    return rows


if __name__ == "__main__":
    main()
