"""Serving bench: continuous batching against static batches under load
(port of ``benchmarks/serving_bench.py``).

    PYTHONPATH=src python -m repro_torch.experiments.serving_bench --smoke
    PYTHONPATH=src python -m repro_torch.experiments.serving_bench --full

Drives both engine paths over the same synthetic request stream (Poisson
arrivals, mixed prompt lengths, mixed output budgets) on the smollm smoke
config (``--full``: smollm-135M at its published width; ``bench_rows``
takes any paged ``arch``):

  * the static baseline: requests grouped into batches of ``--slots``,
    every batch decoding until its longest member finishes
    (``Engine.generate``);
  * continuous batching: the scheduler admits and retires per decode step
    through the paged KV pool (``Engine.serve``), over a bf16 pool and an
    int8 one.

Reports goodput tokens/s (a request's tokens count up to its own budget)
and the p50 / p99 time to first token and time per output token.  The
detail goes to ``--out`` (default ``common.RESULTS / "serving_bench.json"``);
nothing is merged into another record.  ``--require R`` (default 1.5)
exits 1 unless continuous tokens/s >= R x static.  Random weights from a
``torch.Generator`` seeded 0; on the card unless ``device`` says
otherwise.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.core import wire_format as wf
from repro_torch.experiments import common
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Engine, PagedConfig, ServeConfig
from repro_torch.serving.scheduler import Request, RequestOutput

PAGE_SIZE = 8
PROMPT_LENS = (4, 8, 16, 24)
BUDGETS = (4, 8, 16, 64)


def make_workload(*, n_requests, vocab, prompt_lens, budgets, rate_hz,
                  seed=0):
    """Poisson arrival stream with mixed prompt and output lengths."""
    rng = np.random.default_rng(seed)
    t = 0.0
    reqs = []
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate_hz)
        plen = int(rng.choice(prompt_lens))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.choice(budgets)), arrival=t))
    return reqs


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def _lat_summary(outs):
    ttft = [o.ttft for o in outs.values()]
    tpot = [o.tpot for o in outs.values() if len(o.tokens) > 1]
    return {"ttft_p50_ms": 1e3 * _pct(ttft, 50),
            "ttft_p99_ms": 1e3 * _pct(ttft, 99),
            "tpot_p50_ms": 1e3 * _pct(tpot, 50),
            "tpot_p99_ms": 1e3 * _pct(tpot, 99)}


def _sync(eng):
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)


def run_static(eng, reqs):
    """Static batches over the arrival stream: fill a batch from the queue
    (waiting for its arrivals), pad prompts to the stream's longest, and
    decode every row to the batch's longest budget.  A batch's results
    are seen when the whole batch returns, so TTFT is taken at the
    batch's completion (a synchronous batch API's client-side latency)."""
    S_pad = max(len(r.prompt) for r in reqs)
    queue = sorted(reqs, key=lambda r: r.arrival)
    outs = {}
    t0 = time.perf_counter()
    now = lambda: time.perf_counter() - t0  # noqa: E731
    i = 0
    while i < len(queue):
        batch = queue[i:i + eng.batch_size]
        i += len(batch)
        wait = max(r.arrival for r in batch) - now()
        if wait > 0:  # a batch forms once its last member has arrived
            time.sleep(wait)
        prompts = np.zeros((len(batch), S_pad), np.int32)
        for j, r in enumerate(batch):
            prompts[j, :len(r.prompt)] = r.prompt  # right-padded; the
            # pads are attended, as the pad-to-max engine does
        eng.serve_cfg.max_new_tokens = max(r.max_new_tokens for r in batch)
        res = eng.generate(prompts)
        t = now()
        for j, r in enumerate(batch):
            o = RequestOutput(rid=r.rid, prompt_len=len(r.prompt),
                              t_arrival=r.arrival, t_admitted=t,
                              t_first_token=t, t_done=t)
            o.tokens = [int(x) for x in res[j][:r.max_new_tokens]]
            o.finish_reason = "length"
            outs[r.rid] = o
    return outs, now()


def bench_rows(*, smoke=True, n_requests=32, slots=8, rate_hz=200.0,
               seed=0, arch="smollm_135m", device=None):
    """Returns (rows, detail): ``(name, us_per_token, derived)`` rows and
    the latency detail of the three modes."""
    cfg = get_config(arch).model
    if smoke:
        cfg = smoke_model(cfg)
    params = get_model(cfg).init(cfg, seed=0, device=device)

    S_pad = 24  # the longest prompt, page-aligned
    max_len = S_pad + max(BUDGETS)
    reqs = make_workload(n_requests=n_requests, vocab=cfg.vocab_size,
                         prompt_lens=PROMPT_LENS, budgets=BUDGETS,
                         rate_hz=rate_hz, seed=seed)
    total_budget = sum(r.max_new_tokens for r in reqs)

    def engine(kv_dtype=None):
        return Engine(cfg, params, max_len=max_len, batch_size=slots,
                      serve=ServeConfig(max_new_tokens=max(BUDGETS)),
                      paged=PagedConfig(page_size=PAGE_SIZE, max_slots=slots,
                                        kv_dtype=kv_dtype),
                      device=device)

    # -- the static baseline, its prefill and decode warmed up first --
    eng_s = engine()
    eng_s.generate(np.zeros((slots, S_pad), np.int32))
    _sync(eng_s)
    static_outs, static_dt = run_static(eng_s, reqs)
    static_toks = sum(len(o.tokens) for o in static_outs.values())
    static_tps = static_toks / static_dt

    # -- continuous over a bf16 and an int8 pool, warmed up alike --
    results = {}
    for tag, kv in (("cont", None), ("cont_int8kv", "int8")):
        eng = engine(kv)
        warm = [Request(rid=10_000 + i, prompt=np.zeros(S_pad, np.int32),
                        max_new_tokens=max(BUDGETS) if i == 0 else 2)
                for i in range(2)]
        eng.serve(warm)
        _sync(eng)
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        dt = time.perf_counter() - t0
        toks = sum(len(o.tokens) for o in outs.values())
        assert toks == total_budget, (toks, total_budget)
        results[tag] = (outs, dt, toks / dt)

    cont_tps = results["cont"][2]
    speedup = cont_tps / static_tps
    kv_ratio = (wf.kv_token_bytes(cfg.num_kv_heads, cfg.head_dim)
                / wf.kv_token_bytes(cfg.num_kv_heads, cfg.head_dim,
                                    kv_dtype="int8"))
    rows = [
        (f"serving_static_{arch}", 1e6 / static_tps,
         f"{static_tps:.0f}tok/s_goodput"),
        (f"serving_cont_{arch}", 1e6 / cont_tps,
         f"{cont_tps:.0f}tok/s_{speedup:.2f}x_vs_static"),
        (f"serving_cont_int8kv_{arch}", 1e6 / results["cont_int8kv"][2],
         f"{results['cont_int8kv'][2]:.0f}tok/s_{kv_ratio:.1f}x_kv_bytes"),
    ]
    detail = {
        "workload": {"n_requests": n_requests, "slots": slots,
                     "rate_hz": rate_hz, "prompt_lens": list(PROMPT_LENS),
                     "budgets": list(BUDGETS), "page_size": PAGE_SIZE,
                     "arch": arch, "smoke": smoke, "seed": seed,
                     "total_budget_tokens": total_budget},
        "static": {"tokens_per_s": static_tps, "wall_s": static_dt,
                   **_lat_summary(static_outs)},
        "continuous": {"tokens_per_s": cont_tps,
                       "wall_s": results["cont"][1],
                       **_lat_summary(results["cont"][0])},
        "continuous_int8kv": {"tokens_per_s": results["cont_int8kv"][2],
                              "wall_s": results["cont_int8kv"][1],
                              "kv_bytes_ratio": kv_ratio,
                              **_lat_summary(results["cont_int8kv"][0])},
        "speedup_cont_vs_static": speedup,
    }
    return rows, detail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--rate", type=float, default=200.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--require", type=float, default=1.5,
                    help="fail unless continuous >= R x static tokens/sec")
    ap.add_argument("--out", type=Path, default=None,
                    help="default: common.RESULTS / serving_bench.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    rows, detail = bench_rows(smoke=args.smoke, n_requests=args.requests,
                              slots=args.slots, rate_hz=args.rate,
                              seed=args.seed, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    for tag in ("static", "continuous", "continuous_int8kv"):
        d = detail[tag]
        print(f"  {tag}: {d['tokens_per_s']:.0f} tok/s  "
              f"ttft p50/p99 {d['ttft_p50_ms']:.0f}/{d['ttft_p99_ms']:.0f} ms"
              f"  tpot p50/p99 {d['tpot_p50_ms']:.1f}/{d['tpot_p99_ms']:.1f}"
              f" ms")

    out = args.out or common.RESULTS / "serving_bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(detail, indent=1) + "\n")
    print(f"wrote {out}")

    speedup = detail["speedup_cont_vs_static"]
    verdict = speedup >= args.require
    print(f"continuous vs static: {speedup:.2f}x "
          f"(require >= {args.require:.2f}x): "
          f"{'OK' if verdict else 'FAIL'}")
    if not verdict:
        raise SystemExit(1)
    return rows, detail


if __name__ == "__main__":
    main()
