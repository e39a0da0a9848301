#!/usr/bin/env python3
"""Serve ``chip_smoke.py`` phase 4's request stream and time it.

    PYTHONPATH=<checkout>/src python3 tools/serve_bench.py [--arch A]
        [--serves N]

Serves phase 4's stream (``chip_smoke.serve_requests``: 16 Poisson
requests at 50 req/s, prompts 16-512 tokens, outputs 16-64, greedy; the
prompts taken into the arch's vocabulary) through ``Engine.serve`` on
phase 4's engine (``chip_smoke.serve_engine``: 8 decode slots, pages of
16, the arch at full width in bf16 with seeded weights, one warm-up
serve); qwen2-7b by default.  The stream and the engine come from this
tool's own checkout, the port from whichever ``repro_torch`` comes first
on the path, so one command can time two checkouts in turns on the same
card.  Prints the card's name and power limit, then one JSON line a
serve: TPOT p50, TTFT p99, tokens a second, the decode step's p50.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--serves", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_bench: no CUDA device")
    import repro_torch
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.models import lm
    from repro_torch.serving import engine as engine_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config(args.arch).model
    reqs = chip_smoke.serve_requests(
        poisson_requests, cfg, configs.get_config("qwen2_7b").model.vocab_size)
    eng = chip_smoke.serve_engine(lm, engine_mod, cfg, poisson_requests)
    steps = []
    decode = eng.model.decode_step_paged

    def timed_decode(*a, **kw):
        t0 = time.perf_counter()
        out = decode(*a, **kw)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.model = type("Timed", (), {
        "prefill_paged": staticmethod(eng.model.prefill_paged),
        "decode_step_paged": staticmethod(timed_decode),
        "init_paged_cache": staticmethod(eng.model.init_paged_cache)})
    for i in range(args.serves):
        steps.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tpot = np.array([o.tpot for o in outs.values()]) * 1e3
        ttft = np.array([o.ttft for o in outs.values()]) * 1e3
        n = sum(len(o.tokens) for o in outs.values())
        print(json.dumps(dict(
            checkout=repro_torch.__file__.rsplit("/src/", 1)[0],
            arch=args.arch, serve=i, tpot_p50_ms=float(np.percentile(tpot,
                                                                     50)),
            ttft_p99_ms=float(np.percentile(ttft, 99)), tok_per_s=n / wall,
            decode_step_ms_p50=float(np.percentile(steps, 50)))),
            flush=True)


if __name__ == "__main__":
    main()
