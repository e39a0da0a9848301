"""Serving launcher: continuous batching over the paged KV cache, on the
card unless ``--device cpu`` (port of the ``--continuous`` path of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \
        --arch qwen2_7b
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \
        --arch granite_moe_1b_a400m

serves a synthetic Poisson request stream (per-request prompt and output
lengths) through ``Engine.serve``.  ``--full`` runs the architecture at
its published width with random weights; the default is the CPU-sized
smoke config.  The paged families (``engine.PAGED_FAMILIES``: dense and
moe) are served.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.launch.profiling import activities, print_profile
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import (PAGED_FAMILIES, Engine,
                                        PagedConfig, ServeConfig)
from repro_torch.serving.scheduler import Request

# family -> what serving it needs; the paged engine serves PAGED_FAMILIES
NOT_SERVED = {
    "ssm": "ROADMAP.md, modules to port, item 4: Engine.generate, and "
           "item 6: mamba2's prefill and decode_step",
    "hybrid": "ROADMAP.md, modules to port, item 4: Engine.generate, and "
              "item 6: griffin",
    "encdec": "ROADMAP.md, modules to port, item 6: the encoder and "
              "cross-attention",
}


def poisson_requests(n, rate, prompt_len, new_tokens, vocab, seed=0,
                     min_prompt=4, min_new=2):
    """``n`` requests with Poisson arrivals at ``rate`` req/s, prompt
    lengths uniform in [min_prompt, prompt_len] and ``max_new_tokens``
    uniform in [min_new, new_tokens]."""
    rng = np.random.default_rng(seed)
    t, reqs = 0.0, []
    for rid in range(n):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(min_prompt, prompt_len + 1))
        reqs.append(Request(
            rid=rid, prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(min_new, new_tokens + 1)),
            arrival=t))
    return reqs


def _sync(engine):
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode slots (max concurrent requests)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16,
                    help="stream length for --continuous")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate (req/s) for --continuous")
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve with torch.profiler (after a "
                         "warm-up serve) and print the device's busy share "
                         "and its kernels by device time")
    args = ap.parse_args(argv)
    if not args.continuous:
        ap.error("only the --continuous path is ported (the static-batch "
                 "Engine.generate path is not)")

    cfg = get_config(args.arch).model
    if cfg.family not in PAGED_FAMILIES:
        ap.error(f"--arch {args.arch}: serving the {cfg.family} family is "
                 f"not ported yet ({NOT_SERVED[cfg.family]})")
    if args.smoke:
        cfg = smoke_model(cfg)
    params = get_model(cfg).init(cfg, seed=0, device=args.device)
    engine = Engine(cfg, params, device=args.device,
                    serve=ServeConfig(temperature=args.temperature),
                    paged=PagedConfig(page_size=args.page_size,
                                      max_slots=args.batch))
    reqs = poisson_requests(args.requests, args.rate, args.prompt_len,
                            args.new_tokens, cfg.vocab_size)
    if args.profile:
        engine.serve(poisson_requests(2, 1e6, 32, 4, cfg.vocab_size, seed=1))
        with torch.profiler.profile(
                activities=activities(engine.device)) as prof:
            t0 = time.perf_counter()
            outs = engine.serve(reqs)
            _sync(engine)
            dt = time.perf_counter() - t0
        print_profile(prof, dt)
    else:
        t0 = time.perf_counter()
        outs = engine.serve(reqs)
        dt = time.perf_counter() - t0
    n_tok = sum(len(o.tokens) for o in outs.values())
    ttft = np.array([o.ttft for o in outs.values()])
    print(f"continuous: {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {engine.device}), "
          f"TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms")
    for rid in sorted(outs)[:4]:
        o = outs[rid]
        print(f"  req{rid}: ttft={o.ttft * 1e3:.1f}ms "
              f"tokens={o.tokens[:8]}{'...' if len(o.tokens) > 8 else ''}")


if __name__ == "__main__":
    main()
