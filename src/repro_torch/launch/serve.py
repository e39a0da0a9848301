"""Serving launcher, on the card unless ``--device cpu`` (port of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --full \
        --arch recurrentgemma_9b --batch 2 --prompt-len 3072
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --full \
        --arch qwen2_7b [--kv-dtype int8]

Without ``--continuous`` it runs ``Engine.generate`` (the static batch)
on ``--batch`` random prompts of ``--prompt-len`` tokens, for every
architecture, with the reference's stand-ins: zero patch embeddings for
the ViT stub and N(0, 1) frames of the prompt's length for the encoder.
With ``--continuous`` it serves a synthetic Poisson request stream
(per-request prompt and output lengths) through ``Engine.serve``, for the
paged families (``engine.PAGED_FAMILIES``: dense and moe) without a
frontend; ``--kv-dtype int8`` stores the pool block-quantized.
``--full`` runs the architecture at its published width with random
weights; the default is the CPU-sized smoke config.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.launch.profiling import activities, print_profile
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import (FRONTEND_NOT_PAGED, PAGED_FAMILIES,
                                        Engine, PagedConfig, ServeConfig)
from repro_torch.serving.scheduler import Request

# what --continuous (Engine.serve) cannot take, and why
NOT_SERVED = {
    "ssm": "no KV cache: the continuous engine serves PAGED_FAMILIES "
           "(reference serving/engine.py:41)",
    "hybrid": "no paged KV cache: the continuous engine serves "
              "PAGED_FAMILIES (reference serving/engine.py:41)",
    "encdec": "the paged path has no cross-attention (reference "
              "serving/engine.py:41, ROADMAP.md §3)",
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


def stand_ins(cfg, batch, prompt_len, rng):
    """The reference launcher's frontend inputs for ``generate``: zero
    patch embeddings (B, frontend_tokens, D) for the ViT stub, N(0, 1)
    frames (B, prompt_len, D) for the encoder."""
    extra = {}
    if cfg.frontend == "vit_stub":
        extra["patch_embeds"] = np.zeros(
            (batch, cfg.frontend_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(0, 1, (batch, prompt_len,
                                            cfg.d_model)).astype(np.float32)
    return extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--batch", type=int, default=4,
                    help="the static batch, or decode slots (max concurrent "
                         "requests) with --continuous")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "int8"],
                    help="paged KV storage dtype (--continuous only)")
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

    cfg = get_config(args.arch).model
    if args.continuous:
        if cfg.family not in PAGED_FAMILIES:
            ap.error(f"--continuous cannot serve --arch {args.arch}: "
                     f"{NOT_SERVED[cfg.family]}; serve it without "
                     f"--continuous (Engine.generate)")
        if cfg.frontend:
            ap.error(f"--continuous cannot serve --arch {args.arch}: "
                     f"{FRONTEND_NOT_PAGED}")
    elif args.kv_dtype:
        ap.error("--kv-dtype stores the paged pool: --continuous only")
    if args.smoke:
        cfg = smoke_model(cfg)
    if not args.continuous and cfg.frontend_tokens > args.prompt_len:
        ap.error(f"--arch {args.arch}: a prompt of {args.prompt_len} "
                 f"tokens is shorter than the ViT stub's "
                 f"{cfg.frontend_tokens} patch positions (the reference's "
                 f"launcher would prefill them into a smaller cache; "
                 f"ROADMAP.md §3)")
    params = get_model(cfg).init(cfg, seed=0, device=args.device)
    engine = Engine(cfg, params, device=args.device,
                    max_len=args.prompt_len + args.new_tokens,
                    batch_size=args.batch,
                    serve=ServeConfig(max_new_tokens=args.new_tokens,
                                      temperature=args.temperature),
                    paged=PagedConfig(page_size=args.page_size,
                                      max_slots=args.batch,
                                      kv_dtype=args.kv_dtype))
    if args.continuous:
        reqs = poisson_requests(args.requests, args.rate, args.prompt_len,
                                args.new_tokens, cfg.vocab_size)
        warm = lambda: engine.serve(poisson_requests(  # noqa: E731
            2, 1e6, 32, 4, cfg.vocab_size, seed=1))
        work = lambda: engine.serve(reqs)  # noqa: E731
    else:
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len))
        extra = stand_ins(cfg, args.batch, args.prompt_len, rng) or None
        warm = work = lambda: engine.generate(  # noqa: E731
            prompts, extra_inputs=extra)
    if args.profile:
        warm()
        with torch.profiler.profile(
                activities=activities(engine.device)) as prof:
            t0 = time.perf_counter()
            outs = work()
            _sync(engine)
            dt = time.perf_counter() - t0
        print_profile(prof, dt)
    else:
        t0 = time.perf_counter()
        outs = work()
        dt = time.perf_counter() - t0
    if not args.continuous:
        print(f"arch={args.arch} family={cfg.family} batch={args.batch}: "
              f"generated {outs.size} tokens in {dt:.2f}s "
              f"({outs.size / dt:.1f} tok/s on {engine.device})")
        for i, row in enumerate(outs[:4]):
            print(f"  req{i}: {row[:12].tolist()}")
        return
    n_tok = sum(len(o.tokens) for o in outs.values())
    ttft = np.array([o.ttft for o in outs.values()])
    print(f"continuous: {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s on {engine.device}, "
          f"kv_dtype={args.kv_dtype or 'dense'}), "
          f"TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms")
    for rid in sorted(outs)[:4]:
        o = outs[rid]
        print(f"  req{rid}: ttft={o.ttft * 1e3:.1f}ms "
              f"tokens={o.tokens[:8]}{'...' if len(o.tokens) > 8 else ''}")


if __name__ == "__main__":
    main()
