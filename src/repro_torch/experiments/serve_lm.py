"""Batched serving example: prefill and token-by-token decode with a KV
cache (port of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.experiments.serve_lm \
        [--arch qwen2_7b] [--n 3] [--device cpu]

Serves the reduced config (``smoke_model``) of any architecture (dense,
MoE, SSM, hybrid, the ViT stub and the encoder-decoder) through
``Engine.generate``, the static batch: any number of prompts (a partial
batch is padded, a larger set chunked), 16 tokens each, with the
reference's stand-ins (zero patch embeddings, N(0, 1) frames).
``--continuous`` (the paged families, dense and MoE without a frontend)
runs the production path instead: continuous batching over the paged KV
cache with per-request prompt and output lengths.  The reference samples
at temperature 0.8 from ``jax.random`` keys, which cannot be reproduced:
the port's draws come from its own seeded generators, and ``run``'s
``temperature=0`` is greedy.  The weights come from the family's
``init`` seeded 0 (``run`` takes others, ``params``).  On the card unless
``--device`` says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.device import resolve
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import (FRONTEND_NOT_PAGED, PAGED_FAMILIES,
                                        Engine, PagedConfig, ServeConfig)
from repro_torch.serving.scheduler import Request


def refusal(cfg, continuous: bool):
    """Why ``--continuous`` cannot serve ``cfg`` (None: it can)."""
    if not continuous:
        return None
    if cfg.family not in PAGED_FAMILIES:
        return (f"continuous batching needs a KV-cache family "
                f"{PAGED_FAMILIES}, got {cfg.family!r}")
    if cfg.frontend:
        return f"{cfg.name}: {FRONTEND_NOT_PAGED}"
    return None


def run(arch: str, *, batch: int = 4, n: int = 3, new_tokens: int = 16,
        continuous: bool = False, temperature: float = 0.8, device=None,
        params=None, verbose: bool = True):
    """The example on ``arch``'s reduced config.  Returns (cfg, outputs):
    the (n, new_tokens) generated tokens, or with ``continuous`` the
    serve's {rid: RequestOutput}."""
    dev = resolve(device)
    cfg = smoke_model(get_config(arch).model)
    if params is None:
        params = get_model(cfg).init(cfg, seed=0, device=dev)
    engine = Engine(cfg, params, max_len=64, batch_size=batch,
                    serve=ServeConfig(max_new_tokens=new_tokens,
                                      temperature=temperature),
                    paged=PagedConfig(page_size=8, max_slots=batch),
                    device=dev)
    rng = np.random.default_rng(0)

    if continuous:
        reqs = [Request(rid=i,
                        prompt=rng.integers(0, cfg.vocab_size,
                                            int(rng.integers(4, 17))
                                            ).astype(np.int32),
                        max_new_tokens=int(rng.integers(2, new_tokens + 1)),
                        arrival=0.003 * i)
                for i in range(n)]
        outs = engine.serve(reqs)
        if verbose:
            print(f"arch={arch} family={cfg.family} (continuous)")
            for rid in sorted(outs):
                o = outs[rid]
                print(f"request {rid}: prompt_len={o.prompt_len} "
                      f"ttft={o.ttft * 1e3:.1f}ms -> generated {o.tokens}")
        return cfg, outs

    prompts = rng.integers(0, cfg.vocab_size, (n, 16)).astype(np.int32)
    extra = {}
    if cfg.frontend == "vit_stub":
        extra["patch_embeds"] = np.zeros(
            (n, cfg.frontend_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.normal(
            0, 1, (n, 16, cfg.d_model)).astype(np.float32)
    out = engine.generate(prompts, extra_inputs=extra or None)
    if verbose:
        print(f"arch={arch} family={cfg.family} "
              f"({n} prompts on batch_size={batch})")
        for i, row in enumerate(out):
            print(f"request {i}: prompt={prompts[i][:6].tolist()}... "
                  f"-> generated {row.tolist()}")
    return cfg, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4,
                    help="engine batch size / decode slots")
    ap.add_argument("--n", type=int, default=3,
                    help="number of prompts (any value: != batch is fine)")
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--continuous", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    why = refusal(smoke_model(get_config(args.arch).model), args.continuous)
    if why:
        ap.error(why)
    return run(args.arch, batch=args.batch, n=args.n,
               new_tokens=args.new_tokens, continuous=args.continuous,
               device=args.device)


if __name__ == "__main__":
    main()
