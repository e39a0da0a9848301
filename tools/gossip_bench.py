#!/usr/bin/env python3
"""Time one gossip round of the sparse wire on mamba2-1.3B at full width.

    PYTHONPATH=<checkout>/src python3 tools/gossip_bench.py [--rounds N]
        [--cols C[,C...]] [--wire-ef]

Runs the fused round step's gossip loop as ``core/round.py`` runs it on a
sparse gossip round: ``sparse_exchange_`` over every leaf of mamba2-1.3B
(48 layers, bf16, R = 4 devices in 2 clusters on a ring, cluster levels
(0.1, 0.6) over the int4 wire, wire block 1024), with seeded weights, each
cluster's rows holding its own mean, in column chunks of each width of
``--cols`` in turn (default ``core/round.py:gossip_cols``, which needs a
checkout that has it: give ``--cols`` for any other).  With ``--wire-ef``
every leaf also carries the CHOCO wire EF's two (R, L) f32 estimates
(48.7 GB), from zero, advanced by every round (gamma 1).  It imports
whichever ``repro_torch`` comes first on the path, so one command can
time two checkouts in turns on the same card.  Prints one JSON line a
width: the host ms of each synchronised gossip round, their median, the
column chunks a round, the wire kernels' launches a round, the device
events a round and a chunk (``torch.profiler``, one round before the
timed ones), the estimates' bytes, the peak device memory and the
gossip's own part of it (the peak over the memory allocated before the
rounds), and whether the leaves after the rounds are bit for bit those of
the first width (the chunks must not change the result).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

LEVELS = (0.1, 0.6)
C, DEV = 2, 2  # clusters, devices a cluster


def make_leaves(seed: int = 0):
    """{leaf name: (C * DEV, L) bf16 on the card}: mamba2-1.3B's weights
    from ``seed``, each cluster's rows holding its mean (cluster 1's moved
    by 1e-3 N(0, 1))."""
    from repro_torch import configs
    from repro_torch.models import mamba2
    from repro_torch.tree import flatten
    cfg = configs.get_config("mamba2_1p3b").model
    gen = torch.Generator(device="cuda").manual_seed(seed)
    leaves = {}
    for k, w in flatten(mamba2.init(cfg, gen, device="cuda")).items():
        x = w.reshape(1, 1, -1).repeat(C, DEV, 1)
        x[1] += (1e-3 * torch.randn(x[1, :1].shape, generator=gen,
                                    device="cuda")).to(x.dtype)
        leaves[k] = x.reshape(C * DEV, -1)
        del w
    torch.cuda.empty_cache()
    return leaves


def zero_estimates(leaves):
    """{leaf name: (est_self, est_wsum)}, f32 zeros shaped as the leaf."""
    return {k: tuple(torch.zeros(x.shape, dtype=torch.float32,
                                 device=x.device) for _ in range(2))
            for k, x in leaves.items()}


def exchange_kw(cols: int):
    """``sparse_exchange_``'s arguments but the leaf and the estimates."""
    return dict(clusters=C, dev=DEV, hkind="ring", wire_dtype="int4",
                wire_block=1024, cluster_theta=LEVELS, chunk_cols=cols)


def gossip_round(leaves, cols: int, est=None):
    """One gossip round over every leaf, in place (the estimates too)."""
    from repro_torch.dist.collectives import sparse_exchange_
    kw = exchange_kw(cols)
    for k, x in leaves.items():
        sparse_exchange_(x, wire_ef=None if est is None else est[k], **kw)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cols", default=None,
                    help="comma-separated column chunk widths")
    ap.add_argument("--wire-ef", action="store_true",
                    help="carry the CHOCO wire EF's estimates")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gossip_bench: no CUDA device")
    from repro_torch.kernels import wire_pack as wp
    import repro_torch

    if args.cols is None:
        from repro_torch.core.round import gossip_cols
        widths = [gossip_cols(C)]
    else:
        widths = [int(c) for c in args.cols.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    first = None
    for cols in widths:
        leaves = make_leaves()
        est = zero_estimates(leaves) if args.wire_ef else None
        chunks = sum(-(-x.shape[1] // cols) for x in leaves.values())
        run = lambda: gossip_round(leaves, cols, est)
        run()  # builds the kernels, warms the allocator
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(args.rounds):
            wp.reset_launches()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = dict(wp.LAUNCHES)  # the last round's
        peak = torch.cuda.max_memory_allocated()
        if first is None:
            first = leaves
        same = all(torch.equal(leaves[k].view(torch.int16),
                               first[k].view(torch.int16)) for k in leaves)
        print(json.dumps(dict(
            package=repro_torch.__file__, card=card, cols=cols,
            wire_ef=args.wire_ef, leaves=len(leaves),
            params=sum(x.shape[1] for x in leaves.values()),
            chunks_per_round=chunks, gossip_ms=walls,
            gossip_ms_p50=float(np.median(walls)),
            wire_launches_per_round=launches,
            decode_mix_launches_per_round=launches["wire_decode_mix"],
            device_events_per_round=events,
            device_events_per_chunk=events / chunks,
            estimates_bytes=0 if est is None else sum(
                e.numel() * e.element_size() for p in est.values()
                for e in p),
            peak_mem_gb=peak / 1e9,
            gossip_added_peak_gb=(peak - base) / 1e9,
            same_bits_as_first_width=same)), flush=True)
        del leaves, est, run
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
