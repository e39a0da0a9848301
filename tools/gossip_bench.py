#!/usr/bin/env python3
"""Time one gossip round of the sparse wire on mamba2-1.3B at full width.

    PYTHONPATH=<checkout>/src python3 tools/gossip_bench.py [--rounds N]
        [--cols C[,C...]]

Runs the fused round step's gossip loop as ``core/round.py`` runs it on a
sparse gossip round: ``sparse_exchange_`` over every leaf of mamba2-1.3B
(48 layers, bf16, R = 4 devices in 2 clusters on a ring, cluster levels
(0.1, 0.6) over the int4 wire, wire block 1024), with seeded weights, each
cluster's rows holding its own mean, in column chunks of each width of
``--cols`` in turn (default ``core/round.py:GOSSIP_COLS``).  It imports
whichever ``repro_torch`` comes first on the path, so one command can time
two checkouts in turns on the same card.  Prints one JSON line a width:
the host ms of each synchronised gossip round, their median, the column
chunks a round, the device events a round and a chunk (``torch.profiler``,
one round before the timed ones), the peak device memory and the gossip's
own part of it (the peak over the memory allocated before the rounds),
and whether the leaves after the rounds are bit for bit those of the
first width (the chunks must not change the result).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

LEVELS = (0.1, 0.6)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--cols", default=None,
                    help="comma-separated column chunk widths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gossip_bench: no CUDA device")
    from repro_torch import configs
    from repro_torch.dist.collectives import sparse_exchange_
    from repro_torch.models import mamba2
    from repro_torch.tree import flatten
    import repro_torch

    if args.cols is None:
        from repro_torch.core.round import GOSSIP_COLS
        widths = [GOSSIP_COLS]
    else:
        widths = [int(c) for c in args.cols.split(",")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = configs.get_config("mamba2_1p3b").model
    C, Dev = 2, 2
    R = C * Dev
    gen = torch.Generator(device="cuda").manual_seed(0)
    leaves0 = {}
    for k, w in flatten(mamba2.init(cfg, gen, device="cuda")).items():
        # cluster c's rows hold its mean: the weights, moved a little
        x = w.reshape(1, 1, -1).repeat(C, Dev, 1)
        x[1] += (1e-3 * torch.randn(x[1, :1].shape, generator=gen,
                                    device="cuda")).to(x.dtype)
        leaves0[k] = x.reshape(R, -1)
        del w
    torch.cuda.empty_cache()
    first = None
    for cols in widths:
        leaves = {k: x.clone() for k, x in leaves0.items()}
        kw = dict(clusters=C, dev=Dev, hkind="ring", wire_dtype="int4",
                  wire_block=1024, cluster_theta=LEVELS, chunk_cols=cols)
        chunks = sum(-(-x.shape[1] // cols) for x in leaves.values())

        def gossip_round():
            for x in leaves.values():
                sparse_exchange_(x, **kw)

        gossip_round()  # builds the kernels, warms the allocator
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gossip_round()
            torch.cuda.synchronize()
        events = sum(1 for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            gossip_round()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        if first is None:
            first = leaves
        same = all(torch.equal(leaves[k].view(torch.int16),
                               first[k].view(torch.int16)) for k in leaves)
        print(json.dumps(dict(
            package=repro_torch.__file__, card=card, cols=cols,
            leaves=len(leaves),
            params=sum(x.shape[1] for x in leaves.values()),
            chunks_per_round=chunks, gossip_ms=walls,
            gossip_ms_p50=float(np.median(walls)),
            device_events_per_round=events,
            device_events_per_chunk=events / chunks,
            peak_mem_gb=peak / 1e9,
            gossip_added_peak_gb=(peak - base) / 1e9,
            same_bits_as_first_width=same)), flush=True)
        del leaves
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
