#!/usr/bin/env python3
"""Time the copies of a cohort swap on smollm-135M: four clients' bf16
EF and f32 momentum (3.23 GB), a row a leaf, between the card and host
memory that is fresh, in use, or pinned.

    PYTHONPATH=src python3 tools/swap_bench.py

Prints each route's best of three, in ms and GB/s, and the pinned
allocation's time.  Needs one CUDA card.
"""
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.tree import flatten

R = 4  # clients a swap moves each way (phase 20's slots)


def main():
    p = flatten(lm.init(get_config("smollm_135m").model, seed=0,
                        device="cuda"))
    ef = [torch.randn((R,) + v.shape, device="cuda").to(torch.bfloat16)
          for v in p.values()]
    mom = [torch.randn((R,) + v.shape, device="cuda") for v in p.values()]
    leaves = ef + mom
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"{nbytes / 1e9:.3f} GB for {R} clients, {len(leaves)} leaves")

    def timed(name, fn, reps=3):
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
        b = min(out)
        print(f"{name}: best {b * 1e3:.1f} ms of "
              f"{[round(x * 1e3, 1) for x in out]} = {nbytes / b / 1e9:.2f}"
              f" GB/s", flush=True)

    pairs = [(t, r) for t in leaves for r in range(R)]
    rows = []
    timed("card to fresh pageable memory",
          lambda: rows.append([t[r].to("cpu") for t, r in pairs]))
    rows = rows[-1]
    timed("card to pageable memory in use",
          lambda: [h.copy_(t[r]) for h, (t, r) in zip(rows, pairs)])
    timed("pageable memory to the card",
          lambda: [t[r].copy_(h) for h, (t, r) in zip(rows, pairs)])
    t0 = time.perf_counter()
    pinned = [torch.empty(t[r].shape, dtype=t.dtype, pin_memory=True)
              for t, r in pairs]
    print(f"pinned allocation: {time.perf_counter() - t0:.3f} s")
    timed("card to pinned memory in use",
          lambda: [h.copy_(t[r]) for h, (t, r) in zip(pinned, pairs)])
    timed("pinned memory to the card",
          lambda: [t[r].copy_(h) for h, (t, r) in zip(pinned, pairs)])


if __name__ == "__main__":
    main()
