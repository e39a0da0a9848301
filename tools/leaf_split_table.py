#!/usr/bin/env python3
"""Where each leaf of an architecture lives on a tensor ("model") axis.

    PYTHONPATH=<checkout>/src python3 tools/leaf_split_table.py \
        --arch seamless_m4t_large_v2 [--model 2] [--replicas 16]

Prints one markdown row a leaf of the full-width config (its shape as
``init`` makes it on ``meta``, nothing allocated): the storage dim of
its stacked (R, *shape) leaf on a model axis of ``--model`` ranks
(``dist.policies.leaf_split``, the reference's ``_leaf_spec``), the dim
the model computes it on (the model module's ``tensor_dims``, counted in
the stacked leaf), and whether the round step moves it between the two
once a round a replica (``dist.tensor.to_compute`` / ``to_storage``);
then the leaves' entries moved and kept.  Runs on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--replicas", type=int, default=16)
    args = ap.parse_args(argv)
    from repro_torch.configs import get_config
    from repro_torch.dist.policies import leaf_split
    from repro_torch.dist.tensor import shift
    from repro_torch.models.registry import get_model
    from repro_torch.tree import flatten
    cfg = get_config(args.arch).model
    model = get_model(cfg)
    cdims = model.tensor_dims(cfg, args.model)
    leaves = flatten(model.init(cfg, device="meta"))
    print(f"{cfg.name} at full width, model axis {args.model}, R "
          f"{args.replicas}: dims of the stacked (R, *shape) leaf")
    print("| leaf | shape | storage dim | compute dim | moved |")
    print("| --- | --- | --- | --- | --- |")
    moved = kept = 0
    for k, v in leaves.items():
        shape = tuple(v.shape)
        s = leaf_split((args.replicas,) + shape, args.model)
        c = shift(cdims[k], 1)
        n = int(np.prod(shape))
        if s == c:
            kept += n
        else:
            moved += n
        print(f"| {k} | {shape} | {s} | {c} | {'yes' if s != c else 'no'} |")
    print(f"entries a replica: {moved:,} moved, {kept:,} kept in place")


if __name__ == "__main__":
    main()
