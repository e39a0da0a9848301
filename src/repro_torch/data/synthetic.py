"""Offline synthetic stand-ins for CIFAR-10 and FEMNIST (own copy of
``repro/data/synthetic.py:synthetic_images`` and ``dirichlet_partition``,
numpy): the exact shapes (32x32x3 / 10 classes, 28x28x1 / 62 classes),
learnable class prototypes with per-sample sign, brightness and noise, and
the paper's Dirichlet(beta) non-IID partition.  The token and population
shards wait for their slices (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def synthetic_images(kind: str, n: int, seed: int = 0, noise: float = 0.6,
                     class_seed: int = 777) -> Tuple[np.ndarray, np.ndarray]:
    """kind: 'cifar' (32x32x3, 10 cls) or 'femnist' (28x28x1, 62 cls).

    Class prototypes come from ``class_seed`` (FIXED) so train/test splits
    drawn with different ``seed`` values share the same class structure."""
    if kind == "cifar":
        hw, ch, ncls = 32, 3, 10
    elif kind == "femnist":
        hw, ch, ncls = 28, 1, 62
    else:
        raise ValueError(kind)
    protos = np.random.default_rng(class_seed).normal(
        0, 1, (ncls, hw, hw, ch)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, ncls, n)
    imgs = protos[labels]
    # random global sign flip per sample: class MEANS are zero, so the task
    # is not linearly separable and convergence takes a realistic number of
    # rounds (a pure prototype task saturates in <5 rounds).
    sign = rng.choice([-1.0, 1.0], (n, 1, 1, 1)).astype(np.float32)
    imgs = imgs * sign * rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(
        np.float32)
    imgs = imgs + noise * rng.normal(0, 1, imgs.shape).astype(np.float32)
    return imgs, labels.astype(np.int32)


def dirichlet_partition(labels: np.ndarray, n_devices: int, beta: float,
                        seed: int = 0, min_per_device: int = 8
                        ) -> List[np.ndarray]:
    """Paper Sec 6.1: partition sample indices by Dirichlet(beta) class mix."""
    rng = np.random.default_rng(seed)
    ncls = int(labels.max()) + 1
    idx_by_cls = [np.where(labels == c)[0] for c in range(ncls)]
    for idx in idx_by_cls:
        rng.shuffle(idx)
    device_idx: List[List[int]] = [[] for _ in range(n_devices)]
    for c, idx in enumerate(idx_by_cls):
        props = rng.dirichlet([beta] * n_devices)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for d, part in enumerate(np.split(idx, cuts)):
            device_idx[d].extend(part.tolist())
    out = []
    all_idx = np.arange(len(labels))
    for d in range(n_devices):
        idx = np.array(device_idx[d], np.int64)
        if len(idx) < min_per_device:  # top up from the global pool
            extra = rng.choice(all_idx, min_per_device - len(idx))
            idx = np.concatenate([idx, extra])
        rng.shuffle(idx)
        out.append(idx)
    return out
