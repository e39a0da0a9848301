"""Offline synthetic stand-ins for CIFAR-10 and FEMNIST (own copy of
``repro/data/synthetic.py:synthetic_images`` and ``dirichlet_partition``,
numpy): the exact shapes (32x32x3 / 10 classes, 28x28x1 / 62 classes),
learnable class prototypes with per-sample sign, brightness and noise, and
the paper's Dirichlet(beta) non-IID partition; and the device-skewed token
corpus of the LM round (``_shared_topics``, ``client_token_shard``,
``synthetic_tokens``), the same numbers as the reference's; and the
per-client vision shards of population mode (``client_image_shard``) and
``batch_iterator``.
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


_TOPIC_CACHE: dict = {}


def _shared_topics(vocab: int, seed: int, K: int = 8) -> np.ndarray:
    """K shared 'topic' unigram models (synthetic.py:85), cached."""
    key = (vocab, seed, K)
    if key not in _TOPIC_CACHE:
        rng = np.random.default_rng(seed)
        _TOPIC_CACHE[key] = rng.dirichlet([0.1] * vocab, K)
    return _TOPIC_CACHE[key]


def client_token_shard(vocab: int, n_seq: int, seq_len: int, client_id: int,
                       beta: float = 1.0, seed: int = 0) -> np.ndarray:
    """One client's non-IID LM shard (synthetic.py:97): (n_seq, seq_len)
    int32 from SeedSequence([seed, 31337, client_id]); topic weights ~
    Dirichlet(beta), and every odd position is the previous token + 1."""
    topics = _shared_topics(vocab, seed)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 31337, int(client_id)]))
    mix = rng.dirichlet([beta] * topics.shape[0])
    probs = mix @ topics
    draws = rng.choice(vocab, (n_seq, seq_len), p=probs)
    n_odd = draws[:, 1::2].shape[1]
    draws[:, 1::2] = (draws[:, 0:2 * n_odd:2] + 1) % vocab
    return draws.astype(np.int32)


def synthetic_tokens(vocab: int, n_seq: int, seq_len: int, n_devices: int,
                     beta: float = 1.0, seed: int = 0) -> np.ndarray:
    """Device-skewed synthetic LM corpus (synthetic.py:120): (n_devices,
    n_seq, seq_len) int32, device d holding client shard d."""
    return np.stack([
        client_token_shard(vocab, n_seq, seq_len, d, beta=beta, seed=seed)
        for d in range(n_devices)])


def client_image_shard(kind: str, n: int, client_id: int, beta: float = 1.0,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """One logical client's non-IID vision shard (synthetic.py:123): (n,
    H, W, C) images and labels from SeedSequence([seed, 31337, id]), the
    label mix ~ Dirichlet(beta), the class prototypes pinned to seed 777."""
    if kind == "cifar":
        hw, ch, ncls = 32, 3, 10
    elif kind == "femnist":
        hw, ch, ncls = 28, 1, 62
    else:
        raise ValueError(kind)
    protos = np.random.default_rng(777).normal(
        0, 1, (ncls, hw, hw, ch)).astype(np.float32)
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, 31337, int(client_id)]))
    mix = rng.dirichlet([beta] * ncls)
    labels = rng.choice(ncls, n, p=mix)
    imgs = protos[labels]
    sign = rng.choice([-1.0, 1.0], (n, 1, 1, 1)).astype(np.float32)
    imgs = imgs * sign * rng.uniform(0.7, 1.3, (n, 1, 1, 1)).astype(
        np.float32)
    imgs = imgs + 0.6 * rng.normal(0, 1, imgs.shape).astype(np.float32)
    return imgs, labels.astype(np.int32)


def batch_iterator(arrays, batch_size: int, seed: int = 0):
    """Infinite shuffled minibatch iterator over aligned arrays."""
    n = len(arrays[0])
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = order[i:i + batch_size]
            yield tuple(a[sel] for a in arrays)
