"""Edge-backhaul topologies and doubly-stochastic mixing matrices,
Assumption 5, and the gossip operator under backhaul partitions (own copy
of ``repro/core/mixing.py``, numpy).
"""
from __future__ import annotations

import numpy as np


def ring(m: int) -> np.ndarray:
    """Symmetric ring with Metropolis weights (1/3 self + neighbors)."""
    if m == 1:
        return np.ones((1, 1))
    if m == 2:
        return np.array([[0.5, 0.5], [0.5, 0.5]])
    H = np.zeros((m, m))
    for i in range(m):
        H[i, i] = 1 / 3
        H[i, (i + 1) % m] = 1 / 3
        H[i, (i - 1) % m] = 1 / 3
    return H


def complete(m: int) -> np.ndarray:
    return np.full((m, m), 1.0 / m)


def erdos_renyi(m: int, p_edge: float, seed: int = 0) -> np.ndarray:
    """Connected ER graph (ring augmented) with Metropolis–Hastings weights."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), bool)
    for i in range(m):  # ring backbone guarantees connectivity
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
    for i in range(m):
        for j in range(i + 1, m):
            if rng.random() < p_edge:
                adj[i, j] = adj[j, i] = True
    deg = adj.sum(1)
    H = np.zeros((m, m))
    for i in range(m):
        for j in range(m):
            if i != j and adj[i, j]:
                H[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        H[i, i] = 1.0 - H[i].sum()
    return H


def make_mixing(kind: str, m: int, p_edge: float = 0.4,
                seed: int = 0) -> np.ndarray:
    if kind == "ring":
        return ring(m)
    if kind == "complete":
        return complete(m)
    if kind == "erdos_renyi":
        return erdos_renyi(m, p_edge, seed)
    raise ValueError(kind)


def zeta(H: np.ndarray) -> float:
    """Second-largest eigenvalue magnitude (spectral gap parameter)."""
    ev = np.sort(np.abs(np.linalg.eigvalsh(H)))
    return float(ev[-2]) if len(ev) > 1 else 0.0


def check_mixing(H: np.ndarray, atol=1e-9) -> None:
    assert np.allclose(H, H.T, atol=atol), "H must be symmetric"
    assert np.allclose(H.sum(0), 1, atol=atol), "H must be doubly stochastic"
    assert np.all(H >= -atol), "H must be nonnegative"


def participation_mixing(H, conn) -> np.ndarray:
    """The gossip operator under cluster backhaul partitions, in float32.

    ``conn``: (C,) 0/1, 1 where the cluster's link is up.  A partitioned
    cluster's column is zeroed for the other receivers, whose self weight
    absorbs the lost weight (rows stay stochastic), and its own row
    becomes e_c: it keeps its intra-cluster model.  All connected gives H
    bit for bit (off-diagonal entries times 1.0, +0.0 absorbed).

    The reference's arithmetic in float32 (its jnp version under jit),
    with the absorbed row sums taken left to right as XLA takes them."""
    H = np.asarray(H, np.float32)
    conn = np.asarray(conn, np.float32)
    C = H.shape[0]
    one = np.float32(1.0)
    eye = np.eye(C, dtype=np.float32)
    offdiag = H * (one - eye)
    lost = offdiag * (one - conn[None, :])
    acc = np.zeros(C, np.float32)
    for j in range(C):
        acc = acc + lost[:, j]
    self_w = np.diag(H) + acc
    Hm = offdiag * conn[None, :] + eye * self_w[:, None]
    return np.where(conn[:, None] > 0, Hm, eye).astype(np.float32)
