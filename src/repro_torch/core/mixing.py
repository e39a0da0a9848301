"""Edge-backhaul topologies and doubly-stochastic mixing matrices,
Assumption 5 (own copy of ``repro/core/mixing.py``, numpy).
``participation_mixing`` waits for the degraded-mode slice (ROADMAP.md).
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
