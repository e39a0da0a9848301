"""Carry the reference's parameters over to the port.

``params_from_jax(jax.tree.map(np.asarray, params), device)`` turns the JAX
package's parameter tree (nested dicts of numpy arrays) into the port's
parameter dict, leaf for leaf and bit for bit (bfloat16 included).
``client_half_from_jax`` does the same for per-client state: a reference
``FLState``'s client half (``ef``, ``momentum``, ``wire_ef``, None fields
kept) or a reference ``PopulationStore.gather`` result, so that both
packages start from one state.  ``shard_rows`` / ``gather_rows`` take a
rank's contiguous rows of a stacked state and put them back (a rank mesh,
``dist/mesh.py``); ``gather_rows_to_host`` puts them back in one rank's
host memory.
"""
from __future__ import annotations

import torch

from repro_torch.device import from_numpy, resolve


def params_from_jax(np_tree, device, dtype: torch.dtype = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``; ``dtype`` casts every floating leaf."""
    dev = resolve(device)
    out = {}
    for name, leaf in np_tree.items():
        if isinstance(leaf, dict):
            out[name] = params_from_jax(leaf, dev, dtype)
            continue
        t = from_numpy(leaf, dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[name] = t
    return out


def client_half_from_jax(np_tree, device):
    """Per-client state of the reference (nested dicts of numpy arrays,
    None subtrees kept as None; ``jax.tree.map(np.asarray, ...)`` of
    ``split_state(state)[1]`` or of ``store.gather(ids)``) -> the same
    dicts of tensors on ``device``, bit for bit."""
    return {name: (None if leaf is None else
                   params_from_jax(leaf, device) if isinstance(leaf, dict)
                   else params_from_jax({name: leaf}, device)[name])
            for name, leaf in np_tree.items()}


def shard_rows(tree, mesh, axes):
    """This rank's contiguous rows of every leaf of a stacked (R, ...)
    tree (nested dicts, None kept): rows [f R_local, (f + 1) R_local) for
    the flat index f over ``axes`` of ``mesh``, as contiguous copies."""
    n, f = mesh.size(axes), mesh.flat_index(axes)

    def take(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not tile {n} ranks")
        r = x.shape[0] // n
        return x[f * r:(f + 1) * r].contiguous()
    return take(tree)


def gather_rows(tree, mesh, axes):
    """The inverse of ``shard_rows``: every rank's rows of each leaf
    gathered over ``axes`` into the (R, ...) leaf, on every rank."""
    def put(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return mesh.all_gather(x, axes).reshape(
            (-1,) + tuple(x.shape[1:]))
    return put(tree)


def gather_rows_to_host(tree, mesh, axes):
    """Every rank's rows of each leaf, leaf by leaf, as the (R, ...) leaf
    in host memory on the rank at flat index 0 over ``axes``
    (``RankMesh.gather_to``; no rank's card holds another's rows); None on
    the other ranks."""
    lead = mesh.flat_index(axes) == 0

    def put(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        got = mesh.gather_to(x, axes)
        return None if got is None else got.reshape(
            (-1,) + tuple(x.shape[1:]))
    out = put(tree)
    return out if lead else None
