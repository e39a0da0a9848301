"""Carry the reference's parameters over to the port.

``params_from_jax(jax.tree.map(np.asarray, params), device)`` turns the JAX
package's parameter tree (nested dicts of numpy arrays) into the port's
parameter dict, leaf for leaf and bit for bit (bfloat16 included).
``client_half_from_jax`` does the same for per-client state: a reference
``FLState``'s client half (``ef``, ``momentum``, ``wire_ef``, None fields
kept) or a reference ``PopulationStore.gather`` result, so that both
packages start from one state.
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
