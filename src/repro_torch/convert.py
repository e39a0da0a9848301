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
host memory.  With a "model" axis (``dist.policies``) a rank holds a slab
of each stacked leaf: its rows and its 1 / n of the leaf's ``leaf_split``
dim, contiguous, the reference's shard-local layout; ``shard_slabs`` /
``gather_slabs`` / ``gather_slabs_to_host`` / ``scatter_slabs_from_host``
are the slab counterparts, ``slab_params`` a rank's pieces of an
unstacked parameter dict.
"""
from __future__ import annotations

import torch

from repro_torch.device import from_numpy, resolve
from repro_torch.dist.tensor import piece


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


def _walk(fn, tree, dims, other=None):
    """fn(leaf, dim) over a nested dict of leaves (None kept) beside a
    dict of the same nesting (or a sub-nesting: a state field's dims are
    the params'); with ``other`` (a tree of the same nesting, or None)
    fn(leaf, dim, other's leaf or None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(fn, v, dims[k] if isinstance(dims, dict) and k in
                         dims else dims,
                         other if other is None else other[k])
                for k, v in tree.items()}
    return fn(tree, dims) if other is None else fn(tree, dims, other)


def slab_params(params, policy, dims):
    """This rank's model pieces of an unstacked parameter dict (the
    initial weights every replica starts from): each leaf's 1 / n of its
    stacked split dim less one, as contiguous copies; ``dims`` the
    stacked leaves' ``policy.storage_dims``."""
    n, i = policy.model, policy.model_index
    return _walk(lambda x, d: piece(x, None if d is None else d - 1, n,
                                     i).contiguous(), params, dims)


def shard_slabs(tree, policy, dims):
    """This rank's slab of every leaf of a stacked (R, ...) tree: its
    rows over the replica axes (``shard_rows``), then its 1 / n of the
    leaf's ``dims`` entry over the tensor axes, contiguous.  ``dims``:
    ``policy.storage_dims`` of the params (every state field is
    params-shaped)."""
    mesh, rep = policy.mesh, policy.replica_axes
    nr, f = mesh.size(rep), mesh.flat_index(rep)
    n, i = policy.model, policy.model_index
    return _walk(lambda x, d: _cut(x, d, nr, f, n, i).contiguous(), tree,
                 dims)


def _cut(x, dim, nr, f, n, i):
    """The slab of a stacked (R, ...) leaf at replica flat index f of nr
    and model index i of n: rows [f R / nr, (f + 1) R / nr), then the
    i-th of n pieces of ``dim`` (None: whole), a view."""
    if x.shape[0] % nr:
        raise ValueError(f"{x.shape[0]} rows do not tile {nr} ranks")
    r = x.shape[0] // nr
    return piece(x[f * r:(f + 1) * r], dim, n, i)


def _join(parts, dim):
    """The model pieces of a leaf (a list in rank order) put back on
    ``dim`` (None: every piece is the whole leaf; the first is kept)."""
    return parts[0] if dim is None else torch.cat(list(parts), dim=dim)


def gather_slabs(tree, policy, dims):
    """The inverse of ``shard_slabs``: every leaf's (R, ...) whole on
    every rank, gathered over the tensor axes and then the rows."""
    mesh, axes = policy.mesh, policy.tensor_axes
    whole = _walk(lambda x, d: _join(mesh.all_gather(x, axes).unbind(0), d),
                  tree, dims)
    return gather_rows(whole, mesh, policy.replica_axes)


def gather_slabs_to_host(tree, policy, dims):
    """Every rank's slab of each leaf, leaf by leaf, reassembled as the
    (R, ...) leaf in host memory on world rank 0 (``RankMesh.gather_to``
    over the replica and the tensor axes; no card holds another rank's
    slab); None on the other ranks."""
    mesh = policy.mesh
    rep, ten = tuple(policy.replica_axes), tuple(policy.tensor_axes)
    nr, nm = mesh.size(rep), mesh.size(ten)
    lead = mesh.rank == 0

    def put(x, d):
        got = mesh.gather_to(x, rep + ten)
        if got is None:
            return None
        g = got.view((nr, nm) + tuple(x.shape))
        return torch.cat([_join(g[r].unbind(0), d) for r in range(nr)])
    out = _walk(put, tree, dims)
    return out if lead else None


def scatter_slabs_from_host(tree, policy, dims, out):
    """The inverse of ``gather_slabs_to_host``: world rank 0's (R, ...)
    leaves of ``tree`` (None on the other ranks) cut into every rank's
    slab (``shard_slabs``' cut) and copied, leaf by leaf, into each
    rank's leaf of ``out`` (its slabs, the same nesting as ``tree``), in
    place (``RankMesh.scatter_from`` over the replica and the tensor
    axes).  Returns ``out``."""
    mesh = policy.mesh
    rep, ten = tuple(policy.replica_axes), tuple(policy.tensor_axes)
    nr, nm = mesh.size(rep), mesh.size(ten)

    def put(v, d, w=None):
        parts = None if w is None else torch.stack([
            _cut(w, d, nr, f, nm, m) for f in range(nr) for m in range(nm)])
        v.copy_(mesh.scatter_from(parts, rep + ten, v))
    _walk(put, out, dims, tree if mesh.rank == 0 else None)
    return out
