"""Population store: every logical client's persistent FL state, paged
(port of ``repro/runtime/population.py``).

The round holds a cohort of R slots (DESIGN.md §Cohort contract); the
store holds the per-client half of the state (error feedback, momentum,
wire-EF estimates) of a population of N >= R logical clients, and the
per-client accounting (participations, energy and time spent) that
``core.controller.population_energy_caps`` reads.

Memory: at most ``resident_max`` clients' state is held, in an LRU of
host tensors; an evicted client spills to one page, a ``.npy`` of its
leaves' bytes in key order (``runtime/checkpoint._atomic_write``: a
hidden temporary file, fsync, rename, so a write cut short leaves the
previous page).  A client that
never took part holds nothing: its state is the zero tree.  Pages are
versioned (``client_00000042.v000003.npy``); a spill writes version v+1
and deletes v unless a ``save`` manifest pins it, so ``restore`` rewinds
to the saved versions bit for bit.

``gather`` / ``scatter`` copy state between slots and the store with no
arithmetic, so the population-global EF sum (``aggregate``, in float64,
client by client in id order) is the same before and after a cohort swap
(``runtime/elastic.cohort_swap``), under ``==``.  Each stored client's
sums are kept until its state is written again.

Leaves are the port's state dicts flattened in key order (``tree.
flatten``).  The pages and manifests are the port's own (the reference's
store does not read them; its pages are ``.npz`` archives).

Across the ranks of a ``dist.mesh.RankMesh`` (``RankPopulation``, the
train launcher's ``--population`` on more than one rank) there is still
one store, on world rank 0: one page root, one manifest.  Every rank
keeps the same host accounting.  A cohort swap brings the slots'
per-client rows of every rank into host memory on that rank, runs the
one-process swap on all R rows in their order, and sends each rank its
rows back; so the store sees the rows of the 1-rank run, and its pages,
manifests and sums are that run's bits.  With a "model" axis a rank
holds slabs of its rows (``convert.shard_slabs``): the swap joins every
rank's slabs on their storage dims (``convert.gather_slabs_to_host``),
so that the store's pages hold whole client rows in the reference's
layout, and cuts the rows back into slabs
(``convert.scatter_slabs_from_host``).
"""
from __future__ import annotations

import json
import zipfile
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.checkpoint import CheckpointError, _atomic_write
from repro_torch.runtime.elastic import cohort_swap, verified_swap
from repro_torch.tree import flatten

# a leaf row at least this large moves between the card and the host on
# its own; smaller rows move as one copy of the whole leaf
ROW_COPY_BYTES = 1 << 20
_ACCOUNTING = ("rounds_participated", "last_round", "energy_spent",
               "time_spent")


def _unflatten(flat: Dict[str, Any]):
    out: Dict = {}
    for key, leaf in flat.items():
        node = out
        *parents, name = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return out


def _flat(tree) -> Dict[str, Any]:
    """Nested dicts (None subtrees allowed, carrying nothing) -> flat."""
    return flatten({k: v for k, v in tree.items() if v is not None})


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(dtype) if dtype == torch.bfloat16 else t.to(dtype)


def _by_row(t: torch.Tensor) -> bool:
    """A card leaf whose rows move between card and host one by one."""
    return t.is_cuda and t[0].numel() * t.element_size() >= ROW_COPY_BYTES


def _rows_to_host(leaf: torch.Tensor, dtype: torch.dtype, into) -> list:
    """(n, ...) -> n host tensors of their own (never views of ``leaf``);
    by row, into ``into[r]`` where it is a host row already held (memory
    in use takes a copy from the card at 6.70 GB/s, fresh memory at 2.32:
    tools/swap_bench.py on an H100 80GB HBM3 host)."""
    if _by_row(leaf):
        return [leaf[r].to("cpu", dtype) if into[r] is None
                else into[r].copy_(leaf[r]) for r in range(leaf.shape[0])]
    block = leaf.detach().to("cpu", dtype)
    return [row.clone() for row in block]


def _f64_sum(t: torch.Tensor) -> float:
    """float64 sum in numpy's order (the reference's ``aggregate``)."""
    return float(np.sum(t.detach().cpu().to(torch.float64).numpy()))


class PopulationStore:
    """Per-client paged state of ``population`` logical clients.

    ``template``: nested dicts of per-client leaves (no slot dim), each
    with ``.shape`` and a torch ``.dtype`` (e.g. ``core.round.
    client_template``'s meta tensors); None subtrees carry nothing.
    ``root=None`` keeps every client resident (no spill); with a ``root``
    directory at most ``resident_max`` clients stay in the LRU."""

    def __init__(self, population: int, template: Any, *,
                 root: Optional[Path] = None, resident_max: int = 256):
        if population <= 0:
            raise ValueError(f"population must be positive, got {population}")
        if root is None and resident_max < population:
            # no spill target: dropping an LRU entry would lose its state
            resident_max = population
        if resident_max <= 0:
            raise ValueError(f"resident_max must be positive, "
                             f"got {resident_max}")
        self.population = int(population)
        self.resident_max = int(resident_max)
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
        flat = _flat(template)
        self.keys = list(flat)
        self.shapes = [tuple(v.shape) for v in flat.values()]
        self.dtypes = [v.dtype for v in flat.values()]
        self.page_bytes = sum(
            int(np.prod(s, dtype=np.int64))
            * torch.empty((), dtype=d).element_size()
            for s, d in zip(self.shapes, self.dtypes))
        self._resident: "OrderedDict[int, list]" = OrderedDict()
        self._dirty: set = set()
        self._ver: Dict[int, int] = {}     # id -> latest version on disk
        self._pinned: Dict[int, int] = {}  # versions the last save pins
        # id -> each leaf's float64 sum (None: not taken yet), for
        # ``aggregate``; dropped when the client's state is written
        self._sums: Dict[int, list] = {}
        # O(population) accounting
        self.rounds_participated = np.zeros(self.population, np.int64)
        self.last_round = np.full(self.population, -1, np.int64)
        self.energy_spent = np.zeros(self.population, np.float64)
        self.time_spent = np.zeros(self.population, np.float64)

    @property
    def resident_count(self) -> int:
        return len(self._resident)

    @property
    def touched(self) -> set:
        """Clients whose state is held (possibly nonzero)."""
        return set(self._resident) | set(self._ver)

    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 1:
            raise ValueError(f"ids must be 1-D, got shape {ids.shape}")
        if len(np.unique(ids)) != ids.size:
            raise ValueError("cohort ids must be unique (two slots cannot "
                             "own the same client's state)")
        if ids.size and (ids.min() < 0 or ids.max() >= self.population):
            raise ValueError(f"ids out of range(population="
                             f"{self.population})")
        return ids

    # -- paging ------------------------------------------------------------
    def _page_path(self, cid: int, ver: int) -> Path:
        return self.root / f"client_{cid:08d}.v{ver:06d}.npy"

    def _zeros(self) -> list:
        return [torch.zeros(s, dtype=d) for s, d in zip(self.shapes,
                                                        self.dtypes)]

    def _load_page(self, cid: int) -> list:
        path = self._page_path(cid, self._ver[cid])
        try:
            raw = torch.from_numpy(np.load(path))
        except (ValueError, OSError, EOFError) as e:
            raise CheckpointError(f"{path}: unreadable page ({e})") from e
        if raw.dtype != torch.uint8 or raw.numel() != self.page_bytes:
            raise CheckpointError(f"{path}: {raw.numel()} bytes of "
                                  f"{raw.dtype}, expected {self.page_bytes} "
                                  f"of uint8")
        rows, at = [], 0
        for s, d in zip(self.shapes, self.dtypes):
            n = int(np.prod(s, dtype=np.int64)) * torch.empty(
                (), dtype=d).element_size()
            rows.append(raw[at:at + n].view(d).view(s))
            at += n
        return rows

    def _spill(self, cid: int, rows: list) -> None:
        """Write ``cid``'s state as a new page version; the old one stays
        if the write is cut short, or if a manifest pins it."""
        old = self._ver.get(cid, 0)
        raw = torch.cat([r.contiguous().view(-1).view(torch.uint8)
                         for r in rows]).numpy()

        def write(tmp):
            with open(tmp, "wb") as f:  # a handle: save would add .npy
                np.save(f, raw)
        _atomic_write(self._page_path(cid, old + 1), write)
        self._ver[cid] = old + 1
        if old and old != self._pinned.get(cid):
            self._page_path(cid, old).unlink(missing_ok=True)

    def _evict_lru(self) -> None:
        while len(self._resident) > self.resident_max:
            cid, rows = self._resident.popitem(last=False)
            if cid in self._dirty:
                self._spill(cid, rows)
                self._dirty.discard(cid)

    def flush(self) -> None:
        """Spill every dirty resident client (no-op without a root)."""
        if self.root is None:
            return
        for cid in sorted(self._dirty):
            self._spill(cid, self._resident[cid])
        self._dirty.clear()

    # -- gather / scatter --------------------------------------------------
    def _client_rows(self, cid: int, *, lru: bool = True) -> list:
        if cid in self._resident:
            if lru:
                self._resident.move_to_end(cid)
            return self._resident[cid]
        if cid in self._ver:
            return self._load_page(cid)
        return self._zeros()

    def gather(self, ids: Sequence[int], out=None):
        """A cohort's stacked state, row r = client ids[r] (resident,
        paged in, or zeros for a first-time client): nested dicts of (n,
        ...) host tensors, or written into ``out`` (the same nesting, on
        any device) and ``out`` returned."""
        ids = self._check_ids(ids)
        if out is None:
            rows = [self._client_rows(int(cid)) for cid in ids]
            return _unflatten({k: torch.stack([r[j] for r in rows])
                               for j, k in enumerate(self.keys)})
        dst = _flat(out)
        self._check_leaves(ids, dst)
        # a first-time client's rows are zeroed where they lie
        rows = [self._client_rows(int(cid)) if int(cid) in self.touched
                else None for cid in ids]
        zeros = None
        for j, k in enumerate(self.keys):
            d = dst[k]
            if not _by_row(d):
                zeros = zeros or self._zeros()
                d.copy_(torch.stack([zeros[j] if r is None else r[j]
                                     for r in rows]))
                continue
            for i, r in enumerate(rows):
                if r is None:
                    d[i].zero_()
                else:
                    d[i].copy_(r[j])
        return out

    def _check_leaves(self, ids, flat: Dict[str, Any]) -> None:
        if list(flat) != self.keys:
            raise ValueError(
                f"state tree has leaves {list(flat)[:4]}..., the store's "
                f"template {self.keys[:4]}... (the state split drifted "
                f"from the template)")
        for k, s in zip(self.keys, self.shapes):
            if tuple(flat[k].shape) != (ids.size,) + s:
                raise ValueError(f"leaf {k!r} has shape "
                                 f"{tuple(flat[k].shape)}, expected "
                                 f"{(ids.size,) + s}")

    def scatter(self, ids: Sequence[int], stacked) -> None:
        """Write a cohort's state back, row r to client ids[r]: copies
        only, so with ``gather`` the population-global sums hold."""
        ids = self._check_ids(ids)
        flat = _flat(stacked)
        self._check_leaves(ids, flat)
        held = [self._resident.get(int(cid)) for cid in ids]
        per_leaf = [_rows_to_host(flat[k], d, [None if h is None else h[j]
                                               for h in held])
                    for j, (k, d) in enumerate(zip(self.keys, self.dtypes))]
        for r, cid in enumerate(ids):
            cid = int(cid)
            self._resident[cid] = [rows[r] for rows in per_leaf]
            self._resident.move_to_end(cid)
            self._dirty.add(cid)
            self._sums.pop(cid, None)
        self._evict_lru()

    # -- accounting --------------------------------------------------------
    def record_round(self, ids: Sequence[int], round_idx: int, *,
                     energy=None, time=None) -> None:
        """One round's cohort in the per-client accounting."""
        ids = self._check_ids(ids)
        self.rounds_participated[ids] += 1
        self.last_round[ids] = int(round_idx)
        if energy is not None:
            self.energy_spent[ids] += np.asarray(energy, np.float64)
        if time is not None:
            self.time_spent[ids] += np.asarray(time, np.float64)

    # -- invariants --------------------------------------------------------
    def aggregate(self, key_prefix: str = "", *, extra_ids=None,
                  extra: Any = None) -> np.float64:
        """The population-global float64 sum of the stored leaves whose
        key starts with ``key_prefix`` (e.g. "ef"), client by client in id
        order, so the sum does not depend on which clients are in slots.
        ``extra_ids`` / ``extra``: a cohort now in the slots (stacked,
        any device), counted in place of the store's copy of those ids."""
        sel = [k.startswith(key_prefix) for k in self.keys]
        extra_rows: Dict[int, list] = {}
        if extra_ids is not None:
            eids = self._check_ids(extra_ids)
            flat = _flat(extra)
            leaves = [flat.get(k) for k in self.keys]
            for r, cid in enumerate(eids):
                extra_rows[int(cid)] = [None if l is None else l[r]
                                        for l in leaves]
        total = np.float64(0.0)
        for cid in sorted(self.touched | set(extra_rows)):
            rows = extra_rows.get(cid)
            if rows is not None:
                sums = [_f64_sum(l) if m else None
                        for l, m in zip(rows, sel)]
            else:
                sums = self._sums.setdefault(cid, [None] * len(sel))
                if any(m and x is None for x, m in zip(sums, sel)):
                    rows = self._client_rows(cid, lru=False)
                    for j, m in enumerate(sel):
                        if m and sums[j] is None:
                            sums[j] = _f64_sum(rows[j])
            total += np.float64(sum(x for x, m in zip(sums, sel) if m))
        return total

    # -- checkpoint --------------------------------------------------------
    def save(self, manifest: Path) -> None:
        """Flush, then write a manifest pinning each client's page version
        and the accounting; without a root the touched clients' state is
        in the manifest itself."""
        manifest = Path(manifest)
        manifest.parent.mkdir(parents=True, exist_ok=True)
        arrays = {f"accounting/{a}": getattr(self, a) for a in _ACCOUNTING}
        meta: Dict[str, Any] = {"population": self.population,
                                "embedded": self.root is None}
        if self.root is None:
            ids = sorted(self.touched)
            meta["touched"] = ids
            for cid in ids:
                for k, r in zip(self.keys, self._client_rows(cid,
                                                             lru=False)):
                    arrays[f"clients/{cid}/{k}"] = _to_numpy(r)
        else:
            self.flush()
            meta["versions"] = {str(cid): v for cid, v in
                                sorted(self._ver.items())}
        arrays["__meta_json__"] = np.frombuffer(json.dumps(meta).encode(),
                                                dtype=np.uint8)

        def write(tmp):
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
        _atomic_write(manifest, write)
        if self.root is not None:
            self._pinned = dict(self._ver)

    def restore(self, manifest: Path) -> None:
        """Rewind to a manifest: page versions, accounting, working set.
        Pages written after the save are not read."""
        manifest = Path(manifest)
        try:
            with np.load(manifest) as data:
                meta = json.loads(bytes(data["__meta_json__"]).decode())
                acct = {a: np.array(data[f"accounting/{a}"])
                        for a in _ACCOUNTING}
                clients = {}
                if meta.get("embedded"):
                    for cid in meta.get("touched", []):
                        clients[int(cid)] = [
                            _from_numpy(data[f"clients/{cid}/{k}"], d)
                            for k, d in zip(self.keys, self.dtypes)]
        except (KeyError, ValueError, OSError, EOFError,
                zipfile.BadZipFile) as e:
            raise CheckpointError(f"{manifest}: not a population manifest "
                                  f"({e})") from e
        if int(meta["population"]) != self.population:
            raise CheckpointError(
                f"{manifest}: population {meta['population']} != store's "
                f"{self.population}")
        self.rounds_participated = acct["rounds_participated"].astype(
            np.int64)
        self.last_round = acct["last_round"].astype(np.int64)
        self.energy_spent = acct["energy_spent"].astype(np.float64)
        self.time_spent = acct["time_spent"].astype(np.float64)
        self._resident.clear()
        self._dirty.clear()
        self._sums.clear()
        if meta.get("embedded"):
            self._ver = {}
            for cid, rows in clients.items():
                self._resident[cid] = rows
        else:
            self._ver = {int(cid): int(v)
                         for cid, v in meta.get("versions", {}).items()}
            self._pinned = dict(self._ver)
            missing = [cid for cid in self._ver
                       if not self._page_path(cid, self._ver[cid]).exists()]
            if missing:
                raise CheckpointError(
                    f"{manifest}: pinned pages missing for clients "
                    f"{missing[:8]} (page dir does not match manifest)")


class RankPopulation:
    """The population store of a cohort split over the ranks of
    ``policy``: its rows over the replica axes, each row's leaves further
    split into slabs over the tensor axes (``dims``: the params'
    ``policy.storage_dims``, None without a model axis; together the axes
    must span the mesh's world).  The ``PopulationStore`` of WHOLE client
    rows on world rank 0 (``store``, None elsewhere; ``template`` is one
    client's whole page, ``core.round.client_template`` of an unsplit
    state), the accounting on every rank.  ``root`` and ``resident_max``
    are the store's; only that rank writes pages and manifests."""

    def __init__(self, policy, population: int, template: Any, dims=None,
                 *, root: Optional[Path] = None, resident_max: int = 256):
        self.policy, self.dims = policy, dims
        self.mesh = mesh = policy.mesh
        span = tuple(policy.replica_axes) + tuple(policy.tensor_axes)
        if mesh.size(span) != mesh.world:
            raise ValueError(f"replica and tensor axes {span} span "
                             f"{mesh.size(span)} of {mesh.world} ranks")
        self.lead = mesh.rank == 0
        self.population = int(population)
        self.store = (PopulationStore(population, template, root=root,
                                      resident_max=resident_max)
                      if self.lead else None)
        # the other ranks' accounting: a store that never holds a client
        self._acct = self.store or PopulationStore(population, template)
        self.resident_count = 0

    @property
    def rounds_participated(self) -> np.ndarray:
        return self._acct.rounds_participated

    @property
    def energy_spent(self) -> np.ndarray:
        return self._acct.energy_spent

    @property
    def last_round(self) -> np.ndarray:
        return self._acct.last_round

    @property
    def time_spent(self) -> np.ndarray:
        return self._acct.time_spent

    def record_round(self, ids, round_idx: int, *, energy=None,
                     time=None) -> None:
        """``PopulationStore.record_round``, on every rank with the same
        arguments."""
        self._acct.record_round(ids, round_idx, energy=energy, time=time)

    def swap(self, client, out_ids, in_ids, *, verify: bool = False):
        """The cohort swap ``out_ids`` -> ``in_ids`` (``out_ids`` None:
        the first cohort into the slots) on this rank's slots ``client``
        (the client half of its rows, its slabs on a model axis), in
        place: the slots' rows reassembled on rank 0's host
        (``convert.gather_slabs_to_host``), the one-process swap there,
        the rows cut back into every rank's slabs
        (``convert.scatter_slabs_from_host``).  Returns (clients moved
        between the card and the host, the ``verified_swap`` record or
        None), the same on every rank."""
        from repro_torch.convert import (gather_slabs_to_host,
                                         scatter_slabs_from_host)
        store, ids = self.store, np.asarray(in_ids).tolist()
        if out_ids is None and not self.mesh.broadcast_object(
                self.lead and bool(store.touched & set(ids)), src=0):
            # first-time clients: their rows are zeros where they lie
            for v in _flat(client).values():
                v.zero_()
            return 0, None
        tree = gather_slabs_to_host(client, self.policy, self.dims)
        info = None
        if self.lead:
            held = store.touched | set(() if out_ids is None
                                       else np.asarray(out_ids).tolist())
            moved = sum(int(c) in held for c in ids)

            def move():
                if out_ids is None:
                    store.gather(in_ids, out=tree)
                else:
                    cohort_swap(tree, out_ids, in_ids, store)
            check = None
            if verify and out_ids is not None:
                check = verified_swap(move, store, tree, out_ids, in_ids)
            else:
                move()
            if out_ids is not None:
                moved += len(ids)
            info = (moved, check, store.resident_count)
        moved, check, self.resident_count = self.mesh.broadcast_object(
            info, src=0)
        scatter_slabs_from_host(tree, self.policy, self.dims, client)
        return moved, check

    def save(self, manifest: Path) -> None:
        """The store's manifest, written by the rank that holds it."""
        if self.lead:
            self.store.save(manifest)
