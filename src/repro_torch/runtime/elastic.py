"""Elastic scaling and cohort rotation of the FL state (port of
``repro/runtime/elastic.py``).

``resize_state`` maps stacked (R, ...) state onto R' = clusters' x
devices_per_cluster' slots:
  * growing (R' >= R): new devices join their cluster's model with zero
    error feedback; surviving devices keep their EF, scaled by R'/R, so
    each cluster's model plus mean EF is unchanged;
  * shrinking (R' < R): the departing devices' EF is folded into the
    cluster average.
Either way the model every cluster would reach with all pending EF
uploaded is preserved.

``cohort_swap`` rotates a population's cohorts through the slots
(DESIGN.md §Cohort contract): the outgoing clients' state goes back to
``runtime/population.PopulationStore`` and the incoming cohort's comes
into the same slots, copies only, so the population-global EF sum is
conserved exactly; ``verified_swap`` runs a swap between two sums of the
population and records whether they held.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLTopology
from repro_torch.tree import tree_map


def cohort_swap(client_half, out_ids, in_ids, store):
    """Scatter the slots' per-client state (``core.round.split_state``'s
    client half: nested dicts of (R, ...) tensors, None fields allowed)
    to the store under ``out_ids``, then gather the ``in_ids`` cohort's
    into the same tensors, in place, and return them."""
    out_ids = np.asarray(out_ids, np.int64)
    in_ids = np.asarray(in_ids, np.int64)
    if out_ids.shape != in_ids.shape:
        raise ValueError(f"cohort size changed across swap: "
                         f"{out_ids.shape} -> {in_ids.shape} (resize the "
                         f"topology via resize_state first)")
    store.scatter(out_ids, client_half)
    return store.gather(in_ids, out=client_half)


def verified_swap(swap: Callable[[], Any], store, client_half, out_ids,
                  in_ids) -> Dict[str, Any]:
    """Run ``swap()``, the cohort swap ``out_ids`` -> ``in_ids`` on the
    slots ``client_half``, between two float64 sums of the population
    (``store.aggregate``, client by client in id order, the clients in
    the slots counted from the slots): of its EF, and of its whole
    per-client state.  Returns the record ``FedSim`` and the train
    launcher keep in the swapped round's history: the sums before and
    after, whether they are equal, and the sums' host ms."""
    def sums(ids):
        return [float(store.aggregate(prefix, extra_ids=ids,
                                      extra=client_half))
                for prefix in ("ef", "")]

    t0 = time.perf_counter()
    before = sums(out_ids)
    host_s = time.perf_counter() - t0
    swap()
    t0 = time.perf_counter()
    after = sums(in_ids)
    host_s += time.perf_counter() - t0
    return {"ef_before": before[0], "ef_after": after[0],
            "state_before": before[1], "state_after": after[1],
            "equal": before == after, "host_ms": host_s * 1e3}


def _cluster_avg(x, C, Dev):
    return x.reshape(C, Dev, *x.shape[1:]).mean(dim=1)


def resize_state(params, ef, momentum, old: FLTopology, new: FLTopology
                 ) -> Tuple[Any, Any, Any]:
    """Map stacked (R_old, ...) state dicts onto (R_new, ...)."""
    Co, Do = old.clusters, old.devices_per_cluster
    Cn, Dn = new.clusters, new.devices_per_cluster
    shrinking = Cn * Dn < Co * Do

    def map_leaf(x, fold_ef=None, zero_new=False):
        y = _cluster_avg(x, Co, Do)  # devices agree after a round
        if fold_ef is not None:  # fold departing devices' EF into it
            y = y + _cluster_avg(fold_ef, Co, Do)
        if Cn == Co:
            z = y
        elif Cn < Co:
            assert Co % Cn == 0
            z = y.reshape(Cn, Co // Cn, *y.shape[1:]).mean(dim=1)
        else:
            assert Cn % Co == 0
            z = torch.repeat_interleave(y, Cn // Co, dim=0)
        z = z[:, None].expand((Cn, Dn) + tuple(z.shape[1:]))
        out = z.reshape(Cn * Dn, *z.shape[2:]).to(x.dtype)
        return torch.zeros_like(out) if zero_new else out

    def zipmap(fn, a, b):
        return {k: zipmap(fn, v, b[k]) if isinstance(v, dict)
                else fn(v, b[k]) for k, v in a.items()}

    new_params = zipmap(lambda p, e: map_leaf(
        p, fold_ef=e if shrinking else None), params, ef)
    if shrinking:  # the EF went into the models above
        new_ef = tree_map(lambda e: map_leaf(e, zero_new=True), ef)
    else:
        # surviving devices keep their EF: old device r stays with (a
        # child or merge of) its cluster, scaled by R'/R
        Ro, Rn = Co * Do, Cn * Dn
        assign = [[] for _ in range(Cn)]
        for r in range(Ro):
            co = r // Do
            if Cn >= Co:
                k = Cn // Co  # spread co's devices over its k children
                assign[co * k + ((r % Do) * k) // Do].append(r)
            else:
                assign[co // (Co // Cn)].append(r)
        src = np.zeros(Rn, np.int64)
        keep = np.zeros(Rn, bool)
        for cn, rows in enumerate(assign):
            assert len(rows) <= Dn, (cn, rows, Dn)  # capacity by R' >= R
            for i, r in enumerate(rows):
                src[cn * Dn + i] = r
                keep[cn * Dn + i] = True
        scale = (Cn * Dn) / (Co * Do)

        def map_ef(e):
            g = e.index_select(0, torch.as_tensor(src, device=e.device))
            g = g * torch.tensor(scale, dtype=e.dtype, device=e.device)
            m = torch.as_tensor(keep, device=e.device).view(
                (Rn,) + (1,) * (e.ndim - 1))
            return torch.where(m, g, torch.zeros_like(g)).to(e.dtype)

        new_ef = tree_map(map_ef, ef)
    new_mom = (tree_map(map_leaf, momentum)
               if momentum is not None else None)
    return new_params, new_ef, new_mom
