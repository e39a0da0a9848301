"""Counted FLOPs, dot bytes, peak memory and gossip wire bytes of one step
(the one-process counterpart of ``repro/dist/hlo_analysis.py``).

The reference parses the compiled HLO of a step lowered onto its
production mesh.  Here a step is a Python function over tensors, usually
on ``meta`` (shapes and types, nothing allocated): ``analyze_step`` runs
it under a ``TorchDispatchMode`` that sees every ATen op, the backward's
and a checkpoint's recompute included, and returns the reference's keys
where they mean something at one process:

  flops              2*M*N*K of every mm / bmm / addmm / baddbmm / mv /
                     dot, and of every convolution (its backward: one
                     forward's FLOPs per gradient it computes)
  dot_bytes          operand + result bytes of those ops
  coll_total         0: one process runs no collective.  The per-op
                     ``coll:<op>`` bytes, the per-shard bytes and
                     ``check_no_full_leaf_allgather`` need the sharded
                     program (ROADMAP.md, modules to port, item 5)
  gossip_wire_bytes  0 here; ``round_gossip_bytes`` counts the payloads
                     a gossip round ships (the dry run fills the key)

and, beside them, the step's memory: ``argument_bytes`` (the storages of
the arguments), ``output_bytes`` (new storages the step returns) and
``peak_est_bytes``, the arguments plus the high-water mark of the
storages made during the step and still alive (a storage dies when its
last tensor does, the autograd graph's saved tensors included).  On
``meta`` every op takes its plain route (``kernels/ops.py`` sends a
tensor that is not on CUDA to the plain version), so the memory is the
plain routes' (the attention's f32 block accumulators where the card
runs the flash kernels).

The gossip's bytes come from the wire's own size tables: on a gossip
round each cluster's mean crosses each nonzero band of H once
(``dist/collectives.sparse_exchange_`` rolls every plan's payload by
each band's offset), so a round ships, for every leaf, each wire plan's
payload bytes (its sender rows: ``wire_format.row_bytes``, or the dense
row in the parameters' type for a dense plan) times the number of H's
bands: the pair weighting of the reference's collective-permutes
(hlo_analysis.py:17-22).  ``check_gossip_bytes_scale_with_theta`` and
``check_cluster_gossip_bytes`` hold those bytes to the reference's
static-k contract (hlo_analysis.py:330-433).
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core import wire_format as wf
from repro_torch.dist.collectives import (_level_plans, _mixing_cached,
                                          wire_bytes_per_row)
from repro_torch.tree import flatten

aten = torch.ops.aten

_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.mv, aten.dot}
_CONVS = {aten.convolution, aten._convolution, aten.convolution_backward}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dot_flops(func, args, out) -> float:
    """2 * (output elements) * (contracted length) of a dot op."""
    if func in (aten.addmm, aten.baddbmm):
        a = args[1]
    else:
        a = args[0]
    return 2.0 * out.numel() * a.shape[-1]


def _conv_flops(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor,
                groups: int) -> float:
    """2 * (output elements) * (input channels a group) * (kernel taps)."""
    return 2.0 * y.numel() * (x.shape[1] // groups) * math.prod(w.shape[2:])


class _Counter(TorchDispatchMode):
    """Counts the dot and conv ops and keeps the live storages' bytes."""

    def __init__(self, known):
        super().__init__()
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.live = 0
        self.peak = 0
        self.known = set(known)  # storages of the arguments

    def _track(self, out):
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            self.known.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._release, key, n)

    def _release(self, key, n):
        self.live -= n
        self.known.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        base = func.overloadpacket
        if base in _DOTS:
            self.flops += _dot_flops(base, args, out)
            ops = [a for a in args if isinstance(a, torch.Tensor)]
            if base in (aten.addmm, aten.baddbmm):
                ops = ops[1:]  # the added term is not a dot operand
            self.dot_bytes += sum(_nbytes(a) for a in ops) + _nbytes(out)
        elif base in _CONVS:
            if base is aten.convolution_backward:
                dy, x, w = args[:3]
                groups, mask = args[9], args[10]
                f = _conv_flops(x, w, dy, groups)
                grads = [g for g, m in zip(out, mask) if m and g is not None]
                self.flops += f * sum(1 for m in mask[:2] if m)
                self.dot_bytes += (_nbytes(dy) + _nbytes(x) + _nbytes(w)
                                   + sum(_nbytes(g) for g in grads))
            else:
                x, w = args[0], args[1]
                groups = args[8]
                self.flops += _conv_flops(x, w, out, groups)
                self.dot_bytes += _nbytes(x) + _nbytes(w) + _nbytes(out)
        self._track(out)
        return out


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of every tensor in a nested structure."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def analyze_step(fn, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once under the counter; returns the counted keys
    (see the module docstring).  ``args`` may be nested dicts, lists and
    tuples of tensors."""
    arg_st = _storages(args)
    counter = _Counter(arg_st)
    with counter:
        result = fn(*args)
    out_st = {k: n for k, n in _storages(result).items() if k not in arg_st}
    arg_bytes = sum(arg_st.values())
    return {
        "flops": counter.flops,
        "dot_bytes": counter.dot_bytes,
        "coll_total": 0.0,
        "gossip_wire_bytes": 0.0,
        "argument_bytes": float(arg_bytes),
        "output_bytes": float(sum(out_st.values())),
        "peak_est_bytes": float(arg_bytes + counter.peak),
    }


# ---------------------------------------------------------------------------
# the gossip's wire bytes
# ---------------------------------------------------------------------------

def gossip_bands(hkind: str, clusters: int, p_edge: float = 0.4,
                 seed: int = 0) -> int:
    """The number of nonzero off-diagonal bands of H: each is one rotation
    of every payload."""
    return len(_mixing_cached(hkind, clusters, p_edge, seed)[1])


def plan_payload_bytes(key, senders: int, L: int, *, wire_dtype: str,
                       wire_block: int, dense_itemsize: int) -> int:
    """Bytes of one wire plan's payload for a leaf of L entries a row:
    ``senders`` encoded rows, or dense rows in the parameters' type."""
    if key[0] == "dense":
        return senders * L * dense_itemsize
    wb = wf.wire_block_of(L, wire_block)
    return senders * int(wf.num_blocks(L, wb)
                         * wf.block_bytes(wb, key[1], wire_dtype))


def round_gossip_bytes(leaf_numels: Sequence[int], *, clusters: int,
                       hkind: str = "ring", p_edge: float = 0.4,
                       seed: int = 0, sparse: bool = True,
                       theta: float = None, cluster_theta=None,
                       wire_dtype: str = "f32", wire_block: int = 1024,
                       dense_itemsize: int = 2) -> float:
    """The bytes one gossip round ships over the backhaul for leaves of
    ``leaf_numels`` entries a replica: each plan's payload times H's
    bands.  ``sparse=False`` is the dense gossip (every cluster's mean in
    the parameters' type); otherwise one ``theta`` for every cluster or
    ``cluster_theta``, one level a cluster, plans as
    ``sparse_exchange_`` makes them (the dense fallback included)."""
    C = clusters
    if C < 2:
        return 0.0
    bands = gossip_bands(hkind, C, p_edge, seed)
    total = 0
    for L in leaf_numels:
        L = int(L)
        if sparse:
            plans = _level_plans(L, dense_itemsize, C, k=None, theta=theta,
                                 cluster_theta=cluster_theta,
                                 wire_block=wire_block,
                                 wire_dtype=wire_dtype)
        else:
            plans = [(("dense",), None)]
        for key, src in plans:
            total += plan_payload_bytes(
                key, C if src is None else len(src), L,
                wire_dtype=wire_dtype, wire_block=wire_block,
                dense_itemsize=dense_itemsize)
    return float(total * bands)


def _expected_wire_bytes(level: float, *, wire_dtype: str, wire_block: int,
                         dense_itemsize: int) -> float:
    """Nominal bytes one wire_block-sized row ships at ``level``: the
    sparse encoding capped by the dense fallback (hlo_analysis.py:313)."""
    return min(wire_bytes_per_row(level, wire_block, wire_dtype=wire_dtype,
                                  wire_block=wire_block),
               wire_block * dense_itemsize)


def check_gossip_bytes_scale_with_theta(
        level_bytes: Sequence[float], theta_levels, *, slack: float = 2.0,
        wire_dtype: str = "f32", wire_block: int = 1024,
        dense_itemsize: int = 2) -> Dict[str, object]:
    """The static-k contract (hlo_analysis.py:330) on a round's gossip
    bytes at each level: ``level_bytes[i]`` is ``round_gossip_bytes`` with
    every cluster at the i-th smallest distinct level (the reference's
    switch branches, one a level).  ok iff every level gossips, the bytes
    are nondecreasing in the level (the dense cap saturates, it never
    dips), and the smallest level's bytes are within ``slack`` of its
    expected share of the largest's."""
    levels = sorted({float(t) for t in theta_levels})
    if len(level_bytes) != len(levels):
        raise ValueError(f"{len(level_bytes)} byte counts for "
                         f"{len(levels)} levels")
    expected = [_expected_wire_bytes(l, wire_dtype=wire_dtype,
                                     wire_block=wire_block,
                                     dense_itemsize=dense_itemsize)
                for l in levels]
    per = [float(b) for b in level_bytes]
    mono = all(a <= b for a, b in zip(per, per[1:]))
    share = max(expected[0] / expected[-1], 1e-9)
    prop = per[0] > 0 and per[0] <= slack * share * per[-1]
    return {"ok": bool(mono and prop), "n_switches": 1, "levels": levels,
            "expected_bytes_per_row": expected,
            "switches": [{"branch_permute_bytes": per, "monotone": mono,
                          "proportional": prop}]}


def check_cluster_gossip_bytes(
        got: float, base: float, cluster_levels, *,
        wire_dtype: str = "f32", wire_block: int = 1024,
        dense_itemsize: int = 2, slack: float = 2.0) -> Dict[str, object]:
    """The per-cluster static-k contract (hlo_analysis.py:387) on a
    round's gossip bytes: ``got`` at ``cluster_levels``, ``base`` with
    every cluster at their max.  ok iff ``got`` is strictly below ``base``
    and within ``slack`` (both ways) of the level vector's share
    sum(expected(level_c)) / (C * expected(max)).  The reference first
    subtracts the level-independent intra-cluster traffic from both; at
    one process the intra-cluster mean ships nothing."""
    levels = [float(t) for t in cluster_levels]
    exp = lambda l: _expected_wire_bytes(  # noqa: E731
        l, wire_dtype=wire_dtype, wire_block=wire_block,
        dense_itemsize=dense_itemsize)
    share = sum(exp(l) for l in levels) / (len(levels) * exp(max(levels)))
    ok = (got < base and base > 0 and got > 0
          and got <= slack * share * base and got >= share * base / slack)
    return {"ok": bool(ok), "cluster_levels": levels, "share": share,
            "permute_bytes": got, "baseline_permute_bytes": base,
            "byte_win": (1.0 - got / base) if base else 0.0}


def leaf_numels(params) -> List[int]:
    """Entries a replica of every leaf of a stacked (R, ...) tree."""
    return [int(v[0].numel()) for v in flatten(params).values()]
