"""HCEF aggregation on the stacked replica dim, in one process (port of the
single-process part of ``repro/dist/collectives.py``).

The round's aggregation operator on the (R, ...) replica dim is

    W = B^T diag(1/Dev) H B        (gossip rounds)
    W = B^T diag(1/Dev) B          (intra-only rounds)

with B the (C, R) cluster membership and H the (C, C) backhaul mixing
matrix (Paper Eq. 5).  ``mix_local`` applies it densely.
``sparse_neighbor_exchange`` applies the gossip to the wire-encoded
cluster means: per nonzero band o of H, each cluster's payload is rolled
to the cluster o rows on and decoded there, so the neighbour terms of the
mix are block-local top-k_b approximations while the self term stays
exact.  Wire levels may differ per cluster (``cluster_theta``): senders
with the same encode shape share one payload, the others' rows of a
rotation are zero (a zero payload, which decodes to zero), and a level
whose encoding would reach the dense row ships the dense row instead.
``wire_encode`` / ``wire_decode`` are the five wire formats
(``core/wire_format.py``); int4 and fp8 go through the wire kernels
(``ops.encode_rows``, which writes the packed offsets itself, and
``ops.unpack_offsets``).  The
gossip decodes and mixes every band and plan of a chunk in one
``ops.wire_decode_mix`` (one kernel launch on the card, every wire
format; with the wire EF a second one decodes each cluster's own
payload into its estimate), and its host tables (H's bands, the plans'
sender rows) reach the kernels as launch parameters or as tensors made
once per device: the chunk loop copies nothing from the host to the card,
so the host never waits for the card inside it.

Every step of the wire is local to one wire block and the mix is linear
in each column, so ``sparse_exchange_`` runs a leaf in column chunks of
whole wire blocks (the plans are decided on the whole row), in place: the
result is the unchunked one.

The degraded-mode masks (DESIGN.md §Degraded-mode contract):
``participation_weights`` turns a device mask into per-replica weights
that premultiply the rows, so the unchanged sum / Dev mean is the mean
over live devices; ``conn`` (a (C,) backhaul mask) applies
``mixing.participation_mixing(H, conn)``.  On the wire a partitioned
source's band terms are zeroed by folding its 0 into the per-destination
coefficients of the decode-and-mix (``MixStep.coef``: coef * (c * dec)
and (coef * c) * dec are the same bits for c in {0, 1}), and two
elementwise passes after the launch add the lost weight to each
receiver's own mean and keep a partitioned row's own mean.  Masks of all
ones given as numpy are the unmasked path; ``None`` runs it untouched.

Bounded staleness (DESIGN.md §Overlap contract): with ``stale=`` /
``stale_clusters=`` the clusters of the set ship their stale-by-1 mean
(the overlapped engine's ``pending`` buffer) while every self term stays
the fresh mean.  A chunk's payloads come from ``_chunk_payloads``, so
``stale_payloads`` can encode every chunk of an all-stale gossip ahead of
the round's local steps and ``sparse_exchange_(payloads=...)`` mix them
later, with the in-line path's bits.

Across ranks (``axes`` of a ``dist.mesh.RankMesh`` given as ``mesh=``,
the reference's shard_map path, collectives.py:205-459, :758-1163): the
(R, ...) replica dim is split contiguously over the flat index of
``axes``, R = R_local * n, clusters contiguous runs of Dev replicas.
  A. Dev % R_local == 0: a rank's rows lie in one cluster spanning g =
     Dev / R_local ranks; the intra mean is a recursive-doubling (g a
     power of two) or ring allreduce over the group, the bands rotations
     by o * g ranks;
  B. R_local % Dev == 0: a rank holds Cl = R_local / Dev whole clusters;
     the intra mean is local, band o the rotations by o // Cl and o // Cl
     + 1 ranks, stitched;
  anything else, and ``mix_local`` over more than one axis: the masked
  psum of the (C, ...) cluster sums, every rank then mixing all C rows
  (the sparse wire's math locally, without its savings).
The dense bands run in f32 (the reference's in x's type: the same for f32
rows).  On the wire every plan (the one-process plans, over all C
clusters) ships only its members' rows: a chunk's payloads go to the
ranks whose rows read them, each rank's received rows landing, band by
band and plan by plan, where the one-process kernel reads its rolled
rows, so one ``wire_decode_mix`` launch sums them in the one-process
order (bit for bit its rows).  More than one replica axis takes the
largest of ``cluster_theta`` as the reference does.  The stale gossip
runs there too: ``stale=`` rows are a rank's own, and a rank's
``stale_payloads`` are the payloads of its own rows (in the psum
fallback, of all C stale means), so each rank can encode them ahead of
its local steps; ``sparse_exchange_(payloads=)`` then ships them as the
in-line path would.  A 1-rank mesh is the one-process path.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import wire_format as wf
from repro_torch.core.mixing import make_mixing, participation_mixing
from repro_torch.kernels import ops
from repro_torch.kernels.wire_pack import (MixStep, _p4_sizes, decode_rows,
                                          pad_rows)

WIRE_DTYPES = wf.WIRE_DTYPES
MULTI_RANK = ("ROADMAP.md, modules to port, item 5 (multi-GPU mesh path: "
              "5.3, sequence-sharded MoE routing and MoE on the tensor "
              "axis; the serve policy, the dry run's mesh half, NCCL "
              "across cards)")


def _axes_tuple(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _ranks(axes, mesh) -> int:
    """The number of ranks over ``axes`` (1 without axes); axes need the
    ``RankMesh`` they name."""
    axes = _axes_tuple(axes)
    if not axes:
        return 1
    if mesh is None:
        raise ValueError(f"mesh axes {axes!r} need mesh=, the "
                         f"dist.mesh.RankMesh they name")
    return mesh.size(axes)


def participation_weights(alive, *, clusters: int, dev: int) -> np.ndarray:
    """Per-replica weights for the ``alive=`` masks (on the host).

    alive: (R,) 0/1, cluster-major.  Live device r gets dev / the live
    count of its cluster, so the unchanged sum / dev mean is the mean over
    live devices; a dead device 0; every row of a fully dead cluster 1
    (the plain mean: its rows hold the previous consensus).  All alive
    gives exact ones.  (R,) float32."""
    a = np.asarray(alive, np.float32).reshape(clusters, dev)
    cnt = a.sum(axis=1, keepdims=True)
    w = np.where(cnt > 0, a * (dev / np.maximum(cnt, 1.0)), 1.0)
    return np.ascontiguousarray(w.reshape(-1).astype(np.float32))


def _all_ones(mask) -> bool:
    return (not isinstance(mask, torch.Tensor)
            and bool(np.all(np.asarray(mask) == 1)))


def _conn_or_none(conn):
    """A host backhaul mask of all ones is None: all connected runs the
    unmasked path itself.  A tensor is taken as given."""
    return None if conn is None or _all_ones(conn) else conn


def _host(mask) -> np.ndarray:
    return (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
            else np.asarray(mask))


def _alive_premultiply(x, alive):
    """x's rows times the (R,) participation weights, in x's type, as the
    reference premultiplies them.  A host mask of all ones is x itself."""
    if _all_ones(alive):
        return x
    w = _on_device(tuple(float(a) for a in _host(alive)), x.dtype, x.device)
    return x * w.view((x.shape[0],) + (1,) * (x.ndim - 1))


def _h_bands(H: np.ndarray):
    """H -> (diag, {offset o: coef[c] = H[c, (c - o) % C]}), the nonzero
    circulant bands (ring: {1, C-1})."""
    C = H.shape[0]
    diag = np.ascontiguousarray(np.diag(H))
    bands = {}
    for o in range(1, C):
        coef = np.array([H[c, (c - o) % C] for c in range(C)])
        if np.any(np.abs(coef) > 0):
            bands[o] = coef
    return diag, bands


@functools.lru_cache(maxsize=None)
def _mixing_cached(hkind: str, C: int, p_edge: float, seed: int):
    H = make_mixing(hkind, C, p_edge, seed)
    return _h_bands(H) + (H,)


# ---------------------------------------------------------------------------
# mix_local
# ---------------------------------------------------------------------------

def mix_local(x, *, clusters: int, dev: int, axes=(), hkind: str = "ring",
              p_edge: float = 0.4, seed: int = 0, alive=None, conn=None,
              mesh=None):
    """W applied to the (R, *dims) replica array (the reference's
    ``_mix_dense_local``): per-cluster means in f32, the (C, C) H product
    unless ``hkind="none"``, every device of a cluster taking its row;
    same shape and type as x.

    ``alive``: (R,) ``participation_weights`` premultiplying the rows (the
    mean over live devices); ``conn``: (C,) backhaul mask, the product
    then by ``participation_mixing(H, conn)``.

    With ``axes`` over more than one rank of ``mesh``: x is this rank's
    (R_local, *dims) rows and ``alive`` their (R_local,) weights; layout
    A, B or the psum fallback, as the reference dispatches (:205)."""
    axes = _axes_tuple(axes)
    n = _ranks(axes, mesh)
    C, Dev = clusters, dev
    conn = _conn_or_none(conn)
    if alive is not None:
        x = _alive_premultiply(x, alive)
    if n > 1:
        R_local = x.shape[0]
        if R_local * n != C * Dev:
            raise ValueError(f"{R_local} rows a rank on {n} ranks for {C} "
                             f"clusters x {Dev} devices")
        kw = dict(mesh=mesh, axes=axes, C=C, Dev=Dev, hkind=hkind,
                  p_edge=p_edge, seed=seed, conn=conn)
        single = len(axes) == 1
        if single and R_local <= Dev and Dev % R_local == 0:
            return _mix_layout_a(x, **kw)
        if single and R_local % Dev == 0:
            return _mix_layout_b(x, **kw)
        return _mix_fallback(x, **kw)
    dims = tuple(x.shape[1:])
    means = x.float().reshape((C, Dev) + dims).mean(dim=1)
    if hkind != "none":
        _, _, H = _mixing_cached(hkind, C, p_edge, seed)
        Hm = (np.asarray(H, np.float32) if conn is None
              else participation_mixing(H, _host(conn)))
        Hd = _on_device(tuple(Hm.ravel().tolist()), torch.float32,
                        x.device).view(C, C)
        means = torch.tensordot(Hd, means, dims=([1], [0]))
    return means[:, None].expand((C, Dev) + dims).reshape(x.shape).to(
        x.dtype)


def _group_allreduce_sum(x, mesh, axes, g: int):
    """Sum over aligned groups of g consecutive ranks of the flat index
    over ``axes`` (reference :154): log2 g XOR exchanges when g is a power
    of two, else a ring of g - 1 steps.  Every rank of a group ends with
    the same bits (the adds commute)."""
    if g == 1:
        return x
    n = mesh.size(axes)
    if g & (g - 1) == 0:
        step = 1
        while step < g:
            perm = [(j, (j - j % g) + ((j % g) ^ step)) for j in range(n)]
            x = x + mesh.ppermute([x], axes, perm)[0]
            step *= 2
        return x
    acc, cur = x, x
    perm = [(j, (j - j % g) + (j % g + 1) % g) for j in range(n)]
    for _ in range(g - 1):
        cur = mesh.ppermute([cur], axes, perm)[0]
        acc = acc + cur
    return acc


def _col(v, t):
    """A host vector as an f32 column broadcasting against t's rows."""
    return torch.as_tensor(np.asarray(v, np.float32), device=t.device).view(
        (-1,) + (1,) * (t.ndim - 1))


def _weighted_bands(mean, rotate_fn, cl, C, hkind, p_edge, seed, conn=None):
    """diag * mean plus one rotation a nonzero band of H (reference :326),
    in f32: mean (m, *dims) this rank's cluster means, cl (m,) their
    clusters, rotate_fn(mean, o) the band-o rotated means.  ``conn`` (a
    host mask, replicated): band o's source link at receiver c is conn[(c
    - o) % C]; a partitioned source's terms are zeroed, their weight added
    to the receiver's own mean, a partitioned receiver keeps its mean."""
    diag, bands, _ = _mixing_cached(hkind, C, p_edge, seed)
    cl = np.asarray(cl, np.int64)
    f32 = lambda v: np.asarray(v, np.float32)[cl]
    y = _col(f32(diag), mean) * mean
    cw = None if conn is None else np.asarray(_host(conn), np.float32)
    absorbed = None
    for o, coef in sorted(bands.items()):
        rot = rotate_fn(mean, o)
        if cw is None:
            y = y + _col(f32(coef), mean) * rot
        else:
            c_o = cw[(cl - o) % C]
            y = y + _col(f32(coef), mean) * (_col(c_o, mean) * rot)
            a_o = f32(coef) * (np.float32(1.0) - c_o)
            absorbed = a_o if absorbed is None else absorbed + a_o
    if cw is not None and absorbed is not None:
        if np.any(absorbed > 0):
            y = torch.where(_col(absorbed > 0, mean) > 0,
                            y + _col(absorbed, mean) * mean, y)
        y = torch.where(_col(cw[cl] > 0, mean) > 0, y, mean)
    return y


def _complete_mix(means, total, divisor, cl, C, conn):
    """H = 11^T / C: ``total`` the psum of the cluster means (conn-weighted
    under a mask), counted ``divisor`` / C times each, the mix total /
    divisor; under ``conn`` the partitioned columns' lost 1/C into each
    receiver's own mean, a partitioned receiver keeping its own (reference
    :373-385, :401-413)."""
    y = (total / divisor).expand_as(means)
    if conn is None:
        return y
    cw = np.asarray(_host(conn), np.float32)
    dead = np.float32(C) - cw.sum(dtype=np.float32)
    if dead > 0:
        y = y + means * float(np.float32(dead) / np.float32(C))
    my_c = cw[np.asarray(cl, np.int64)]
    return torch.where(_col(my_c > 0, means) > 0, y, means)


def _mix_layout_a(x, *, mesh, axes, C, Dev, hkind, p_edge, seed, conn):
    """One cluster a rank, spanning g = Dev / R_local ranks (:363)."""
    R_local = x.shape[0]
    g = Dev // R_local
    dims = tuple(x.shape[1:])
    s = _group_allreduce_sum(x.float().sum(dim=0), mesh, axes, g)
    mean = (s / Dev)[None]  # (1, *dims), the same on the group's ranks
    if hkind != "none":
        cl = np.array([mesh.flat_index(axes) // g])
        if hkind == "complete":
            # psum counts each cluster on each of its g ranks
            w = mean if conn is None else mean * float(
                np.asarray(_host(conn), np.float32)[cl[0]])
            mean = _complete_mix(mean, mesh.psum(w, axes), g * C, cl, C,
                                 conn)
        else:
            rot = lambda m, o: mesh.rotate([m], axes, o * g)[0]
            mean = _weighted_bands(mean, rot, cl, C, hkind, p_edge, seed,
                                   conn)
    return mean.expand((R_local,) + dims).to(x.dtype)


def _mix_layout_b(x, *, mesh, axes, C, Dev, hkind, p_edge, seed, conn):
    """Cl = R_local / Dev whole clusters a rank (:393)."""
    R_local = x.shape[0]
    Cl = R_local // Dev
    dims = tuple(x.shape[1:])
    means = x.float().reshape((Cl, Dev) + dims).mean(dim=1)
    cl = mesh.flat_index(axes) * Cl + np.arange(Cl)
    if hkind == "complete":
        w = means if conn is None else means * _col(
            np.asarray(_host(conn), np.float32)[cl], means)
        means = _complete_mix(means, mesh.psum(w.sum(dim=0), axes)[None],
                              C, cl, C, conn)
    elif hkind != "none":
        def rot(m, o):
            # band o in cluster space: the rotations by q and q + 1 ranks,
            # the rm rows that wrap a rank boundary from the second
            q, rm = divmod(o, Cl)
            r_q = mesh.rotate([m], axes, q)[0]
            if rm == 0:
                return r_q
            r_q1 = mesh.rotate([m], axes, q + 1)[0]
            return torch.cat([r_q1[Cl - rm:], r_q[:Cl - rm]], dim=0)

        means = _weighted_bands(means, rot, cl, C, hkind, p_edge, seed, conn)
    return means[:, None].expand((Cl, Dev) + dims).reshape(x.shape).to(
        x.dtype)


def _cluster_sums(rows, mesh, axes, C, Dev):
    """The (C, L) f32 sums of every cluster's rows over the ranks of
    ``axes`` (this rank's rows (R_local, L)) and the local rows'
    clusters."""
    R_local = rows.shape[0]
    cl = (mesh.flat_index(axes) * R_local + np.arange(R_local)) // Dev
    part = torch.zeros((C,) + tuple(rows.shape[1:]), dtype=torch.float32,
                       device=rows.device)
    part.index_add_(0, torch.as_tensor(cl, device=rows.device),
                    rows.float())
    return mesh.psum(part, axes), cl


def _mix_fallback(x, *, mesh, axes, C, Dev, hkind, p_edge, seed, conn):
    """The masked cluster-sum psum (:442): O(C d) memory, one all_reduce
    of the (C, *dims) cluster sums, the H product on every rank."""
    sums, cl = _cluster_sums(x, mesh, axes, C, Dev)
    means = sums / Dev
    if hkind != "none":
        _, _, H = _mixing_cached(hkind, C, p_edge, seed)
        Hm = (np.asarray(H, np.float32) if conn is None
              else participation_mixing(H, _host(conn)))
        Hd = _on_device(tuple(Hm.ravel().tolist()), torch.float32,
                        x.device).view(C, C)
        means = torch.tensordot(Hd, means, dims=([1], [0]))
    return means[torch.as_tensor(cl, device=x.device)].to(x.dtype)


# ---------------------------------------------------------------------------
# the wire formats
# ---------------------------------------------------------------------------

class Wire(NamedTuple):
    """Block-local top-k_b rows: ``vals`` (m, nb, k_b) f32 / bf16 / int8,
    or uint8 for fp8 bits and int4 nibbles ((m, nb, ceil(k_b/2)));
    ``off`` the block-local offsets, (m, nb, k_b) int32 (f32, bf16) or
    int16 (int8), or packed uint8 (int4, fp8: ascending, u8 or p4 per
    ``wire_format.offset_mode``); ``scale`` (m, nb) f32 or None (f32,
    bf16).  The v2 payloads do not carry k_b in their shapes."""
    vals: torch.Tensor
    off: torch.Tensor
    scale: Optional[torch.Tensor]


def wire_k(theta: float, L: int, wire_block: int = 1024) -> int:
    """Static per-wire-block k for a compression level theta (k_b)."""
    return wf.wire_k(theta, L, wire_block)


def wire_bytes_per_row(theta: float, L: int, *, wire_dtype: str = "f32",
                       wire_block: int = 1024) -> int:
    """Exact bytes one encoded row occupies on the wire."""
    return wf.row_bytes(theta, L, wire_dtype=wire_dtype,
                        wire_block=wire_block)


def wire_ships_dense(theta: float, L: int, *, wire_dtype: str = "f32",
                     wire_block: int = 1024, dense_itemsize: int = 2) -> bool:
    """True when the level takes the dense-wire fallback: its encoding
    would occupy at least the dense row at ``dense_itemsize`` bytes an
    entry, so the row ships uncompressed in the delta's type."""
    return _wire_plan_key(theta, L, wire_block, wire_dtype,
                          int(dense_itemsize)) == ("dense",)


def _wire_plan_key_from_kb(k_b: int, L: int, wire_block: int,
                           wire_dtype: str, dense_itemsize: int):
    """("dense",) when the encoding would reach the dense row, else
    ("wire", k_b)."""
    if wf.encoding_reaches_dense(k_b, L, wire_block, wire_dtype,
                                 dense_itemsize):
        return ("dense",)
    return ("wire", k_b)


def _wire_plan_key(level: float, L: int, wire_block: int, wire_dtype: str,
                   dense_itemsize: int):
    return _wire_plan_key_from_kb(wire_k(level, L, wire_block), L,
                                  wire_block, wire_dtype, dense_itemsize)


def _wire_plans(sender_levels, L: int, wire_block: int, wire_dtype: str,
                dense_itemsize: int):
    """Senders grouped by their encode key -> [(key, src)], keys sorted;
    ``src`` is the frozenset of sender rows, or None when one key covers
    every sender (the uniform case: a full rotation)."""
    groups: dict = {}
    for s, lvl in enumerate(sender_levels):
        key = _wire_plan_key(float(lvl), L, wire_block, wire_dtype,
                             dense_itemsize)
        groups.setdefault(key, []).append(s)
    return [(key, None if len(groups[key]) == len(sender_levels)
             else frozenset(groups[key])) for key in sorted(groups)]


@functools.lru_cache(maxsize=64)
def _on_device(values: tuple, dtype: torch.dtype, device: torch.device):
    """A small host table as a tensor on ``device``, made once: a copy
    from the host to the card waits for the card, so none runs per
    chunk.  That wait also makes a table first built under a side stream
    whole before any other stream reads it."""
    return torch.as_tensor(values, dtype=dtype, device=device)


def _encode(x, rows, k_b: int, wb: int, wire_dtype: str, impl=None) -> Wire:
    """Rows ``rows`` (None: all) of x (C, L) -> Wire at wire block ``wb``;
    the rows are zero-padded to a multiple of it.  The v2 formats go
    through ``ops.encode_rows`` (on the card one kernel reads the rows in
    place and writes the packed offsets); the v1 formats select with a
    stable descending sort, which breaks ties toward the lower index as
    ``lax.top_k`` does."""
    if wire_dtype == "int8" and wb > 32768:
        raise ValueError(  # int16 offsets wrap past 2^15 - 1
            f"int8 wire needs wire_block <= 32768, got {wb}")
    k_b = max(1, min(int(k_b), wb))
    x = x.float()
    if wire_dtype in ("int4", "fp8"):
        return Wire(*ops.encode_rows(
            x, rows, k_b, wb=wb, wire_dtype=wire_dtype,
            omode=wf.offset_mode(wb, k_b, wire_dtype), impl=impl))
    if rows is not None:
        x = x.index_select(0, _on_device(tuple(rows), torch.long, x.device))
    xb = pad_rows(x, None, wb)
    off = torch.sort(xb.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k_b]
    vals = torch.gather(xb, -1, off)
    if wire_dtype == "f32":
        return Wire(vals, off.to(torch.int32), None)
    if wire_dtype == "bf16":
        return Wire(vals.to(torch.bfloat16), off.to(torch.int32), None)
    scale = vals.abs().amax(dim=-1)
    q = torch.round(vals / torch.clamp_min(scale, 1e-30)[..., None] * 127.0)
    return Wire(q.to(torch.int8), off.to(torch.int16), scale)


def _decode(payload, L: int, wb: int, wire_dtype, k_b, impl=None):
    """A Wire (or a dense plan's ``(rows,)``) -> dense (m, L) f32; the
    p4 offsets through ``ops.unpack_offsets``."""
    return decode_rows(tuple(payload), L, wb, wire_dtype, k_b,
                       unpack=functools.partial(ops.unpack_offsets,
                                                impl=impl))


def wire_encode(rows, k_b: int, *, wire_block: int = 1024,
                wire_dtype: str = "f32", impl=None) -> Wire:
    """rows: (m, L) -> block-local top-k_b Wire: each wire_block slab keeps
    its k_b largest-|.| entries.  ``impl`` routes the int4/fp8 encode
    (``ops.encode_blocks``: None = the kernel on the card, the bisection
    on the CPU; "ref" = the exact top-k, the reference's CPU route)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    return _encode(rows, None, k_b,
                   wf.wire_block_of(rows.shape[1], wire_block), wire_dtype,
                   impl)


def wire_decode(wire: Wire, L: int, *, wire_block: int = 1024,
                wire_dtype: Optional[str] = None, k_b: Optional[int] = None,
                impl=None):
    """Wire -> dense (m, L) f32; exact for f32 wires.  The v1 formats are
    self-describing; int4/fp8 take ``wire_dtype`` and ``k_b``."""
    if wire_dtype in ("int4", "fp8") and k_b is None:
        raise ValueError(f"{wire_dtype} wire_decode needs k_b= (packed "
                         f"payloads do not carry it in their shapes)")
    return _decode(wire, L, wf.wire_block_of(L, wire_block), wire_dtype,
                   k_b, impl)


# ---------------------------------------------------------------------------
# sparse neighbor exchange
# ---------------------------------------------------------------------------

class _Layout(NamedTuple):
    """A gossip's host-side tables: ``diag`` (C,) and ``bands`` ((o,
    coef), ...) of H, and per wire plan (key, its sender rows ascending or
    None for all, senders: the payload row of each cluster or -1)."""
    diag: np.ndarray
    bands: tuple
    plans: tuple


def _gossip_layout(hkind: str, C: int, p_edge: float, seed: int,
                   plans: tuple) -> _Layout:
    diag, bands, _ = _mixing_cached(hkind, C, p_edge, seed)
    out = []
    for key, src in plans:
        rows = None if src is None else tuple(sorted(src))
        senders = tuple(range(C)) if rows is None else tuple(
            rows.index(c) if c in src else -1 for c in range(C))
        out.append((key, rows, senders))
    return _Layout(diag, tuple(sorted(bands.items())), tuple(out))


def _conn_fold(layout: _Layout, conn):
    """The backhaul mask on the gossip's host tables: each band's
    coefficients times its source's link, ``conn[(c - o) % C]`` at
    destination c (the reference's c_o; exact in f32), and the (C,) f32
    weight each receiver lost, summed over the bands in order.  Returns
    (bands, absorbed)."""
    cw = np.asarray(conn, np.float32)
    C = cw.shape[0]
    bands, absorbed = [], np.zeros(C, np.float32)
    for o, coef in layout.bands:
        c_o = cw[(np.arange(C) - o) % C]
        coef32 = np.asarray(coef, np.float32)
        bands.append((o, tuple((coef32 * c_o).tolist())))
        absorbed = absorbed + coef32 * (np.float32(1.0) - c_o)
    return tuple(bands), absorbed


def _check_stale_set(stale_clusters, C: int) -> tuple:
    """The stale set as a sorted tuple: a non-empty subset of range(C)."""
    out = tuple(sorted({int(c) for c in stale_clusters}))
    if not out or not all(0 <= c < C for c in out):
        raise ValueError(f"stale_clusters {out} not a non-empty subset of "
                         f"range({C})")
    return out


def _stale_row_select(fresh, stale_means, stale_clusters):
    """The rows a chunk ships (reference :741): the stale clusters' stale
    means, the others' fresh ones.  With every cluster stale the stale
    rows themselves, which do not depend on this round's local steps."""
    C = fresh.shape[0]
    if len(stale_clusters) == C:
        return stale_means
    mask = _on_device(tuple(c in stale_clusters for c in range(C)),
                      torch.bool, fresh.device)
    return torch.where(mask[:, None], stale_means, fresh)


def _chunk_payloads(send, layout: _Layout, *, wb, wire_dtype, dense_dtype,
                    impl=None):
    """Each wire plan's payload of a chunk's (C, L) f32 rows ``send``: the
    encoded sender rows, or for a dense plan the rows in ``dense_dtype``.
    [(payload, k_b or None for a dense plan)], in the plans' order."""
    payloads = []
    for key, rows, _ in layout.plans:
        if key[0] == "dense":
            sub = send if rows is None else send.index_select(
                0, _on_device(rows, torch.long, send.device))
            payloads.append(((sub.to(dense_dtype).contiguous(),), None))
        else:
            payloads.append((tuple(_encode(send, rows, key[1], wb,
                                           wire_dtype, impl)), key[1]))
    return payloads


def _sparse_mix_rows(means, layout: _Layout, *, wb, wire_dtype, dense_dtype,
                     wire_ef=None, wire_ef_gamma=1.0, impl=None, conn=None,
                     stale=None, stale_clusters=None, payloads=None):
    """The gossip on (C, L) f32 cluster means: encode each plan's sender
    rows, then y = diag * means plus, band by band and plan by plan in the
    reference's order, coef * the decoded payload of each row's source
    cluster (``ops.wire_decode_mix``: one launch on the card).

    ``stale`` (C, L) f32 with ``stale_clusters``: the set's rows ship
    their stale mean (``_stale_row_select``); diag * means, the absorbed
    weight and a partitioned row's own mean stay fresh (reference :1168).
    ``payloads``: the chunk's ``_chunk_payloads``, encoded beforehand,
    in place of the encode.

    ``wire_ef = (est_self, est_wsum)``, (C, L) f32: the CHOCO wire error
    feedback.  The payload is ``means - est_self``; each row decodes its
    own payload as its neighbours do, and
        est_self+ = est_self + dec_self
        est_wsum+ = est_wsum + diag * dec_self + sum_o coef_o * dec_o
        y         = means + gamma * (est_wsum+ - est_self+)
    with dec_self each row's own payload decoded, as a sum from +0.  Each
    estimate is one ``wire_decode_mix`` call (one launch on the card):
    a step at band offset 0 a plan, coefficient 1 (est_self) or diag
    (est_wsum, then the bands' steps).  A row outside a plan adds coef *
    +0 there, which turns a -0 into +0 as the sum from +0 did; with one
    plan a zero payload's step does it.  Bit for bit the sums in that
    order, but where est_wsum holds -0 and diag times a nonzero decoded
    value rounds to -0 (a value below 2^-149 / diag): +0 here, -0 there.
    Returns y, or (y, est_self+, est_wsum+).

    ``conn``: (C,) host backhaul mask (not with ``wire_ef``).  A
    partitioned source's terms are zeroed through the coefficients
    (``_conn_fold``; the launch is unchanged), then in plain torch the
    reference's y + absorbed * means where a receiver lost weight (a
    product and a sum, not one fused step: the reference's rounding), and
    a partitioned receiver's row is its own mean."""
    dev = means.device
    bands, absorbed = layout.bands, None
    if conn is not None:
        if wire_ef is not None:
            raise ValueError("wire_ef is incompatible with conn= "
                             "partitions (sender and receiver estimate "
                             "updates would desync)")
        bands, absorbed = _conn_fold(layout, _host(conn))
    if payloads is None:
        send = means if wire_ef is None else means - wire_ef[0]
        if stale is not None:
            send = _stale_row_select(send, stale, stale_clusters)
        payloads = _chunk_payloads(send, layout, wb=wb,
                                   wire_dtype=wire_dtype,
                                   dense_dtype=dense_dtype, impl=impl)
        del send  # the chunk's scratch: core/round.py:gossip_cols
    steps = [MixStep(o, tuple(coef), payload, k_b, senders)
             for o, coef in bands
             for (payload, k_b), (_, _, senders) in zip(payloads,
                                                        layout.plans)]
    mix = functools.partial(ops.wire_decode_mix, wb=wb,
                            wire_dtype=wire_dtype, impl=impl)
    if wire_ef is None:
        y = mix(means, steps, diag=layout.diag)
        if absorbed is None:
            return y
        col = lambda v, dt: _on_device(tuple(v), dt, dev)[:, None]
        if np.any(absorbed > 0):
            ab = col(absorbed.tolist(), torch.float32)
            y = torch.where(col((absorbed > 0).tolist(), torch.bool),
                            y + ab * means, y)
        cw = _host(conn)
        if not np.all(cw > 0):
            y = torch.where(col((cw > 0).tolist(), torch.bool), y, means)
        return y
    C = means.shape[0]

    def own(coef):
        out = [MixStep(0, coef, payload, k_b, senders)
               for (payload, k_b), (_, _, senders) in zip(payloads,
                                                          layout.plans)]
        if len(out) == 1:
            out.append(out[0]._replace(senders=(-1,) * C))
        return out

    est_self = mix(wire_ef[0], own((1.0,) * C))
    est_wsum = mix(wire_ef[1], own(tuple(layout.diag.tolist())) + steps)
    # means + gamma * (est_wsum - est_self), the same bits in one row
    y = torch.sub(est_wsum, est_self)
    return y.mul_(wire_ef_gamma).add_(means), est_self, est_wsum


# ---------------------------------------------------------------------------
# the wire across ranks
# ---------------------------------------------------------------------------

class _RankRows(NamedTuple):
    """Where the cluster rows lie across ``n`` ranks: layout A ("A", a
    rank's one row of cluster f // g, g ranks a cluster) or B ("B", m =
    Cl whole clusters a rank)."""
    kind: str
    n: int
    m: int
    g: int

    def clusters(self, f: int) -> tuple:
        if self.kind == "A":
            return (f // self.g,)
        return tuple(range(f * self.m, (f + 1) * self.m))

    def source(self, f: int, i: int, o: int, C: int):
        """(rank, row) of the band-o source of rank f's row i: in A the
        rank at f's place in its source cluster's group (the rotation by o
        * g), in B the rank holding that cluster."""
        s = (self.clusters(f)[i] - o) % C
        if self.kind == "A":
            return s * self.g + f % self.g, 0
        return s // self.m, s % self.m


def _rank_rows(R_local: int, n: int, axes, mesh, Dev: int):
    """The reference's sparse dispatch (:972-1101): layout A where a
    cluster's group of g ranks lies in one run of the last axis (or one
    axis), B where a rank holds whole clusters, else None (the psum
    fallback)."""
    if R_local <= Dev and Dev % R_local == 0:
        g = Dev // R_local
        if len(axes) == 1 or g == 1 or mesh.axis_size(axes[-1]) % g == 0:
            return _RankRows("A", n, 1, g)
        return None
    if R_local % Dev == 0:
        return _RankRows("B", n, R_local // Dev, 1)
    return None


class _RankTables(NamedTuple):
    """A rank's host tables of the wire across ranks.  ``members`` per
    plan: this rank's rows that send under it (its payload's rows);
    ``steps`` per (band, plan), in the one-process order: (band index,
    plan, pieces, senders), the pieces ((source rank, that rank's payload
    rows), ...) concatenated into the step's payload and ``senders`` each
    local row's row of it or -1; ``sends`` ((destination rank, ((step,
    plan, payload rows), ...)), ...) what this rank ships; ``own`` per
    plan each local row's row of this rank's payload or -1."""
    members: tuple
    steps: tuple
    sends: tuple
    own: tuple


@functools.lru_cache(maxsize=256)
def _rank_tables(rr: _RankRows, me: int, C: int, offsets: tuple,
                 plan_rows: tuple):
    """``offsets``: H's band offsets in order; ``plan_rows`` each plan's
    sender clusters (None: all)."""
    src_sets = [None if rows is None else set(rows) for rows in plan_rows]

    def member(f, p):
        return tuple(i for i, c in enumerate(rr.clusters(f))
                     if src_sets[p] is None or c in src_sets[p])

    def need(f, o, p):  # rank f's rows whose band-o source sends under p
        out = []
        for i in range(rr.m):
            sf, si = rr.source(f, i, o, C)
            mem = member(sf, p)
            if si in mem:
                out.append((i, sf, mem.index(si)))
        return out

    steps, sends = [], {}
    for bi, o in enumerate(offsets):
        for p in range(len(plan_rows)):
            k = len(steps)
            mine = need(me, o, p)
            pieces, senders, at = [], [-1] * rr.m, 0
            for sf in sorted({sf for _, sf, _ in mine}):
                rows = [(i, pos) for i, s2, pos in mine if s2 == sf]
                pieces.append((sf, tuple(pos for _, pos in rows)))
                for i, _ in rows:
                    senders[i] = at
                    at += 1
            steps.append((bi, p, tuple(pieces), tuple(senders)))
            for f in range(rr.n):
                pos = tuple(pos for _, sf, pos in need(f, o, p) if sf == me)
                if f != me and pos:
                    sends.setdefault(f, []).append((k, p, pos))
    members = tuple(member(me, p) for p in range(len(plan_rows)))
    own = tuple(tuple(mem.index(i) if i in mem else -1 for i in range(rr.m))
                for mem in members)
    return _RankTables(members, tuple(steps),
                       tuple((f, tuple(v)) for f, v in sorted(sends.items())),
                       own)


def _payload_specs(key, n: int, Lc: int, wb: int, wire_dtype: str,
                   dense_dtype):
    """The (shape, dtype) of each field of an ``n``-row payload of a chunk
    of Lc columns under plan key ``key`` (None where a format has no
    scale), as ``_chunk_payloads`` makes it."""
    if key[0] == "dense":
        return [((n, Lc), dense_dtype)]
    k_b = max(1, min(int(key[1]), wb))
    nb = -(-Lc // wb)
    scale = ((n, nb), torch.float32)
    if wire_dtype in ("int4", "fp8"):
        k_out = -(-k_b // 2) if wire_dtype == "int4" else k_b
        n_off = (k_b if wf.offset_mode(wb, k_b, wire_dtype) == "u8"
                 else sum(_p4_sizes(wb, k_b)))
        return [((n, nb, k_out), torch.uint8), ((n, nb, n_off), torch.uint8),
                scale]
    vals = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[wire_dtype]
    off = torch.int16 if wire_dtype == "int8" else torch.int32
    return [((n, nb, k_b), vals), ((n, nb, k_b), off),
            scale if wire_dtype == "int8" else None]


def _rows_of(payload, pos, dev):
    """Rows ``pos`` of a payload's fields (the payload itself where pos is
    all of its rows in order)."""
    if tuple(pos) == tuple(range(payload[0].shape[0])):
        return payload
    idx = _on_device(tuple(pos), torch.long, dev)
    return tuple(None if t is None else t.index_select(0, idx)
                 for t in payload)


def _stale_rank_select(send, stale, cl, stale_clusters):
    """This rank's rows to ship (m, Lc) of the clusters ``cl``: the stale
    set's stale means, the others' ``send`` rows (``_stale_row_select`` on
    a rank's rows).  Every local cluster stale: the stale rows
    themselves."""
    sel = tuple(c in stale_clusters for c in cl)
    if all(sel):
        return stale
    mask = _on_device(sel, torch.bool, send.device)
    return torch.where(mask[:, None], stale, send)


def _rank_payloads(send, rr: _RankRows, layout: _Layout, tables, *, wb,
                   wire_dtype, dense_dtype, impl=None):
    """Each plan's payload of this rank's (m, Lc) rows ``send``: its
    member rows encoded (a dense plan's in ``dense_dtype``), None where no
    local row sends under the plan."""
    payloads = []
    for (key, _, _), mem in zip(layout.plans, tables.members):
        if not mem:
            payloads.append(None)
            continue
        rows = None if len(mem) == rr.m else mem
        if key[0] == "dense":
            sub = send if rows is None else send.index_select(
                0, _on_device(rows, torch.long, send.device))
            payloads.append((sub.to(dense_dtype).contiguous(),))
        else:
            payloads.append(tuple(_encode(send, rows, key[1], wb, wire_dtype,
                                          impl)))
    return payloads


def _rank_tables_of(rr: _RankRows, layout: _Layout, mesh, axes):
    return _rank_tables(rr, mesh.flat_index(axes), len(layout.diag),
                        tuple(o for o, _ in layout.bands),
                        tuple(rows for _, rows, _ in layout.plans))


def _rank_mix_rows(means, rr: _RankRows, layout: _Layout, mesh, axes, *, wb,
                   wire_dtype, dense_dtype, wire_ef=None, wire_ef_gamma=1.0,
                   impl=None, conn=None, stale=None, stale_clusters=None,
                   payloads=None):
    """``_sparse_mix_rows`` on this rank's (m, Lc) f32 cluster means: each
    plan's member rows encoded, one ``exchange`` of what each rank reads,
    then the one-process steps on the received rows (one
    ``wire_decode_mix``; with the wire EF two more for the estimates).
    ``stale`` (m, Lc) f32 with ``stale_clusters``: the set's local rows
    ship their stale mean, the self terms stay fresh; ``payloads``: this
    rank's ``_rank_payloads`` of the chunk, encoded beforehand."""
    dev, Lc = means.device, means.shape[1]
    me = mesh.flat_index(axes)
    tables = _rank_tables_of(rr, layout, mesh, axes)
    cl = rr.clusters(me)
    bands, absorbed = layout.bands, None
    if conn is not None:
        if wire_ef is not None:
            raise ValueError("wire_ef is incompatible with conn= "
                             "partitions (sender and receiver estimate "
                             "updates would desync)")
        bands, absorbed = _conn_fold(layout, _host(conn))
    if payloads is None:
        send = means if wire_ef is None else means - wire_ef[0]
        if stale is not None:
            send = _stale_rank_select(send, stale, cl, stale_clusters)
        payloads = _rank_payloads(send, rr, layout, tables, wb=wb,
                                  wire_dtype=wire_dtype,
                                  dense_dtype=dense_dtype, impl=impl)
        del send
    specs = lambda p, n: _payload_specs(layout.plans[p][0], n, Lc, wb,
                                        wire_dtype, dense_dtype)
    sends = {mesh.rank_of(axes, f): [t for _, p, pos in lst
                                     for t in _rows_of(payloads[p], pos, dev)
                                     if t is not None]
             for f, lst in tables.sends}
    recvs = {}
    for _, p, pieces, _ in tables.steps:
        for sf, pos in pieces:
            if sf != me:
                recvs.setdefault(mesh.rank_of(axes, sf), []).extend(
                    sp for sp in specs(p, len(pos)) if sp is not None)
    got = {r: iter(v) for r, v in mesh.exchange(sends, recvs).items()}
    # a one-row zero payload where no row reads a plan: the kernel takes
    # no null payload
    unread = lambda p: tuple(None if sp is None else torch.zeros(
        sp[0], dtype=sp[1], device=dev) for sp in specs(p, 1))
    steps = []
    for bi, p, pieces, senders in tables.steps:
        parts = []
        for sf, pos in pieces:
            if sf == me:
                parts.append(_rows_of(payloads[p], pos, dev))
            else:
                it = got[mesh.rank_of(axes, sf)]
                parts.append(tuple(None if sp is None else next(it)
                                   for sp in specs(p, len(pos))))
        if len(parts) == 1:
            buf = parts[0]
        elif parts:
            buf = tuple(None if f[0] is None else torch.cat(f, dim=0)
                        for f in zip(*parts))
        else:  # no row of this rank reads the plan (every sender -1)
            buf = unread(p)
        key = layout.plans[p][0]
        coef = bands[bi][1]
        steps.append(MixStep(0, tuple(coef[c] for c in cl), buf,
                             None if key[0] == "dense" else key[1], senders))
    diag = np.asarray(layout.diag)[list(cl)]
    mix = functools.partial(ops.wire_decode_mix, wb=wb,
                            wire_dtype=wire_dtype, impl=impl)
    if wire_ef is None:
        y = mix(means, steps, diag=diag)
        if absorbed is None:
            return y
        ab = absorbed[list(cl)]
        if np.any(ab > 0):
            y = torch.where(_col(ab > 0, y) > 0, y + _col(ab, y) * means, y)
        cw = np.asarray(_host(conn), np.float32)[list(cl)]
        if not np.all(cw > 0):
            y = torch.where(_col(cw > 0, y) > 0, y, means)
        return y

    def own(coef):
        out = []
        for p, senders in enumerate(tables.own):
            key = layout.plans[p][0]
            pay = payloads[p] if payloads[p] is not None else unread(p)
            out.append(MixStep(0, coef, pay, None if key[0] == "dense"
                               else key[1], senders))
        if len(out) == 1:
            out.append(out[0]._replace(senders=(-1,) * rr.m))
        return out

    est_self = mix(wire_ef[0], own((1.0,) * rr.m))
    est_wsum = mix(wire_ef[1], own(tuple(diag.tolist())) + steps)
    y = torch.sub(est_wsum, est_self)
    return y.mul_(wire_ef_gamma).add_(means), est_self, est_wsum


def _level_plans(L: int, dense_itemsize: int, C: int, *, k, theta,
                 cluster_theta, wire_block, wire_dtype):
    """Check the static level arguments (exactly one of k / theta /
    cluster_theta) and return the wire plans for a row of L entries."""
    if (k is None) + (theta is None) + (cluster_theta is None) != 2:
        raise ValueError("pass exactly one of k= / theta= / cluster_theta=")
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    plan_kw = dict(L=L, wire_block=wire_block, wire_dtype=wire_dtype,
                   dense_itemsize=dense_itemsize)
    if cluster_theta is not None:
        cluster_theta = tuple(float(t) for t in cluster_theta)
        if len(cluster_theta) != C:
            raise ValueError(f"cluster_theta has {len(cluster_theta)} "
                             f"entries for {C} clusters")
        return _wire_plans(cluster_theta, **plan_kw)
    if theta is not None:
        return _wire_plans((theta,), **plan_kw)
    wb = wf.wire_block_of(L, wire_block)
    k_b = max(1, min(wb, int(np.ceil(int(k) * wb / L))))
    return [(_wire_plan_key_from_kb(k_b, **plan_kw), None)]


def _col_chunks(L: int, wb: int, chunk_cols):
    """[c0, c1) column ranges of whole wire blocks (the last one ragged)."""
    if chunk_cols is None:
        return [(0, L)]
    step = max(wb, int(chunk_cols) // wb * wb)
    return [(c, min(c + step, L)) for c in range(0, L, step)]


def _exchange_layout(L: int, dense_dtype, C: int, *, k, theta,
                     cluster_theta, hkind, p_edge, seed, wire_block,
                     wire_dtype):
    """(layout, wb) of a gossip over rows of L entries."""
    plans = _level_plans(L, torch.empty((), dtype=dense_dtype)
                         .element_size(), C, k=k, theta=theta,
                         cluster_theta=cluster_theta, wire_block=wire_block,
                         wire_dtype=wire_dtype)
    return (_gossip_layout(hkind, C, p_edge, seed, tuple(plans)),
            wf.wire_block_of(L, wire_block))


def _rank_levels(axes, theta, cluster_theta):
    """The level arguments across ranks: more than one replica axis takes
    the largest of ``cluster_theta``, as the reference's relayed
    multi-axis rotations ship every cluster at it (:1039)."""
    if cluster_theta is not None and len(axes) > 1:
        return max(float(t) for t in cluster_theta), None
    return theta, cluster_theta


def stale_payloads(stale, *, clusters: int, dev: int, k=None, theta=None,
                   cluster_theta=None, hkind: str = "ring",
                   p_edge: float = 0.4, seed: int = 0,
                   wire_dtype: str = "f32", wire_block: int = 1024,
                   dense_dtype=None, impl=None,
                   chunk_cols: Optional[int] = None, mesh=None,
                   axes=()) -> list:
    """Every column chunk's payloads of a gossip in which every cluster is
    stale: ``_chunk_payloads`` of each cluster's row 0 of ``stale`` (R, L)
    (cluster-uniform rows, the overlapped engine's ``pending``), chunked
    and planned as ``sparse_exchange_`` does with the same arguments.
    Nothing here reads this round's means, so the encodes can run
    before (or beside) the local steps; ``sparse_exchange_(payloads=)``
    then gives the bits of ``stale=`` with ``stale_clusters`` = all.

    With ``axes`` over more than one rank of ``mesh``, ``stale`` is this
    rank's (R_local, L) rows and each chunk's entry this rank's own
    payloads: in layouts A and B each plan's member rows of this rank
    (``_rank_payloads``, None where none sends), with nothing sent; in the
    psum fallback the one-process payloads of all C stale means, which
    take one all_reduce of the chunk's cluster sums."""
    C, Dev = clusters, dev
    R, L = stale.shape
    axes = _axes_tuple(axes)
    n = _ranks(axes, mesh)
    if R * n != C * Dev:
        raise ValueError(f"{R} rows{f' a rank on {n} ranks' if n > 1 else ''}"
                         f" for {C} clusters x {Dev} devices")
    dense_dtype = dense_dtype or stale.dtype
    if n > 1:
        theta, cluster_theta = _rank_levels(axes, theta, cluster_theta)
    layout, wb = _exchange_layout(
        L, dense_dtype, C, k=k, theta=theta, cluster_theta=cluster_theta,
        hkind=hkind, p_edge=p_edge, seed=seed, wire_block=wire_block,
        wire_dtype=wire_dtype)
    chunks = _col_chunks(L, wb, chunk_cols)
    enc = dict(wb=wb, wire_dtype=wire_dtype, dense_dtype=dense_dtype,
               impl=impl)
    if n == 1:
        sv = stale.view(C, Dev, L)
        return [_chunk_payloads(sv[:, 0, c0:c1].float(), layout, **enc)
                for c0, c1 in chunks]
    rr = _rank_rows(R, n, axes, mesh, Dev)
    if rr is None:
        return [_chunk_payloads(_cluster_sums(stale[:, c0:c1], mesh, axes,
                                              C, Dev)[0] / Dev, layout,
                                **enc) for c0, c1 in chunks]
    tables = _rank_tables_of(rr, layout, mesh, axes)
    sv = stale.view(rr.m, R // rr.m, L)
    return [_rank_payloads(sv[:, 0, c0:c1].float(), rr, layout, tables,
                           **enc) for c0, c1 in chunks]


def payload_tensors(payloads):
    """Every tensor of ``stale_payloads``' result (either form)."""
    for chunk in payloads:
        for entry in chunk:
            if entry is None:
                continue
            fields = entry[0] if isinstance(entry[0], tuple) else entry
            for t in fields:
                if t is not None:
                    yield t


def sparse_exchange_(x, *, clusters: int, dev: int, k=None, theta=None,
                     cluster_theta=None, hkind: str = "ring",
                     p_edge: float = 0.4, seed: int = 0,
                     wire_dtype: str = "f32", wire_block: int = 1024,
                     dense_dtype=None, wire_ef=None,
                     wire_ef_gamma: float = 1.0, impl=None,
                     chunk_cols: Optional[int] = None, conn=None,
                     stale=None, stale_clusters=None,
                     payloads=None, mesh=None, axes=()) -> None:
    """The sparse gossip in place on intra-cluster means.

    x: (R, L), contiguous, every device row holding its cluster's mean
    (``intra_done`` rows); overwritten with the mixed rows in x's type.
    ``wire_ef``: None or (est_self, est_wsum), (R, L) f32, advanced in
    place.  ``dense_dtype`` (default x's type) is what a dense-fallback
    plan ships and what sizes the fallback test.  The leaf runs in column
    chunks of ``chunk_cols`` rounded down to whole wire blocks (None: one
    chunk), the plans decided on the whole row.  ``conn``: (C,) backhaul
    mask (``_sparse_mix_rows``).  ``stale`` (R, L), cluster-uniform rows,
    with ``stale_clusters``: the set ships its row 0 of ``stale``;
    ``payloads``: ``stale_payloads`` of the same leaf and arguments, in
    place of the encodes (every cluster stale).

    With ``axes`` over more than one rank of ``mesh`` x (and each wire-EF
    estimate, and ``stale``) is this rank's (R_local, L) rows and
    ``payloads`` this rank's ``stale_payloads``; layouts A and B ship
    each chunk's payloads to the ranks that read them, anything else
    takes the psum fallback (``_sparse_fallback_``)."""
    C, Dev = clusters, dev
    conn = _conn_or_none(conn)
    axes = _axes_tuple(axes)
    n = _ranks(axes, mesh)
    R, L = x.shape
    if R * n != C * Dev:
        raise ValueError(f"{R} rows{f' a rank on {n} ranks' if n > 1 else ''}"
                         f" for {C} clusters x {Dev} devices")
    if (stale is None) != (stale_clusters is None):
        raise ValueError("stale= and stale_clusters= go together")
    if wire_ef is not None and (stale is not None or payloads is not None):
        raise ValueError("wire_ef is incompatible with stale payloads")
    if stale is not None:
        if payloads is not None:
            raise ValueError("pass stale= or payloads=, not both")
        stale_clusters = _check_stale_set(stale_clusters, C)
        if tuple(stale.shape) != (R, L):
            raise ValueError(f"stale rows {tuple(stale.shape)} for x "
                             f"{(R, L)}")
    dense_dtype = dense_dtype or x.dtype
    if n > 1:
        theta, cluster_theta = _rank_levels(axes, theta, cluster_theta)
    layout, wb = _exchange_layout(
        L, dense_dtype, C, k=k, theta=theta, cluster_theta=cluster_theta,
        hkind=hkind, p_edge=p_edge, seed=seed, wire_block=wire_block,
        wire_dtype=wire_dtype)
    chunks = _col_chunks(L, wb, chunk_cols)
    if payloads is not None and len(payloads) != len(chunks):
        raise ValueError(f"{len(payloads)} chunks of payloads for "
                         f"{len(chunks)} chunks")
    kw = dict(wb=wb, wire_dtype=wire_dtype, dense_dtype=dense_dtype,
              wire_ef_gamma=wire_ef_gamma, impl=impl, conn=conn,
              stale_clusters=stale_clusters)
    if n > 1:
        return _rank_exchange_(x, layout, chunks, mesh=mesh, axes=axes, C=C,
                               Dev=Dev, wire_ef=wire_ef, stale=stale,
                               payloads=payloads, **kw)
    xv = x.view(C, Dev, L)
    ev = None if wire_ef is None else [e.view(C, Dev, L) for e in wire_ef]
    sv = None if stale is None else stale.view(C, Dev, L)
    for i, (c0, c1) in enumerate(chunks):
        means = xv[:, 0, c0:c1].float()
        ef_rows = None if ev is None else tuple(e[:, 0, c0:c1] for e in ev)
        out = _sparse_mix_rows(
            means, layout, wire_ef=ef_rows,
            stale=None if sv is None else sv[:, 0, c0:c1].float(),
            payloads=None if payloads is None else payloads[i], **kw)
        if ev is not None:
            out, es, ew = out
            ev[0][:, :, c0:c1].copy_(es[:, None])
            ev[1][:, :, c0:c1].copy_(ew[:, None])
            del es, ew
        xv[:, :, c0:c1].copy_(out[:, None])
        del means, out  # free before the next chunk's rows


def _rank_exchange_(x, layout, chunks, *, mesh, axes, C, Dev, wire_ef,
                    stale, payloads, **kw) -> None:
    """``sparse_exchange_`` on this rank's (R_local, L) rows."""
    R_local, L = x.shape
    rr = _rank_rows(R_local, mesh.size(axes), axes, mesh, Dev)
    if rr is None:
        return _sparse_fallback_(x, layout, mesh, axes, C, Dev, wire_ef,
                                 chunks, stale=stale, payloads=payloads,
                                 **kw)
    d = R_local // rr.m
    xv = x.view(rr.m, d, L)
    ev = None if wire_ef is None else [e.view(rr.m, d, L) for e in wire_ef]
    sv = None if stale is None else stale.view(rr.m, d, L)
    for i, (c0, c1) in enumerate(chunks):
        means = xv[:, 0, c0:c1].float()
        ef_rows = None if ev is None else tuple(e[:, 0, c0:c1] for e in ev)
        out = _rank_mix_rows(
            means, rr, layout, mesh, axes, wire_ef=ef_rows,
            stale=None if sv is None else sv[:, 0, c0:c1].float(),
            payloads=None if payloads is None else payloads[i], **kw)
        if ev is not None:
            out, es, ew = out
            ev[0][:, :, c0:c1].copy_(es[:, None])
            ev[1][:, :, c0:c1].copy_(ew[:, None])
            del es, ew
        xv[:, :, c0:c1].copy_(out[:, None])
        del means, out


def _sparse_fallback_(x, layout, mesh, axes, C, Dev, wire_ef, chunks, *,
                      wb, wire_dtype, dense_dtype, wire_ef_gamma, impl,
                      conn, stale=None, stale_clusters=None, payloads=None):
    """The reference's ``_sparse_fallback`` (:1114) in place, chunk by
    chunk: the psum of the (C, Lc) cluster sums / Dev (raw rows sum to the
    cluster's sum, intra means to Dev times the mean), the one-process
    wire on all C rows on every rank, each rank taking its rows' clusters
    (the estimates likewise; ``stale`` rows through the same psum)."""
    for i, (c0, c1) in enumerate(chunks):
        sums, cl = _cluster_sums(x[:, c0:c1], mesh, axes, C, Dev)
        ef_rows = None if wire_ef is None else tuple(
            _cluster_sums(e[:, c0:c1], mesh, axes, C, Dev)[0] / Dev
            for e in wire_ef)
        smeans = None if stale is None else _cluster_sums(
            stale[:, c0:c1], mesh, axes, C, Dev)[0] / Dev
        out = _sparse_mix_rows(sums / Dev, layout, wb=wb,
                               wire_dtype=wire_dtype, dense_dtype=dense_dtype,
                               wire_ef=ef_rows, wire_ef_gamma=wire_ef_gamma,
                               impl=impl, conn=conn, stale=smeans,
                               stale_clusters=stale_clusters,
                               payloads=None if payloads is None
                               else payloads[i])
        idx = torch.as_tensor(cl, device=x.device)
        if wire_ef is not None:
            out, es, ew = out
            wire_ef[0][:, c0:c1].copy_(es[idx])
            wire_ef[1][:, c0:c1].copy_(ew[idx])
        x[:, c0:c1].copy_(out[idx])


def sparse_neighbor_exchange(delta, *, clusters: int, dev: int, axes=(),
                             k: Optional[int] = None,
                             theta: Optional[float] = None,
                             cluster_theta=None, hkind: str = "ring",
                             p_edge: float = 0.4, seed: int = 0,
                             wire_dtype: str = "f32",
                             wire_block: int = 1024,
                             intra_done: bool = False, alive=None,
                             conn=None, stale=None, stale_clusters=None,
                             wire_ef: Optional[Tuple] = None,
                             wire_ef_gamma: float = 1.0, impl=None,
                             mesh=None):
    """Gossip mix where only wire-encoded cluster means cross the
    backhaul (the reference's ``axes=()`` path, collectives.py:758).

    delta: (R, *dims) replica rows; exactly one of ``k`` (a per-row
    coordinate budget), ``theta`` (one level) or ``cluster_theta`` (one
    level per cluster) sizes the payloads.  ``intra_done=True`` rows are
    already cluster means.  A uniform dense-fallback plan on raw rows is
    the dense mix (``mix_local``).  ``wire_ef=(est_self, est_wsum)`` (f32,
    shaped like delta) turns on the CHOCO wire error feedback (needs
    ``intra_done`` and a gossip ``hkind``); the return is then (y,
    est_self+, est_wsum+).  ``impl`` routes the wire ops.  ``alive`` /
    ``conn``: the masks of ``mix_local`` (``alive`` premultiplies raw
    rows; ``intra_done`` rows are already masked means).  ``stale``
    (shaped like delta, cluster-uniform rows) and ``stale_clusters`` (a
    non-empty subset of range(C)), both or neither, need ``intra_done``:
    the set's clusters ship their ``stale`` row, the self terms stay
    fresh (bounded-stale gossip).  Returns the mixed rows, delta's shape
    and type.

    With ``axes`` over more than one rank of ``mesh`` (reference :966):
    delta, ``alive`` and the estimates are this rank's rows; raw rows'
    intra means come from ``mix_local(hkind="none")`` (layouts A and B)
    or the psum fallback; ``stale`` is this rank's rows likewise."""
    axes = _axes_tuple(axes)
    n = _ranks(axes, mesh)
    conn = _conn_or_none(conn)
    C, Dev = clusters, dev
    if (stale is None) != (stale_clusters is None):
        raise ValueError("stale= and stale_clusters= go together")
    if stale is not None:
        if not intra_done:
            raise ValueError("stale= requires intra_done=True rows")
        stale_clusters = _check_stale_set(stale_clusters, C)
    if wire_ef is not None:
        if not intra_done:
            raise ValueError("wire_ef requires intra_done=True rows (the "
                             "estimates track per-cluster means)")
        if stale is not None:
            raise ValueError("wire_ef is incompatible with stale= payloads "
                             "(neighbors' estimates would advance on a "
                             "buffer the sender's estimate never saw)")
        if hkind == "none":
            raise ValueError("wire_ef requires a gossip hkind (no wire to "
                             "feed back on)")
        if len(wire_ef) != 2:
            raise ValueError("wire_ef must be (est_self, est_wsum)")
        if conn is not None:
            raise ValueError("wire_ef is incompatible with conn= "
                             "partitions (sender and receiver estimate "
                             "updates would desync)")
    if alive is not None and not intra_done:
        delta = _alive_premultiply(delta, alive)
    mesh_kw = dict(axes=axes, mesh=mesh) if n > 1 else {}
    if hkind == "none":
        return mix_local(delta, clusters=C, dev=Dev, hkind="none", **mesh_kw)
    R = delta.shape[0]
    L = delta[0].numel()
    if n > 1:
        theta, cluster_theta = _rank_levels(axes, theta, cluster_theta)
    level_kw = dict(k=k, theta=theta, cluster_theta=cluster_theta,
                    wire_block=wire_block, wire_dtype=wire_dtype)
    plans = _level_plans(L, delta.element_size(), C, **level_kw)
    if plans == [(("dense",), None)] and not intra_done:
        # the uniform dense fallback end to end is the dense mix
        return mix_local(delta, clusters=C, dev=Dev, hkind=hkind,
                         p_edge=p_edge, seed=seed, conn=conn, **mesh_kw)
    if n > 1:
        rows = delta.float().reshape(R, L)
        if intra_done or _rank_rows(R, n, axes, mesh, Dev) is None:
            x = rows.clone()  # the fallback's psum / Dev takes either
        else:
            x = mix_local(rows, clusters=C, dev=Dev, hkind="none",
                          **mesh_kw).contiguous()
        est = None if wire_ef is None else [
            e.float().reshape(R, L).clone() for e in wire_ef]
        sparse_exchange_(x, clusters=C, dev=Dev, hkind=hkind, p_edge=p_edge,
                         seed=seed, dense_dtype=delta.dtype, wire_ef=est,
                         wire_ef_gamma=wire_ef_gamma, impl=impl, conn=conn,
                         stale=None if stale is None
                         else stale.reshape(R, L),
                         stale_clusters=stale_clusters, **level_kw,
                         **mesh_kw)
        y = x.to(delta.dtype).reshape(delta.shape)
        if est is None:
            return y
        return y, est[0].reshape(delta.shape), est[1].reshape(delta.shape)
    if intra_done:
        x = delta.reshape(R, L).clone()
    else:  # f32 cluster means, rounded to delta's type only at the end
        x = delta.float().reshape(C, Dev, L).mean(dim=1)[:, None].expand(
            C, Dev, L).reshape(R, L).contiguous()
    est = None if wire_ef is None else [
        e.float().reshape(R, L).clone() for e in wire_ef]
    sparse_exchange_(x, clusters=C, dev=Dev, hkind=hkind, p_edge=p_edge,
                     seed=seed, dense_dtype=delta.dtype, wire_ef=est,
                     wire_ef_gamma=wire_ef_gamma, impl=impl, conn=conn,
                     stale=None if stale is None else stale.reshape(R, L),
                     stale_clusters=stale_clusters, **level_kw)
    y = x.to(delta.dtype).reshape(delta.shape)
    if est is None:
        return y
    return y, est[0].reshape(delta.shape), est[1].reshape(delta.shape)
