"""The HCEF round step (Algorithm 1, lines 4-19), synchronous and
overlapped (port of ``repro/core/round.py``: ``FLState``, ``init_state``,
``_split_batch``, ``_global_norm2``, ``_check_cluster_levels``,
``make_round_step``, :178-547, ``OverlapState``,
``init_overlap_state`` and ``make_overlap_round_step``, :77-137,
:557-713, ``abstract_state``, ``abstract_overlap_state``,
``make_serve_step`` and ``make_prefill_step``, :124-143, :716-733).

Stacked-replica layout: every leaf of the state holds the R devices' copies
on a leading dim.  One call is one edge round:
  tau masked local SGD steps per device  ->  delta = x_tau - x_0
  -> Q(delta + ef) block top-k with error feedback (theta per device),
     one top-k kernel launch over every leaf of a type pair
  -> the aggregation, by one of two branches:
     off the mesh (no policy): the intra-cluster mean, or on gossip rounds
       the (C, R) GEMM M = H diag(1/Dev) B that folds the mean and the H
       mix into one, in f32;
     fused (a ``dist.policies`` policy, the reference's mesh branch at one
       shard, :301-505): x0 + Q in the parameters' type, its cluster means
       (``mix_local``), and on gossip rounds with ``sparse_gossip`` the
       theta-scaled gossip through the wire (``sparse_exchange_``), with
       per-cluster levels and the CHOCO wire error feedback
  -> every device of a cluster takes its cluster's model.

Where the reference is pure, this step updates the state's tensors in
place, with the same arithmetic: the devices' local steps run one after the
other into one stacked delta buffer, SGD updates in place
(``optim.sgd.sgd_update_``), Q writes the compressed delta over the delta
and the residual over the EF buffer, and the aggregation and the gossip
run in column chunks written back into the parameters.  At mamba2-1.3B's
width (R = 4) the state alone is 48.7 GB; this keeps the round's extra
memory to the delta buffer, one device's gradients and activations.

The degraded-mode masks (``alive``, ``alive_w``, ``conn``; reference
:249-280) drop devices and partition clusters: a dropped device's
compressed update is folded into its EF (``runtime.chaos.
fold_dropped_updates``), the intra mean is over live devices, and the
gossip is ``mixing.participation_mixing(H, conn)``.  Fault-free rounds
pass None and run the unmasked code.  ``split_state`` / ``merge_state``
divide the state into the mesh half and the per-client half that pages
against ``runtime/population.PopulationStore`` (DESIGN.md §Cohort
contract).

The overlapped engine (DESIGN.md §Overlap contract) keeps a second
buffer, ``pending``, the model at the start of the round.  At staleness 1
a gossip round runs the intra-only step, then folds the gossip in which
the stale clusters ship ``pending``: their payloads do not depend on the
local steps.  Where the reference leaves the scheduling to XLA, here the
stale payloads of an all-stale sparse gossip are encoded on a side CUDA
stream while the main stream runs the local steps.

With a policy whose replica axes span n > 1 ranks (``dist.policies``,
the reference's shard_map over the data axes) each rank holds its R / n
contiguous rows of every leaf and runs those devices' local steps, one
top-k launch over its rows, ``mix_local`` over the replica axes and the
wire across ranks; the round's inputs stay the reference's (batch, rho,
theta, the bits, the masks for all R; each rank takes its rows) and the
metrics come back for all R through one all_gather, so that every rank's
controller sees the same numbers.  The overlapped engine runs there too
(the reference's shard_map a leaf, :643): ``pending`` is the rank's rows,
its stage 2 the wire across ranks on them, and with every cluster stale
each rank encodes its own rows' stale payloads ahead of its local steps.

With a "model" axis of n > 1 ranks (the dense decoder with the ViT stub,
the encoder-decoder, mamba2 and griffin) each rank holds a slab of every
leaf (``convert.shard_slabs``:
its rows, and its 1 / n of the leaf's ``Policy.leaf_split`` dim in the
reference's shard-local layout).  Each local replica's parameters and
momentum go from that storage piece to the model's compute pieces (the
model module's ``tensor_dims``, ``dist.tensor.to_compute``) once a
round, the local steps run the model on the tensor axis
(``model.loss_fn(..., tp=)``), and the delta and momentum come back to
storage (``to_storage``) before Q.  The gradient norm behind g2 and
sigma2 sums each split leaf's squares over the axis and counts once what
every rank computes whole: a whole leaf, and the whole segments of a
segmented one (mamba2's B and C at one group).  Q, x0 + Q, the intra
mean and the gossip then run on the slab, over the replica axes only:
each model index is its own group (the reference's per-leaf shard_map,
:301-480).  The transport's
bytes of the local steps and of the aggregation are kept apart
(``RankMesh.counted``: "tensor", "aggregate").  The chaos masks are per
row, and every model rank of a data rank holds the same rows: each
applies them to its slabs as on the replica axes, after checking once a
masked round that the axis's ranks were given the same masks (a CRC of
their bytes, gathered over the axis).  The overlapped engine's
``pending`` is the rank's slabs: its stale payloads are encoded slab by
slab and ship over the replica axes of each model index, as the
synchronous gossip's do.  MoE raises there
(``policies.check_model_axis``, item 5.3).

The masked-step bits, ``jax.random.bernoulli(key, rho, (tau,))`` in the
reference (:220), cannot be reproduced: they come from ``bits_fn(key, rho)
-> (R, tau)``.  The reference's R == 1 branch exists for ``vmap``; here the
devices run in a loop and R = 1 takes the same path.
"""
from __future__ import annotations

import contextlib
import functools
import time
import zlib
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLTopology, HCEFConfig, ModelConfig
from repro_torch.core.compression import compress_delta
from repro_torch.core.mixing import make_mixing, participation_mixing
from repro_torch.device import from_numpy, resolve
from repro_torch.dist.collectives import (mix_local, payload_tensors,
                                          sparse_exchange_, stale_payloads)
from repro_torch.dist.policies import check_model_axis
from repro_torch.dist.tensor import (Segmented, segments, shift,
                                     tensor_axis, to_compute, to_storage)
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import get_model
from repro_torch.optim.sgd import sgd_update_
from repro_torch.runtime.chaos import fold_dropped_updates
from repro_torch.tree import flatten, tree_map, unflatten

AGG_COLS = 1 << 22  # columns of a leaf per aggregation chunk
# columns of a leaf per gossip chunk, at most: the gossip's chunk loop is
# host-bound below this width (tools/gossip_bench.py on an H100,
# mamba2-1.3B with C = 2 clusters: a gossip round in 151-157 ms at 2^22
# columns, 65-88 ms at 2^23, 63-64 ms at 2^24, the gossip adding 0.42 GB
# at 2^24, about three (C, cols) f32 rows)
GOSSIP_COLS = 1 << 24
# the chunk's scratch that every backhaul keeps to: four (C, cols) f32
# rows, GOSSIP_COLS at C = 2.  The gossip holds the cluster means and the
# mixed rows at once, with the wire EF also the two new estimates
GOSSIP_SCRATCH_BYTES = 4 * 2 * 4 * GOSSIP_COLS


def gossip_cols(clusters: int) -> int:
    """Columns of a leaf per gossip chunk with ``clusters`` clusters:
    GOSSIP_COLS, narrowed so that four (clusters, cols) f32 rows stay
    within GOSSIP_SCRATCH_BYTES.  The mixed rows do not depend on it."""
    return min(GOSSIP_COLS, GOSSIP_SCRATCH_BYTES // (4 * 4 * clusters))


class FLState(NamedTuple):
    params: Any      # nested dict, leaves (R, *shape)
    momentum: Any    # like params (state_dtype), or None
    ef: Any          # error feedback, like params
    round_idx: int
    # CHOCO wire-EF estimates (hcef.wire_ef): {"est_self": tree, "est_wsum":
    # tree} of f32 leaves shaped like params, or None
    wire_ef: Any = None


# The state's two halves (DESIGN.md §Cohort contract): the mesh half (the
# cluster models and the round counter) stays on the card across cohorts;
# each slot's per-client half belongs to the logical client the cohort put
# there and pages against runtime/population.PopulationStore.
MESH_FIELDS = ("params", "round_idx")
CLIENT_FIELDS = ("ef", "momentum", "wire_ef")


class OverlapState(NamedTuple):
    """The overlapped engine's state (reference :77): ``fl`` is the
    working buffer the local steps run on; ``pending`` (params-shaped,
    leaves (R, *shape)) the model at the start of the round, which stale
    clusters ship.  ``pending`` is a buffer of its own: the step writes
    ``fl.params`` in place, and refreshes ``pending`` by a copy at its
    end."""
    fl: FLState
    pending: Any


def split_state(state: FLState):
    """FLState -> (mesh_half, client_half) dicts (the same tensors)."""
    mesh = {f: getattr(state, f) for f in MESH_FIELDS}
    client = {f: getattr(state, f) for f in CLIENT_FIELDS}
    return mesh, client


def merge_state(mesh, client) -> FLState:
    """The inverse of ``split_state``."""
    return FLState(**mesh, **client)


def client_template(state: FLState):
    """One client's page: the client half's leaves without the leading
    slot dim, as ``torch.empty`` meta tensors ({"ef": {...}, ...}; None
    fields left out)."""
    _, client = split_state(state)
    return {f: tree_map(lambda x: torch.empty(
        tuple(x.shape[1:]), dtype=x.dtype, device="meta"), t)
        for f, t in client.items() if t is not None}


def bernoulli_bits(key: int, rho, *, tau: int) -> torch.Tensor:
    """Default masked-step bits: (N, tau) in {0, 1}, P(1) = clip(rho, 0, 1)
    per device, from a CPU torch.Generator seeded with ``key``."""
    gen = torch.Generator().manual_seed(int(key))
    rho = torch.as_tensor(np.clip(np.asarray(rho, np.float64), 0.0, 1.0))
    u = torch.rand((len(rho), tau), generator=gen, dtype=torch.float64)
    return (u < rho[:, None]).float()


NORM_COLS = 1 << 24  # entries of a tensor squared in f32 at a time


def _global_norm2(tensors) -> torch.Tensor:
    """sum of squares of every tensor, in f32 (:95), a tensor's f32
    squares summed NORM_COLS entries at a time (no f32 copy of a whole
    large gradient: recurrentgemma-9b's embedding is 1.05 B entries)."""
    return sum(_sum_squares(t) for t in tensors)


def _sum_squares(t: torch.Tensor) -> torch.Tensor:
    flat = t.reshape(-1)
    if flat.numel() <= NORM_COLS:
        return torch.sum(torch.square(flat.float()))
    return sum(torch.sum(torch.square(flat[c0:c0 + NORM_COLS].float()))
               for c0 in range(0, flat.numel(), NORM_COLS))


def _tensor_norm2(tensors, specs, ax) -> torch.Tensor:
    """``_global_norm2`` of a model split over the tensor axis ``ax``,
    each tensor a compute piece under its split (``specs``): the split
    tensors' and segments' squares summed over it, what every rank holds
    whole (a None split, a ``Segmented`` split's whole segments) once."""
    split, whole = [], []
    for t, spec in zip(tensors, specs):
        if isinstance(spec, Segmented):
            for v, w in segments(t, spec, ax.size):
                (whole if w else split).append(v)
        else:
            (whole if spec is None else split).append(t)
    total = ax.psum(_global_norm2(split).reshape(1))[0] if split else 0.0
    return total + _global_norm2(whole)


def _held_in(buf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The compute piece ``x`` in the memory of ``buf`` (a contiguous
    storage row) where they hold as many entries: a view of buf with x's
    values; else x itself."""
    if buf.numel() != x.numel():
        return x
    return buf.view(x.shape).copy_(x)


def _back_to_storage(y, s, c, ax, out):
    """``to_storage`` of the compute piece y into ``out``, through a
    temporary where y lies in out's memory (``_held_in``)."""
    if y.data_ptr() != out.data_ptr():
        to_storage(y, s, c, ax, out=out)
        return
    tmp = torch.empty_like(out)
    to_storage(y, s, c, ax, out=tmp)
    out.copy_(tmp)


def init_state(cfg: ModelConfig, hcef: HCEFConfig, topo: FLTopology,
               params0, device=None, replicas: Optional[int] = None
               ) -> FLState:
    """Every device starts from ``params0`` (a nested dict of tensors or
    numpy arrays: the reference draws its own with ``jax.random``, so the
    weights are an input here); momentum in ``cfg.state_dtype`` and EF in
    the parameters' type start at zero, as do the f32 wire-EF estimates
    with ``hcef.wire_ef``.  ``replicas``: the rows this process holds (a
    rank's R / n, ``shard_rows`` of the whole state), default R."""
    dev = resolve(device)
    R = topo.num_devices if replicas is None else int(replicas)

    def stack(x):
        t = x.to(dev) if isinstance(x, torch.Tensor) else from_numpy(
            np.asarray(x), dev)
        return t[None].expand((R,) + tuple(t.shape)).clone()

    params = tree_map(stack, params0)
    mom = None
    if hcef.momentum and cfg.state_dtype:
        sd = dtype_of(cfg.state_dtype)
        mom = tree_map(lambda x: torch.zeros(x.shape, dtype=sd, device=dev),
                        params)
    ef = tree_map(torch.zeros_like, params)
    wef = None
    if hcef.wire_ef:
        z = lambda: tree_map(lambda x: torch.zeros(
            x.shape, dtype=torch.float32, device=dev), params)
        wef = {"est_self": z(), "est_wsum": z()}
    return FLState(params=params, momentum=mom, ef=ef, round_idx=0,
                   wire_ef=wef)


def init_overlap_state(cfg: ModelConfig, hcef: HCEFConfig,
                       topo: FLTopology, params0, device=None,
                       replicas: Optional[int] = None) -> OverlapState:
    """``init_state`` and a copy of its parameters as ``pending``: round
    0's stale payload is the initial model, a fixed point of the stale
    mix as of the synchronous one.  ``replicas``: the rows this process
    holds, as ``init_state``'s."""
    fl = init_state(cfg, hcef, topo, params0, device, replicas=replicas)
    return OverlapState(fl=fl, pending=tree_map(torch.clone, fl.params))


def abstract_state(cfg: ModelConfig, hcef: HCEFConfig,
                   topo: FLTopology) -> FLState:
    """``init_state`` on ``meta`` (round.py:124): the state's shapes and
    types with nothing allocated, for the dry run."""
    params0 = get_model(cfg).init(cfg, device="meta")
    return init_state(cfg, hcef, topo, params0, device="meta")


def abstract_overlap_state(cfg: ModelConfig, hcef: HCEFConfig,
                           topo: FLTopology) -> OverlapState:
    """``init_overlap_state`` on ``meta`` (round.py:140)."""
    params0 = get_model(cfg).init(cfg, device="meta")
    return init_overlap_state(cfg, hcef, topo, params0, device="meta")


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens) -> (logits, cache): one decode
    token across the batch, the family's ``decode_step`` (round.py:716;
    one process, so no policy)."""
    model = get_model(cfg)

    def serve_step(params, cache, tokens):
        return model.decode_step(cfg, params, cache, tokens)
    return serve_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch, cache) -> (logits, cache): the family's
    ``prefill`` (round.py:727)."""
    model = get_model(cfg)

    def prefill_step(params, batch, cache):
        return model.prefill(cfg, params, batch, cache)
    return prefill_step


def _phase_timer(timings, dev):
    """phase(name): a context manager that appends its body's host ms to
    ``timings[name]`` (None: no timing), the current stream's work
    finished at both ends.  The current stream only: the overlapped
    engine's side stream runs on through the phases it overlaps."""
    sync = ((lambda: torch.cuda.current_stream(dev).synchronize())
            if dev.type == "cuda" else (lambda: None))

    @contextlib.contextmanager
    def phase(name):
        if timings is None:
            yield
            return
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        timings.setdefault(name, []).append(
            (time.perf_counter() - t0) * 1e3)
    return phase


def _mark(events, name, dev):
    """Records a timing CUDA event on the current stream as
    ``events[name]`` (``events`` None or off the card: nothing)."""
    if events is not None and dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events[name] = ev


def _split_batch(batch: Dict[str, torch.Tensor], R: int, tau: int):
    """(global_batch, ...) -> (R, tau, b_local, ...) (:146)."""
    def split(x):
        B = x.shape[0]
        assert B % (R * tau) == 0, (B, R, tau)
        return x.reshape(R, tau, B // (R * tau), *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _per_layer(tree):
    """The leaves a local step differentiates, in a fixed order: each
    top-level leaf whole, then, stack by stack (a top-level dict of
    stacked layer leaves: "layers", or griffin's "attn_layers" and
    "rec_layers"), each layer's slice of every leaf.  Returns (list of
    views, rebuild(list) -> the tree loss_fn takes, each stack as a list
    of per-layer dicts).  Gradients then come per layer: no zero-filled
    (L, ...) gradient per layer slice."""
    tops = sorted(k for k in tree if not isinstance(tree[k], dict))
    stacks = []  # (key, leaf names, layers)
    for key in sorted(k for k in tree if isinstance(tree[k], dict)):
        names = sorted(tree[key])
        stacks.append((key, names, tree[key][names[0]].shape[0]))
    leaves = [tree[k] for k in tops]
    for key, names, L in stacks:
        leaves += [tree[key][n][l] for l in range(L) for n in names]

    def rebuild(vals):
        out = dict(zip(tops, vals[:len(tops)]))
        at = len(tops)
        for key, names, L in stacks:
            m = len(names)
            out[key] = [dict(zip(names, vals[at + l * m:at + (l + 1) * m]))
                        for l in range(L)]
            at += L * m
        return out
    return leaves, rebuild


def _per_layer_keys(tree):
    """The flat name of each of ``_per_layer``'s leaves, in its order."""
    keys = sorted(k for k in tree if not isinstance(tree[k], dict))
    for key in sorted(k for k in tree if isinstance(tree[k], dict)):
        names = sorted(tree[key])
        L = tree[key][names[0]].shape[0]
        keys += [f"{key}/{n}" for _ in range(L) for n in names]
    return keys


def _check_cluster_levels(cluster_levels, hcef, C, policy, gossip):
    """Static per-cluster wire levels (:155): grid levels, one a cluster,
    on a sparse gossip step with a policy."""
    if cluster_levels is None:
        return None
    if not (hcef.sparse_gossip and gossip):
        raise ValueError("cluster_levels requires sparse_gossip and a "
                         "gossip round step")
    if policy is None:
        raise ValueError("cluster_levels requires a mesh policy (the "
                         "non-fused path has no wire)")
    cluster_levels = tuple(float(t) for t in cluster_levels)
    if len(cluster_levels) != C:
        raise ValueError(f"cluster_levels has {len(cluster_levels)} "
                         f"entries for {C} clusters")
    grid = {float(t) for t in hcef.theta_levels}
    bad = [t for t in cluster_levels if t not in grid]
    if bad:
        raise ValueError(f"cluster_levels {bad} not in theta_levels "
                         f"{sorted(grid)} (the static-k contract only "
                         f"lowers grid levels)")
    return cluster_levels


def make_round_step(cfg: ModelConfig, hcef: HCEFConfig, topo: FLTopology,
                    policy=None, *, gossip: bool = True, impl=None,
                    cluster_levels=None,
                    bits_fn: Optional[Callable] = None):
    """Returns round_step(state, batch, rho, theta, key, timings=None,
    alive=None, alive_w=None, conn=None, events=None) -> (state, metrics).

    batch: {"tokens": (R * tau * b_local, S + 1)}, with the frontend's
    inputs beside it (``patch_embeds``, ``frames``: (R * tau * b_local,
    ...)), every key split alike; rho, theta: (R,)
    controls; key: the integer ``bits_fn(key, rho)`` turns into the (R,
    tau) masked-step bits (default: ``bernoulli_bits``).
    ``gossip`` selects the inter-cluster mix (Eq. 5) at the end of the
    round.  ``policy`` (``dist.policies.make_train_policy``) selects the
    fused branch; ``cluster_levels`` (one ``hcef.theta_levels`` entry a
    cluster, from ``cluster_levels_from_theta``) sizes each cluster's
    gossip payload by its own level, and without it the wire takes the
    smallest level >= max(theta).  ``impl`` routes Q and the wire ops
    (None: kernels for CUDA tensors, plain versions on the CPU; "ref":
    the exact top-k oracles, the reference's CPU route).  metrics: (R,)
    tensors loss, g2, sigma2, steps, and on a sparse gossip round the
    scalar theta_wire.  ``timings`` (a dict) collects the synchronised
    host ms of device_round, compress, aggregate and gossip.  ``events``
    (a dict, on the card) receives timing CUDA events recorded on the
    current stream: device_round_end, and around the fused branch's wire
    gossip gossip_start and gossip_end.

    The chaos masks, all None on fault-free rounds (the unmasked code):
    ``alive`` (R,) 0/1, the devices that made the deadline, whose dropped
    updates fold into their EF; ``alive_w`` (R,) f32, the host's
    ``dist.collectives.participation_weights`` (the live-device mean);
    ``conn`` (C,) 0/1 backhaul links (``mixing.participation_mixing``).
    Host arrays (numpy).

    A policy over n > 1 ranks: ``state`` holds this rank's R / n rows
    (``convert.shard_rows``), every other input is the whole round's;
    metrics are for all R.  With a model axis of more than one rank it
    holds the rank's slabs (``convert.shard_slabs``) and the metrics are
    the same on every rank of the axis."""
    model = get_model(cfg)
    C, Dev = topo.clusters, topo.devices_per_cluster
    R = topo.num_devices
    cluster_levels = _check_cluster_levels(cluster_levels, hcef, C, policy,
                                           gossip)
    if hcef.wire_ef and gossip and policy is None:
        raise ValueError("wire_ef requires a mesh policy: the non-fused "
                         "aggregation path has no wire to feed back on")
    if policy is not None and policy.replicas != R:
        raise ValueError(f"policy for {policy.replicas} replicas, topology "
                         f"has {R}")
    ranks = 1 if policy is None or R == 1 else policy.ranks
    if R % ranks:
        raise ValueError(f"R={R} does not tile {ranks} ranks")
    R_loc = R // ranks  # this rank's rows of the replica dim
    r0 = policy.first_replica if ranks > 1 else 0
    mesh_kw = (dict(mesh=policy.mesh, axes=policy.replica_axes)
               if ranks > 1 else {})
    sparse = policy is not None and hcef.sparse_gossip and gossip and R > 1
    use_wef = bool(hcef.wire_ef) and sparse
    # the fused branch's mix before any gossip: the intra mean, or on a
    # dense gossip round the whole W (reference :344, :364)
    fused_hkind = topo.backhaul if gossip and not sparse else "none"
    levels = sorted({float(t) for t in hcef.theta_levels})
    wire_kw = dict(clusters=C, dev=Dev, hkind=topo.backhaul,
                   wire_dtype=hcef.wire_dtype, wire_block=hcef.wire_block,
                   wire_ef_gamma=hcef.wire_ef_gamma, impl=impl,
                   chunk_cols=gossip_cols(C), **mesh_kw)
    H = torch.as_tensor(make_mixing(topo.backhaul, C), dtype=torch.float32)
    M = torch.repeat_interleave(H / Dev, Dev, dim=1)  # (C, R)
    bits_fn = bits_fn or functools.partial(bernoulli_bits, tau=hcef.tau)
    loss_fn = functools.partial(model.loss_fn, cfg)
    norm2 = lambda grads, keys: _global_norm2(grads)
    tensor = policy is not None and policy.model > 1
    if tensor:
        check_model_axis(policy, cfg)
        ax = tensor_axis(policy.mesh, policy.tensor_axes)
        cdims = model.tensor_dims(cfg, policy.model)
        # each unstacked leaf's (storage, compute) split dims
        layout = {}
        for k, v in flatten(model.init(cfg, device="meta")).items():
            sd = policy.leaf_split((R,) + tuple(v.shape))
            layout[k] = (None if sd is None else sd - 1, cdims[k])
        loss_fn = functools.partial(model.loss_fn, cfg, tp=ax)
        # a gradient's split: a layer leaf's on one layer's slice
        gspec = {k: shift(c, -1) if "/" in k else c
                 for k, (_, c) in layout.items()}
        norm2 = lambda grads, keys: _tensor_norm2(
            grads, [gspec[k] for k in keys], ax)

    def device_round(work, x0, mom, batch, bits):
        """One device's tau local iterations, in place.  work: a copy of
        x0 on entry and the delta x_tau - x_0 on exit (x0 None: x_tau);
        mom: updated in place; batch: {key: (tau, b_local, ...)}, tokens
        (tau, b_local, S + 1); bits: (tau,)."""
        leaves, rebuild = _per_layer(work)
        keys = _per_layer_keys(work) if tensor else None
        moms = None if mom is None else _per_layer(mom)[0]
        losses, gn2s = [], []
        for t in range(hcef.tau):
            ps = [v.detach().requires_grad_() for v in leaves]
            with torch.enable_grad():
                loss = loss_fn(rebuild(ps),
                               {k: v[t] for k, v in batch.items()})
                grads = torch.autograd.grad(loss, ps)
            with torch.no_grad():
                gn2s.append(norm2(grads, keys))
                for g in grads:
                    g.mul_(bits[t])
            sgd_update_(ps, grads, moms, lr=hcef.eta, momentum=hcef.momentum)
            losses.append(loss.detach())
        if x0 is not None:
            with torch.no_grad():
                for k, w in flatten(work).items():
                    w.sub_(x0[k])
        gn2 = torch.stack(gn2s)
        g2 = gn2.min()
        return {"loss": torch.stack(losses).mean(), "g2": g2,
                "sigma2": torch.clamp_min(gn2.mean() - g2, 0.0),
                "steps": bits.sum()}

    def tensor_round(r, params, delta, mom, batch, bits):
        """Replica r's local steps on the tensor axis: its parameters and
        momentum from storage to compute pieces, ``device_round``, then
        the delta into ``delta``'s row r and the momentum back, in
        storage.  A leaf whose compute piece is its storage piece (the
        same split) runs on ``delta``'s row and on the momentum in place:
        nothing moves or is copied twice; one whose compute piece has as
        many entries as its storage piece runs in their memory (the
        embedding, stored on d_model and computed on the vocab)."""
        moms = None if mom is None else flatten(mom)
        work, mom_c = {}, {}
        with torch.no_grad():
            for k, v in params.items():
                s, c = layout[k]
                same = s == c
                work[k] = (delta[k][r].copy_(v[r]) if same else
                           _held_in(delta[k][r], to_compute(v[r], s, c, ax)))
                if moms is not None:
                    m = moms[k][r]
                    mom_c[k] = (m if same else
                                _held_in(m, to_compute(m, s, c, ax)))
        metrics = device_round(unflatten(work), None,
                               unflatten(mom_c) if mom_c else None, batch,
                               bits)
        with torch.no_grad():
            for k, w in work.items():
                s, c = layout[k]
                if s != c:
                    _back_to_storage(w, s, c, ax, delta[k][r])
                    if moms is not None:
                        _back_to_storage(mom_c[k], s, c, ax, moms[k][r])
                delta[k][r].sub_(params[k][r])
        return metrics

    def counted(tag):
        return (policy.mesh.counted(tag) if policy is not None
                else contextlib.nullcontext())

    def round_step(state: FLState, batch, rho, theta, key, timings=None,
                   alive=None, alive_w=None, conn=None, events=None):
        chaos = alive is not None
        if chaos:
            if alive_w is None:
                raise ValueError("alive requires alive_w (host-computed "
                                 "participation_weights)")
            if hcef.wire_ef and conn is not None and gossip:
                raise ValueError(
                    "wire_ef is incompatible with chaos cluster "
                    "partitions (conn): a partitioned sender's neighbors "
                    "would zero its contribution while its own estimate "
                    "advances; the shared estimates desync")
            if tensor:
                _same_masks_on_axis(policy, alive, alive_w, conn)
            alive = np.asarray(alive, np.float32)[r0:r0 + R_loc]
            alive_w = np.asarray(alive_w, np.float32)[r0:r0 + R_loc]
            conn = None if conn is None else np.asarray(conn, np.float32)
        params = flatten(state.params)
        dev = next(iter(params.values())).device
        phase = _phase_timer(timings, dev)
        batch = {k: v[r0:r0 + R_loc].to(dev)
                 for k, v in _split_batch(batch, R, hcef.tau).items()}
        bits = torch.as_tensor(np.asarray(bits_fn(key, rho))[r0:r0 + R_loc],
                               dtype=torch.float32, device=dev)
        delta_tree = tree_map(torch.empty_like, state.params)
        delta = flatten(delta_tree)
        per_dev: List[Dict] = []
        with phase("device_round"), counted("tensor"):
            for r in range(R_loc):
                if tensor:
                    per_dev.append(tensor_round(
                        r, params, delta, state.momentum,
                        {k: v[r] for k, v in batch.items()}, bits[r]))
                    continue
                with torch.no_grad():
                    for k, d in delta.items():
                        d[r].copy_(params[k][r])
                work = tree_map(lambda d: d[r], delta_tree)
                mom = (None if state.momentum is None
                       else tree_map(lambda m: m[r], state.momentum))
                per_dev.append(device_round(
                    work, {k: v[r] for k, v in params.items()}, mom,
                    {k: v[r] for k, v in batch.items()}, bits[r]))
        _mark(events, "device_round_end", dev)
        # theta in float32 before Q, as the reference casts it: k is
        # computed from the f32 value
        theta32 = torch.as_tensor(
            np.asarray(theta, np.float32)[r0:r0 + R_loc], device=dev)
        with phase("compress"), torch.no_grad():
            comp, ef = compress_delta(delta, flatten(state.ef), theta32,
                                      block=hcef.block_size,
                                      error_feedback=hcef.error_feedback,
                                      impl=impl)
            if chaos:  # leaf by leaf: one leaf's temporaries at a time
                live = torch.as_tensor(alive > 0, device=dev)
                for k in comp:
                    c2, e2 = fold_dropped_updates({k: comp[k]}, {k: ef[k]},
                                                  live)
                    comp[k].copy_(c2[k])
                    ef[k].copy_(e2[k])
                    del c2, e2
        metrics = {k: torch.stack([m[k] for m in per_dev])
                   for k in per_dev[0]}
        if ranks > 1:  # every rank's host sees all R devices' metrics
            names = sorted(metrics)
            got = policy.mesh.all_gather(
                torch.stack([metrics[k].float() for k in names], dim=1),
                policy.replica_axes).reshape(R, len(names))
            metrics = {k: got[:, i] for i, k in enumerate(names)}
        masks = (alive_w, conn) if chaos else None
        if policy is None:
            aggregate(params, comp, phase, masks)
        else:
            with counted("aggregate"):
                fused(params, comp, state, theta, metrics, phase, masks,
                      events)
        return state._replace(round_idx=state.round_idx + 1), metrics

    def aggregate(params, comp, phase, masks):
        """The off-mesh aggregate (:506-547), in f32 column chunks.  Under
        the masks the gossip GEMM takes M = repeat(participation_mixing(H,
        conn) / Dev) * alive_w, and the intra mean upd * alive_w."""
        dev = next(iter(params.values())).device
        Md, aw = M, None
        if masks is not None:
            alive_w, conn = masks
            aw = torch.as_tensor(alive_w, device=dev)[:, None]
            if gossip:
                Hg = (H.numpy() if conn is None
                      else participation_mixing(H.numpy(), conn))
                Md = torch.as_tensor(np.repeat(Hg / np.float32(Dev), Dev,
                                               axis=1) * alive_w[None, :])
        with phase("aggregate"), torch.no_grad():
            Md = Md.to(dev)
            for k, x0 in params.items():
                xf, cf = x0.view(R, -1), comp[k].view(R, -1)
                for c0 in range(0, xf.shape[1], AGG_COLS):
                    xc = xf[:, c0:c0 + AGG_COLS]
                    upd = xc.float() + cf[:, c0:c0 + AGG_COLS].float()
                    if gossip:
                        yc = Md @ upd
                    else:
                        if aw is not None:
                            upd = upd * aw
                        yc = upd.view(C, Dev, -1).mean(dim=1)
                    xc.view(C, Dev, -1).copy_(yc[:, None])

    def fused(params, comp, state, theta, metrics, phase, masks, events):
        """The fused branch (:301-505) on this rank's rows: per leaf x0 +
        Q in the parameters' type and its ``mix_local`` (over the replica
        axes across ranks), then on sparse gossip rounds the wire gossip
        of the cluster means, leaf by leaf, the wire-EF estimates advanced
        in place.  Under the masks ``mix_local`` takes alive_w (and conn
        on a dense gossip round), the wire gossip conn (:337-480)."""
        mix_kw, conn = {}, None
        if masks is not None:
            alive_w, conn = masks
            mix_kw = dict(alive=alive_w, conn=(
                conn if fused_hkind != "none" else None))
        with phase("aggregate"), torch.no_grad():
            for k, x0 in params.items():
                xf, cf = x0.view(R_loc, -1), comp[k].view(R_loc, -1)
                for c0 in range(0, xf.shape[1], AGG_COLS):
                    xc = xf[:, c0:c0 + AGG_COLS]
                    upd = xc + cf[:, c0:c0 + AGG_COLS]
                    xc.copy_(mix_local(upd, clusters=C, dev=Dev,
                                       hkind=fused_hkind, **mix_kw,
                                       **mesh_kw)
                             if R > 1 else upd)
        if not sparse:
            return
        lv, theta_wire = _wire_level(cluster_levels, levels, theta)
        est = ([flatten(state.wire_ef[f]) for f in ("est_self", "est_wsum")]
               if use_wef else None)
        dev = next(iter(params.values())).device
        with phase("gossip"), torch.no_grad():
            _mark(events, "gossip_start", dev)
            for k, x0 in params.items():
                wef = (None if est is None
                       else [e[k].view(R_loc, -1) for e in est])
                sparse_exchange_(x0.view(R_loc, -1), wire_ef=wef, conn=conn,
                                 **lv, **wire_kw)
            _mark(events, "gossip_end", dev)
        metrics["theta_wire"] = torch.tensor(theta_wire, dtype=torch.float32)

    return round_step


def _same_masks_on_axis(policy, alive, alive_w, conn):
    """Raises unless every rank of the policy's tensor axes was given the
    same chaos masks (the whole round's host arrays): one CRC-32 of their
    bytes a rank, gathered over the axes."""
    crc = 0
    for a in (alive, alive_w, conn):
        crc = zlib.crc32(b"-" if a is None else
                         np.ascontiguousarray(a, np.float32).tobytes(), crc)
    got = policy.mesh.all_gather(torch.tensor(
        [crc], dtype=torch.int64, device=policy.mesh.device),
        policy.tensor_axes).cpu()
    if bool((got != crc).any()):
        raise ValueError(f"the ranks of the model axis were given different "
                         f"chaos masks (CRC-32s {got.flatten().tolist()}): "
                         f"each model rank of a data rank must mask the "
                         f"same rows")


def _wire_level(cluster_levels, levels, theta):
    """The sparse gossip's level arguments and its theta_wire: the static
    per-cluster levels, else the smallest grid level >= max theta, in f32
    (reference :463); ``theta`` the host's per-device levels."""
    if cluster_levels is not None:
        return dict(cluster_theta=cluster_levels), max(cluster_levels)
    levels32 = np.asarray(levels, np.float32)
    top = np.asarray(theta, np.float32).max()
    i = min(int(np.searchsorted(levels32, top, side="left")),
            len(levels) - 1)
    return dict(theta=levels[i]), levels32[i]


def make_overlap_round_step(cfg: ModelConfig, hcef: HCEFConfig,
                            topo: FLTopology, policy=None, *,
                            gossip: bool = True, impl=None,
                            cluster_levels=None, stale_clusters=None,
                            bits_fn: Optional[Callable] = None):
    """The overlapped round step (reference :557): round_step(state:
    OverlapState, batch, rho, theta, key, timings=None, alive=None,
    alive_w=None, conn=None, events=None) -> (OverlapState, metrics), the
    arguments as ``make_round_step``'s.

    Staleness 0, a round without gossip, an empty ``stale_clusters`` or R
    = 1 run ``make_round_step``'s step (its bits) and refresh ``pending``.
    Otherwise (staleness 1) a gossip round runs in two stages: the
    intra-only step (``make_round_step(..., gossip=False)``: local steps,
    compress, EF fold, intra mean), then the stale fold, in which the
    clusters of ``stale_clusters`` (default: all) ship ``pending`` and
    the self terms stay fresh (``sparse_exchange_(stale=...)``).  The fold
    is the sparse wire at ``cluster_levels`` or the grid level >= max
    theta with a policy and ``hcef.sparse_gossip``, else the dense rows
    (theta 1.0 on the f32 wire: dense plans).  ``alive`` / ``alive_w``
    mask stage 1 and ``conn`` the fold.  metrics gain ``stale_frac``.

    When every cluster is stale on the sparse wire, no payload depends on
    the local steps: the step encodes every leaf's every chunk of
    ``pending`` (``stale_payloads``) before stage 1, on the card on a side
    CUDA stream that first waits for the main stream, and stage 2's main
    stream waits on the side stream's event before its first
    decode-and-mix; ``pending`` is refreshed after that wait.  A partial
    set's fresh payloads wait on the local steps (reduced overlap): it
    encodes in line.  ``events`` gains encode_start and encode_end (on the
    side stream) and gossip_start and gossip_end (stage 2).

    A policy over n > 1 ranks: ``state.fl`` and ``pending`` hold this
    rank's R / n rows (``init_overlap_state(replicas=)``), the other
    inputs are the whole round's and the metrics are for all R, as
    ``make_round_step``'s.  Stage 2 runs the wire across the ranks; an
    all-stale round encodes each rank's own payloads on its side stream
    (``stale_payloads(mesh=)``) and ships them in stage 2.  With a model
    axis both buffers hold the rank's slabs (``convert.shard_slabs``) and
    each slab's payloads go over the replica axes of its model index."""
    if not hcef.overlap:
        raise ValueError("make_overlap_round_step requires hcef.overlap "
                         "(use make_round_step for the synchronous engine)")
    check_model_axis(policy, cfg)
    C, Dev = topo.clusters, topo.devices_per_cluster
    R = topo.num_devices
    if stale_clusters is not None:
        stale_clusters = tuple(sorted({int(c) for c in stale_clusters}))
        if any(not 0 <= c < C for c in stale_clusters):
            raise ValueError(
                f"stale_clusters {stale_clusters} out of range({C})")
    if (hcef.staleness == 0 or not gossip or stale_clusters == ()
            or R == 1):
        inner = make_round_step(
            cfg, hcef, topo, policy, gossip=gossip, impl=impl,
            cluster_levels=cluster_levels if gossip else None,
            bits_fn=bits_fn)

        def sync_step(state: OverlapState, batch, rho, theta, key,
                      timings=None, alive=None, alive_w=None, conn=None,
                      events=None):
            fl, metrics = inner(state.fl, batch, rho, theta, key,
                                timings=timings, alive=alive,
                                alive_w=alive_w, conn=conn, events=events)
            _refresh_pending(state.pending, fl.params, timings)
            return OverlapState(fl=fl, pending=state.pending), metrics

        return sync_step

    cluster_levels = _check_cluster_levels(cluster_levels, hcef, C, policy,
                                           gossip=True)
    if stale_clusters is None:
        stale_clusters = tuple(range(C))
    inner = make_round_step(cfg, hcef, topo, policy, gossip=False,
                            impl=impl, bits_fn=bits_fn)
    ranks = 1 if policy is None else policy.ranks
    R_loc = R // ranks  # this rank's rows (make_round_step checked them)
    sparse = policy is not None and hcef.sparse_gossip
    levels = sorted({float(t) for t in hcef.theta_levels})
    # the sparse wire at the round's level, or the dense rows (reference
    # :691-706: theta 1.0 on the f32 wire is the dense-wire fallback)
    wire_kw = dict(clusters=C, dev=Dev, hkind=topo.backhaul, impl=impl,
                   chunk_cols=gossip_cols(C), **(
                       dict(wire_dtype=hcef.wire_dtype,
                            wire_block=hcef.wire_block) if sparse
                       else dict(wire_dtype="f32", theta=1.0)),
                   **(dict(mesh=policy.mesh, axes=policy.replica_axes)
                      if ranks > 1 else {}))
    ahead = sparse and len(stale_clusters) == C
    side_streams = {}  # device -> the side stream of the stale encodes

    def encode_ahead(pending, kw, dev, events):
        """Every leaf's every chunk's stale payloads, and on the card the
        event after the side stream's last encode."""
        if dev.type != "cuda":
            return {k: stale_payloads(p.view(R_loc, -1), **kw)
                    for k, p in pending.items()}, None
        main = torch.cuda.current_stream(dev)
        side = side_streams.setdefault(dev, torch.cuda.Stream(dev))
        side.wait_stream(main)  # pending's last refresh
        with torch.cuda.stream(side), torch.no_grad():
            _mark(events, "encode_start", dev)
            pre = {k: stale_payloads(p.view(R_loc, -1), **kw)
                   for k, p in pending.items()}
            _mark(events, "encode_end", dev)
            done = torch.cuda.Event()
            done.record()
        for chunks in pre.values():  # made on the side stream, read on main
            for t in payload_tensors(chunks):
                t.record_stream(main)
        return pre, done

    def round_step(state: OverlapState, batch, rho, theta, key,
                   timings=None, alive=None, alive_w=None, conn=None,
                   events=None):
        pending = flatten(state.pending)
        dev = next(iter(pending.values())).device
        kw, theta_wire = dict(wire_kw), None
        if sparse:
            lv, theta_wire = _wire_level(cluster_levels, levels, theta)
            kw.update(lv)
        pre = done = None
        if ahead:
            pre, done = encode_ahead(pending, kw, dev, events)
        fl, metrics = inner(state.fl, batch, rho, theta, key,
                            timings=timings, alive=alive, alive_w=alive_w,
                            conn=conn, events=events)
        conn_h = None if conn is None else np.asarray(conn, np.float32)
        with _phase_timer(timings, dev)("gossip"), torch.no_grad():
            if done is not None:
                torch.cuda.current_stream(dev).wait_event(done)
            _mark(events, "gossip_start", dev)
            for k, x0 in flatten(fl.params).items():
                if pre is not None:
                    sparse_exchange_(x0.view(R_loc, -1), payloads=pre.pop(k),
                                     conn=conn_h, **kw)
                else:
                    sparse_exchange_(x0.view(R_loc, -1),
                                     stale=pending[k].view(R_loc, -1),
                                     stale_clusters=stale_clusters,
                                     conn=conn_h, **kw)
            _mark(events, "gossip_end", dev)
        _refresh_pending(state.pending, fl.params, timings)
        if theta_wire is not None:
            metrics["theta_wire"] = torch.tensor(theta_wire,
                                                 dtype=torch.float32)
        metrics["stale_frac"] = torch.tensor(len(stale_clusters) / C,
                                             dtype=torch.float32)
        return OverlapState(fl=fl, pending=state.pending), metrics

    return round_step


def _refresh_pending(pending, params, timings):
    """pending <- params, leaf by leaf, in place (timed as "pending")."""
    pend = flatten(pending)
    dev = next(iter(pend.values())).device
    with _phase_timer(timings, dev)("pending"), torch.no_grad():
        for k, p in flatten(params).items():
            pend[k].copy_(p)
