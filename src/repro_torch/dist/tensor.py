"""The tensor ("model") axis of a rank mesh as a model's layers see it
(the counterpart of the reference's activation constraints,
``repro/dist/policies.py:Policy.act``, :104-148, which GSPMD lowers to
collectives; here they are written out).

``TensorAxis`` holds the axis's ranks and these autograd Functions over
``RankMesh.psum`` / ``all_gather`` on its group:
  ``copy``       identity forward, psum of the gradient backward: a
                 replicated activation entering a split computation;
  ``copy_whole`` identity forward, psum of the gradient's whole segments
                 backward (a ``Segmented`` piece: the segments every rank
                 holds whole feed each rank's split computation);
  ``reduce``     psum forward, identity backward: a split computation's
                 partial sums leaving it, replicated;
  ``gather``     a split dim all-gathered forward, the rank's slice of the
                 gradient backward: for a replicated computation;
  ``gather_rs``  a split dim all-gathered forward, the gradient's psum
                 sliced backward (a reduce-scatter): for a split
                 computation that reads all of it (griffin's RG-LRU gates);
  ``scatter``    the rank's slice of a replicated dim forward, the gradient
                 all-gathered backward.
A gloo collective blocks and is not autograd-aware: these Functions carry
the gradients, and every rank of the axis issues them in one order.  The
forward collectives (the psum of ``reduce``, the all-gather of
``gather_rs``, the max of ``amax``) are operators of their own
(``repro_torch::axis_psum``, ``axis_gather``, ``axis_amax``), so that a
layer recomputed under ``torch.utils.checkpoint`` takes their saved
results (``checkpoint_context``, a selective checkpoint) instead of
issuing the collectives again: a checkpointed layer's collectives run
once in the forward and once in the backward.

A compute split is a dim (an int), or a ``Segmented`` dim: segments laid
end to end (mamba2's in-projection columns [z | x | B | C | dt]), a
rank's piece its 1 / n of each segment, or all of a segment that the
axis does not split (mamba2's B and C where n does not divide its
groups), concatenated in order (``piece``).

``to_compute`` / ``to_storage`` move one leaf between its storage piece
(split on the policy's ``leaf_split`` dim) and its compute piece (split
where the model computes it, or whole): the same dim is a copy, a whole
compute leaf is gathered forward and sliced back, and another split (a
segmented one on any dim included) is one all-to-all over the axis
(``RankMesh.exchange``, one message a peer).  Back in storage, the
columns of a whole segment come from rank 0 alone.  The round step runs
them once a round a replica, not once a step.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

_AXES: Dict[int, "TensorAxis"] = {}  # the axes the psum operator serves


class Segmented(NamedTuple):
    """A compute split of dim ``dim`` cut into segments of ``sizes``, end
    to end: a rank's piece is its 1 / n of each segment, or all of it
    where ``whole`` says so, concatenated in segment order."""
    dim: int
    sizes: Tuple[int, ...]
    whole: Tuple[bool, ...]

    def local_sizes(self, n: int) -> Tuple[int, ...]:
        """Each segment's length in a rank's piece."""
        return tuple(s if w else s // n for s, w in zip(self.sizes,
                                                        self.whole))


Split = Union[None, int, Segmented]  # a leaf's split: none, a dim, segmented


def shift(spec: Split, k: int) -> Split:
    """``spec`` with its dim moved by k (a layer leaf's split on one
    layer's slice: k = -1)."""
    if spec is None:
        return None
    if isinstance(spec, Segmented):
        return spec._replace(dim=spec.dim + k)
    return spec + k


def piece(x, spec: Split, n: int, i: int):
    """Rank i's piece of x under ``spec`` (x itself where spec is None or
    n is 1): its 1 / n of dim ``spec``, a view; of a ``Segmented`` dim,
    its part of each segment concatenated, a new tensor."""
    if spec is None or n == 1:
        return x
    if isinstance(spec, Segmented):
        parts, at = [], 0
        for size, whole in zip(spec.sizes, spec.whole):
            parts.append(x.narrow(spec.dim, at, size) if whole else
                         piece(x.narrow(spec.dim, at, size), spec.dim, n, i))
            at += size
        return torch.cat(parts, dim=spec.dim)
    m = x.shape[spec] // n
    return x.narrow(spec, i * m, m)


def segments(x, spec: Segmented, n: int):
    """A rank's compute piece ``x`` of a segmented split cut back into its
    segments: [(a view, whether every rank holds that segment whole)]."""
    out, at = [], 0
    for size, whole in zip(spec.local_sizes(n), spec.whole):
        out.append((x.narrow(spec.dim, at, size), whole))
        at += size
    return out


def _columns(spec: Segmented, n: int, i: int, own: bool = False):
    """The global indices of rank i's compute piece along ``spec.dim``, in
    its order (ascending); ``own``: the columns it hands back to storage,
    a whole segment's only on rank 0."""
    cols, at = [], 0
    for size, whole in zip(spec.sizes, spec.whole):
        if not whole:
            m = size // n
            cols.append(np.arange(at + i * m, at + (i + 1) * m))
        elif not own or i == 0:
            cols.append(np.arange(at, at + size))
        at += size
    return np.concatenate(cols) if cols else np.zeros(0, np.int64)


def tensor_axis(mesh, axes=("model",)) -> "TensorAxis":
    """The ``axes`` of ``mesh`` as a ``TensorAxis``, made once: a later
    call with the same mesh and axes returns the same one."""
    axes = tuple(axes)
    for ax in _AXES.values():
        if ax.mesh is mesh and ax.axes == axes:
            return ax
    return TensorAxis(mesh, axes)


@torch.library.custom_op("repro_torch::axis_psum", mutates_args=())
def _axis_psum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """x summed over the ranks of registered axis ``axis``, a new
    tensor."""
    ax = _AXES[axis]
    out = ax.psum(x.contiguous())
    return out.clone() if out is x else out


@_axis_psum.register_fake
def _(x, axis):
    return torch.empty_like(x)


_axis_psum.register_autograd(lambda ctx, g: (g, None))


@torch.library.custom_op("repro_torch::axis_amax", mutates_args=())
def _axis_amax(x: torch.Tensor, axis: int) -> torch.Tensor:
    """The elementwise max of x over the ranks of registered axis
    ``axis`` (no gradient)."""
    ax = _AXES[axis]
    return ax.mesh.all_gather(x.contiguous(), ax.axes).amax(dim=0)


@_axis_amax.register_fake
def _(x, axis):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::axis_gather", mutates_args=())
def _axis_gather(x: torch.Tensor, axis: int, dim: int) -> torch.Tensor:
    """Every rank's x of registered axis ``axis`` concatenated on
    ``dim``."""
    return _AXES[axis].all_gather_dim(x, dim)


@_axis_gather.register_fake
def _(x, axis, dim):
    shape = list(x.shape)
    shape[dim] *= _AXES[axis].size
    return x.new_empty(shape)


def _gather_setup(ctx, inputs, output):
    ctx.axis, ctx.dim = inputs[1], inputs[2]


def _gather_backward(ctx, g):
    """The psum of the gradient of the whole, this rank's slice: a
    reduce-scatter."""
    ax = _AXES[ctx.axis]
    return ax.piece(ax.psum(g.contiguous()), ctx.dim).contiguous(), None, \
        None


_axis_gather.register_autograd(_gather_backward, setup_context=_gather_setup)

_SAVED = ("axis_psum", "axis_amax", "axis_gather")


def _save_psums(ctx, op, *args, **kwargs):
    """Keep every forward collective's output (``_SAVED``) through a
    checkpointed layer, recompute the rest."""
    if op in _saved_ops():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@functools.lru_cache(maxsize=None)
def _saved_ops():
    return tuple(getattr(torch.ops.repro_torch, name).default
                 for name in _SAVED)


class TensorAxis:
    """The ``axes`` of ``mesh`` a model splits its work over: ``size``
    ranks, this one at flat index ``index`` (``tensor_axis`` makes each
    once)."""

    def __init__(self, mesh, axes=("model",)):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = mesh.size(self.axes)
        self.index = mesh.flat_index(self.axes)
        self.id = len(_AXES)
        _AXES[self.id] = self
        # ``torch.utils.checkpoint``'s context_fn for a layer on the axis
        self.checkpoint_context = functools.partial(
            create_selective_checkpoint_contexts, _save_psums)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(x, self.axes)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of x over the axis (no gradient)."""
        return torch.ops.repro_torch.axis_amax(x.detach(), self.id)

    def copy(self, x):
        return _Copy.apply(x, self)

    def copy_whole(self, x, spec: Segmented):
        """x, a compute piece of a ``spec`` split, unchanged; backward the
        gradient with its whole segments psummed over the axis (each
        rank's split computation read them: its gradient of them is a
        partial sum).  x itself where no segment is whole."""
        if not any(spec.whole):
            return x
        return _CopyWhole.apply(x, self, spec)

    def reduce(self, x):
        return torch.ops.repro_torch.axis_psum(x, self.id)

    def gather(self, x, dim: int):
        return _Gather.apply(x, self, dim)

    def gather_rs(self, x, dim: int):
        return torch.ops.repro_torch.axis_gather(x, self.id, dim)

    def scatter(self, x, dim: int):
        return _Scatter.apply(x, self, dim)

    def piece(self, x, dim: int, index: Optional[int] = None):
        """Rank ``index``'s (default this rank's) 1 / size of x's dim
        ``dim``, a view."""
        return piece(x, dim, self.size,
                     self.index if index is None else index)

    def all_gather_dim(self, x, dim: int):
        """Every rank's x concatenated on ``dim`` in rank order."""
        g = self.mesh.all_gather(x.contiguous(), self.axes)
        return torch.cat(list(g.unbind(0)), dim=dim)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.psum(g.contiguous()), None


class _CopyWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, spec):
        ctx.ax, ctx.spec = ax, spec
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        whole = [v for v, w in segments(g, ctx.spec, ax.size) if w]
        flat = ax.psum(torch.cat([v.reshape(-1) for v in whole]))
        g = g.clone()
        at = 0
        for v, w in segments(g, ctx.spec, ax.size):
            if w:
                v.copy_(flat[at:at + v.numel()].view(v.shape))
                at += v.numel()
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return ax.all_gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.piece(g, ctx.dim).contiguous(), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return ax.piece(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.ax.all_gather_dim(g, ctx.dim), None, None


def _all_to_all(parts, cat: int, ax: TensorAxis, shapes=None, out=None):
    """``parts[j]`` to rank j; the parts every rank sent here
    concatenated on ``cat`` in rank order (this rank's own in place), or
    written in that order into ``out``'s slices of ``cat``.
    ``shapes[j]``: the shape of rank j's part to this rank (default: this
    rank's own part's)."""
    n, me = ax.size, ax.index
    shapes = shapes or [tuple(parts[me].shape)] * n
    rank = lambda j: ax.mesh.rank_of(ax.axes, j)
    got = ax.mesh.exchange(
        {rank(j): [parts[j]] for j in range(n) if j != me},
        {rank(j): [(tuple(shapes[j]), parts[me].dtype)]
         for j in range(n) if j != me})
    pieces = [parts[j] if j == me else got[rank(j)][0] for j in range(n)]
    if out is None:
        return torch.cat(pieces, dim=cat)
    at = 0
    for t in pieces:
        out.narrow(cat, at, t.shape[cat]).copy_(t)
        at += t.shape[cat]
    return out


def _slab_range(size: int, n: int, i: int):
    """Rank i's contiguous 1 / n of ``size`` indices (a storage slab)."""
    m = size // n
    return i * m, (i + 1) * m


def _index(idx, device):
    return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _with(shape, dim, size):
    shape = list(shape)
    shape[dim] = int(size)
    return tuple(shape)


def to_compute(x, s: Optional[int], c: Split, ax: TensorAxis):
    """A leaf's compute piece (split ``c``: a dim, a ``Segmented`` dim, or
    whole where None) from its storage piece ``x`` (split on ``s``, or
    whole), as a new tensor; dims are x's."""
    n, me = ax.size, ax.index
    if s == c:
        return x.clone()
    if s is None:
        return piece(x, c, n, me).clone()
    if c is None:
        return ax.all_gather_dim(x, s)
    if not (isinstance(c, Segmented) and c.dim == s):
        return _all_to_all([piece(x, c, n, j) for j in range(n)], s, ax)
    # storage: rank i's contiguous columns; a compute piece: its columns
    # of every segment, ascending, so that the parts from ranks 0, 1, ...
    # concatenate into it
    total = sum(c.sizes)
    lo, hi = _slab_range(total, n, me)
    parts = []
    for j in range(n):
        cols = _columns(c, n, j)
        parts.append(x.index_select(s, _index(
            cols[(cols >= lo) & (cols < hi)] - lo, x.device)))
    cols = _columns(c, n, me)
    shapes = []
    for i in range(n):
        a, b = _slab_range(total, n, i)
        shapes.append(_with(x.shape, s, ((cols >= a) & (cols < b)).sum()))
    return _all_to_all(parts, s, ax, shapes)


def to_storage(y, s: Optional[int], c: Split, ax: TensorAxis,
               out: torch.Tensor):
    """The inverse of ``to_compute``: ``y``'s storage piece into ``out``.
    A whole compute leaf (identical on every rank) is sliced; the whole
    segments of a ``Segmented`` one are taken from rank 0."""
    n, me = ax.size, ax.index
    if s == c:
        out.copy_(y)
    elif c is None:
        out.copy_(piece(y, s, n, me))
    elif isinstance(c, Segmented):
        _segmented_to_storage(y, s, c, ax, out)
    elif s is None:
        out.copy_(ax.all_gather_dim(y, c))
    else:
        _all_to_all([piece(y, s, n, j) for j in range(n)], c, ax, out=out)


def _segmented_to_storage(y, s, c: Segmented, ax: TensorAxis, out):
    """``to_storage`` of a segmented compute piece: every rank sends each
    rank the columns it owns (``_columns(..., own=True)``) of that rank's
    storage piece, which puts them in place by their global index."""
    n, me, d = ax.size, ax.index, c.dim
    total = sum(c.sizes)

    def plan(j, i):
        """(the positions in rank j's compute piece of the columns it owns
        that rank i stores, where rank i puts them)."""
        cols, own = _columns(c, n, j), _columns(c, n, j, own=True)
        lo, hi = _slab_range(total, n, i) if s == d else (0, total)
        keep = own[(own >= lo) & (own < hi)]
        return np.searchsorted(cols, keep), keep - lo

    parts = []
    for i in range(n):
        src = y if s is None or s == d else piece(y, s, n, i)
        parts.append(src.index_select(d, _index(plan(me, i)[0], y.device)))
    rank = lambda j: ax.mesh.rank_of(ax.axes, j)
    got = ax.mesh.exchange(
        {rank(j): [parts[j]] for j in range(n) if j != me},
        {rank(j): [(_with(parts[me].shape, d, len(plan(j, me)[1])), y.dtype)]
         for j in range(n) if j != me})
    for j in range(n):
        out.index_copy_(d, _index(plan(j, me)[1], out.device),
                        parts[me] if j == me else got[rank(j)][0])
