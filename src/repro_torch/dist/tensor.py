"""The tensor ("model") axis of a rank mesh as a model's layers see it
(the counterpart of the reference's activation constraints,
``repro/dist/policies.py:Policy.act``, :104-148, which GSPMD lowers to
collectives; here they are written out).

``TensorAxis`` holds the axis's ranks and four autograd Functions over
``RankMesh.psum`` / ``all_gather`` on its group:
  ``copy``     identity forward, psum of the gradient backward: a
               replicated activation entering a split computation;
  ``reduce``   psum forward, identity backward: a split computation's
               partial sums leaving it, replicated;
  ``gather``   a split dim all-gathered forward, the rank's slice of the
               gradient backward;
  ``scatter``  the rank's slice of a replicated dim forward, the gradient
               all-gathered backward.
A gloo collective blocks and is not autograd-aware: these Functions carry
the gradients, and every rank of the axis issues them in one order.  The
forward psum is an operator of its own (``repro_torch::axis_psum``), so
that a layer recomputed under ``torch.utils.checkpoint`` takes its saved
result (``checkpoint_context``, a selective checkpoint) instead of
issuing the collective again: a checkpointed layer's psums run once in
the forward and once in the backward.

``to_compute`` / ``to_storage`` move one leaf between its storage piece
(split on the policy's ``leaf_split`` dim) and its compute piece (split
where the model computes it, or whole): the same dim is a copy, a whole
compute leaf is gathered forward and sliced back, and another split dim
is one all-to-all over the axis (``RankMesh.exchange``, one message a
peer).  The round step runs them once a round a replica, not once a step.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

_AXES: Dict[int, "TensorAxis"] = {}  # the axes the psum operator serves


def piece(x, dim: Optional[int], n: int, i: int):
    """Rank i's 1 / n of x's dim ``dim`` (x itself where dim is None or n
    is 1), a view."""
    if dim is None or n == 1:
        return x
    m = x.shape[dim] // n
    return x.narrow(dim, i * m, m)


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


def _save_psums(ctx, op, *args, **kwargs):
    """Keep every axis psum's output through a checkpointed layer,
    recompute the rest."""
    if op is torch.ops.repro_torch.axis_psum.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


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
        return self.mesh.all_gather(x.detach(), self.axes).amax(dim=0)

    def copy(self, x):
        return _Copy.apply(x, self)

    def reduce(self, x):
        return torch.ops.repro_torch.axis_psum(x, self.id)

    def gather(self, x, dim: int):
        return _Gather.apply(x, self, dim)

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


def _all_to_all(x, split: int, cat: int, ax: TensorAxis):
    """x cut into ``ax.size`` pieces on ``split``, piece j to rank j; the
    pieces every rank sent here concatenated on ``cat`` in rank order."""
    n, me = ax.size, ax.index
    parts = [ax.piece(x, split, j) for j in range(n)]
    spec = [(tuple(parts[0].shape), x.dtype)]
    rank = lambda j: ax.mesh.rank_of(ax.axes, j)
    got = ax.mesh.exchange({rank(j): [parts[j]] for j in range(n) if j != me},
                           {rank(j): spec for j in range(n) if j != me})
    return torch.cat([parts[j] if j == me else got[rank(j)][0]
                      for j in range(n)], dim=cat)


def to_compute(x, s: Optional[int], c: Optional[int], ax: TensorAxis):
    """A leaf's compute piece (split on ``c``, or whole where c is None)
    from its storage piece ``x`` (split on ``s``, or whole), as a new
    tensor; dims are x's."""
    if s == c:
        return x.clone()
    if s is None:
        return ax.piece(x, c).clone()
    if c is None:
        return ax.all_gather_dim(x, s)
    return _all_to_all(x, c, s, ax)


def to_storage(y, s: Optional[int], c: Optional[int], ax: TensorAxis,
               out: torch.Tensor):
    """The inverse of ``to_compute``: ``y``'s storage piece into ``out``.
    A whole compute leaf (identical on every rank) is sliced."""
    if s == c:
        out.copy_(y)
    elif c is None:
        out.copy_(ax.piece(y, s))
    elif s is None:
        out.copy_(ax.all_gather_dim(y, c))
    else:
        out.copy_(_all_to_all(y, s, c, ax))
