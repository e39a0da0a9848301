"""The rank mesh: FL replicas split over the ranks of a torch.distributed
world (the counterpart of ``repro/dist/compat.make_mesh`` and
``repro/launch/mesh.py``).

A ``RankMesh`` lays the world's ranks out row-major over named axes, as a
``jax.sharding.Mesh`` lays out devices: the last axis varies fastest.
Each rank knows its coordinate on every axis (``axis_index``) and each
axis's size (``axis_size``); the process groups of every axis and of
every axis tuple the collectives reduce over are built once, when the
mesh is made, never inside a round.  A 1-rank mesh builds nothing and
needs no process group.

The transport is the reference's collectives on ranks (its axis helpers
``_n_shards``, ``_flat_shard_index``, ``_axis_sizes`` are ``size``,
``flat_index``, ``axis_size`` here):
  ``ppermute`` / ``rotate``  jax.lax.ppermute: a (partial) permutation of
      the flat index over some axes, built on ``exchange``; a rank that
      is no destination gets zeros and posts no receive; a rotation of
      the flat index over several axes is one message a rank, the values
      of the reference's per-axis composition (``_rotate_flat``);
  ``psum``  an all_reduce over the axes' group;
  ``exchange``  one ``batch_isend_irecv`` of a message a peer, each
      message the given tensors packed into one byte buffer (16-byte
      aligned), unpacked as views on the receiving side;
  ``gather_to`` / ``scatter_from``  a tensor's bytes from every rank of
      some axes into host memory on one of them, and back: the launcher's
      checkpoints and cohort swaps, which must not put one rank's rows on
      another rank's card;
  ``broadcast_object``  a picklable host value from one rank to all.

Backends.  Where every rank of a host has a card of its own the backend
is NCCL and CUDA tensors go as they are (unverified: no machine with more
than one card has run it, ROADMAP.md item 5).  Otherwise it is gloo: NCCL
refuses two ranks on one card and gloo has no CUDA send or receive, so a
CUDA tensor is staged through a pinned host buffer for each message, both
ways, and for each all_reduce.  A failure of either backend raises;
nothing switches to the other.  ``stats`` counts each rank's calls,
messages sent, bytes sent and bytes staged (both directions), and the
host ms spent inside the transport calls (``ms``: the staging copies and
the waits for the peers included); ``counted(tag)`` also adds a body's
share to ``stats_by[tag]`` (the round step's "tensor" and "gossip").

``run_world`` starts an n-rank world, each rank building its mesh over a
``file://`` store and running a function, and joins every rank with a
timeout: a rank's failure or a timeout raises, after every rank has been
stopped.  The ranks are forked from the ``forkserver`` start method's
server, which imports the main module, torch, numpy and the port once
(``WORLD_PRELOAD``; for ranks on the card also ``CARD_PRELOAD``) and
serves every later world of the process: a rank starts without importing
them again, where a ``spawn``ed one would (about 8 s on the H100's host,
``tools/world_startup.py``).  Each rank keeps the wall-clock times of
its start-up in ``STARTUP`` (entered, the job read, the mesh made) for
``fn``.
"""
from __future__ import annotations

import atexit
import datetime
import itertools
import os
import pickle
import tempfile
import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0  # a collective's and a group's timeout: a dead rank
# fails its peers instead of hanging them
_ALIGN = 16


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh: every axis but "model"."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _layout(specs):
    """Byte offsets of (shape, dtype) specs packed in order, and the
    total."""
    offs, at = [], 0
    for shape, dtype in specs:
        offs.append(at)
        at += _padded(int(np.prod(shape, dtype=np.int64))
                      * torch.empty((), dtype=dtype).element_size())
    return offs, at


class RankMesh:
    """``shape`` over ``axis_names``, row-major over the world's ranks.

    ``rank`` / ``world`` are this process's place in the torch.distributed
    world (1-rank meshes need none); ``device`` where the rank's tensors
    live; ``staged``: CUDA tensors go through pinned host buffers (gloo)."""

    def __init__(self, shape, axis_names, *, rank: int = 0, world: int = 1,
                 device=None, backend: Optional[str] = None,
                 staged: bool = False, timeout_s: float = TIMEOUT_S):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} for axes "
                             f"{self.axis_names}")
        if int(np.prod(self.shape)) != world:
            raise ValueError(f"mesh {dict(zip(self.axis_names, self.shape))}"
                             f" holds {int(np.prod(self.shape))} ranks, the "
                             f"world {world}")
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device) if device is not None else \
            torch.device("cpu")
        self.backend, self.staged = backend, bool(staged)
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.shape))
        self._size = dict(zip(self.axis_names, self.shape))
        self.stats = {"calls": 0, "messages": 0, "bytes": 0,
                      "staged_bytes": 0, "ms": 0.0}
        self.stats_by: Dict[str, dict] = {}
        self._groups: Dict[tuple, object] = {}
        if self.world > 1:
            timeout = datetime.timedelta(seconds=timeout_s)
            made: Dict[tuple, object] = {}
            for r in range(1, len(self.axis_names) + 1):
                for axes in itertools.combinations(self.axis_names, r):
                    for ranks in self._group_ranks(axes):
                        if len(ranks) > 1 and len(ranks) < self.world \
                                and ranks not in made:
                            # every rank makes every group, in one order
                            made[ranks] = dist.new_group(list(ranks),
                                                         timeout=timeout)
                    mine = self._my_group_ranks(axes)
                    self._groups[axes] = (None if len(mine) == self.world
                                          else made.get(mine))

    def axis_size(self, axis: str) -> int:
        return self._size[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def size(self, axes) -> int:
        return int(np.prod([self.axis_size(a) for a in axes], initial=1))

    def flat_index(self, axes) -> int:
        """The reference's ``_flat_shard_index``: row-major over ``axes``
        in the order given."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + self.axis_index(a)
        return idx

    def rank_of(self, axes, flat: int) -> int:
        """The rank at flat index ``flat`` over ``axes``, this rank's
        coordinates on the other axes."""
        coords = list(self.coords)
        sub = np.unravel_index(int(flat), [self.axis_size(a) for a in axes])
        for a, c in zip(axes, sub):
            coords[self.axis_names.index(a)] = int(c)
        return int(np.ravel_multi_index(coords, self.shape))

    def _my_group_ranks(self, axes) -> tuple:
        return tuple(self.rank_of(axes, f) for f in range(self.size(axes)))

    def _group_ranks(self, axes):
        """Every group of ``axes``: one a coordinate of the other axes,
        each in flat order over ``axes``."""
        axes = tuple(axes)
        rest = [a for a in self.axis_names if a not in axes]
        out = []
        for fixed in itertools.product(*[range(self.axis_size(a))
                                         for a in rest]):
            coords = dict(zip(rest, fixed))
            ranks = []
            for sub in itertools.product(*[range(self.axis_size(a))
                                           for a in axes]):
                coords.update(zip(axes, sub))
                ranks.append(int(np.ravel_multi_index(
                    [coords[a] for a in self.axis_names], self.shape)))
            out.append(tuple(ranks))
        return out

    def group(self, axes):
        """The process group of ``axes`` (None: the whole world)."""
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            raise KeyError(f"no group for axes {axes!r} of {self.axis_names}")
        return self._groups[key]

    # -- the transport -----------------------------------------------------

    @contextlib.contextmanager
    def _timed(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats["ms"] += (time.perf_counter() - t0) * 1e3

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """t as the backend can send it: a pinned host copy of a CUDA
        tensor when staged."""
        if self.staged and t.is_cuda:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.stats["staged_bytes"] += _nbytes(t)
            return h
        return t

    def exchange(self, sends: Dict[int, Sequence[torch.Tensor]],
                 recvs: Dict[int, Sequence[Tuple[tuple, torch.dtype]]]
                 ) -> Dict[int, List[torch.Tensor]]:
        """One message to each rank of ``sends`` (its tensors packed) and
        one from each rank of ``recvs`` (the (shape, dtype) specs of the
        tensors it sends, in its order); returns {source rank: tensors on
        this rank's device}.  Both sides must agree on the specs."""
        with self._timed():
            return self._exchange(sends, recvs)

    def _exchange(self, sends, recvs):
        self.stats["calls"] += 1
        if self.rank in sends or self.rank in recvs:
            raise ValueError("exchange: a rank sends nothing to itself")
        ops, landing = [], {}
        for dst in sorted(sends):
            ts = [t.contiguous() for t in sends[dst]]
            offs, total = _layout([(tuple(t.shape), t.dtype) for t in ts])
            if len(ts) == 1 and _nbytes(ts[0]) == total:
                # one tensor fills the message: sent as its bytes, unpacked
                buf = ts[0].reshape(-1).view(torch.uint8)
            else:
                buf = torch.zeros(total, dtype=torch.uint8,
                                  device=self.device)
                for t, o in zip(ts, offs):
                    if t.numel():
                        buf[o:o + _nbytes(t)].copy_(t.reshape(-1).view(
                            torch.uint8))
            out = self._host(buf)
            ops.append(dist.P2POp(dist.isend, out, dst))
            self.stats["messages"] += 1
            self.stats["bytes"] += total
        for src in sorted(recvs):
            _, total = _layout(recvs[src])
            dev_buf = torch.empty(total, dtype=torch.uint8, device=self.device)
            buf = (torch.empty(total, dtype=torch.uint8, pin_memory=True)
                   if self.staged and dev_buf.is_cuda else dev_buf)
            landing[src] = (dev_buf, buf)
            ops.append(dist.P2POp(dist.irecv, buf, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        got = {}
        for src, (dev_buf, buf) in landing.items():
            if buf is not dev_buf:
                dev_buf.copy_(buf)
                self.stats["staged_bytes"] += buf.numel()
            offs, _ = _layout(recvs[src])
            views = []
            for (shape, dtype), o in zip(recvs[src], offs):
                n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
                    (), dtype=dtype).element_size()
                views.append(dev_buf[o:o + n].view(dtype).view(shape))
            got[src] = views
        return got

    def ppermute(self, tensors: Sequence[torch.Tensor], axes, perm):
        """``jax.lax.ppermute`` over the flat index of ``axes``: ``perm``
        a list of (source, destination) pairs; the tensors of this rank's
        source land here, zeros where this rank is no destination."""
        tensors = list(tensors)
        f, n = self.flat_index(axes), self.size(axes)
        dst = [d % n for s, d in perm if s % n == f]
        src = [s % n for s, d in perm if d % n == f]
        if src and src[0] == f:
            return tensors
        sends = {self.rank_of(axes, d): tensors for d in dst if d != f}
        recvs = {self.rank_of(axes, s): [(tuple(t.shape), t.dtype)
                                         for t in tensors] for s in src}
        got = self.exchange(sends, recvs)
        if src:
            return got[self.rank_of(axes, src[0])]
        return [torch.zeros_like(t) for t in tensors]

    def rotate(self, tensors: Sequence[torch.Tensor], axes, shift: int,
               src=None):
        """The value of flat shard (i - shift) mod n lands on shard i (the
        reference's ``_rotate`` / ``_rotate_flat``, one message a rank
        over the flat index of ``axes``).  ``src``: the source shards
        allowed to send (a partial permutation; the others' destinations
        get zeros).  A full rotation by 0 is the tensors themselves."""
        n = self.size(axes)
        if shift % n == 0 and src is None:
            return list(tensors)
        perm = [(j, (j + shift) % n) for j in range(n)
                if src is None or j in src]
        return self.ppermute(tensors, axes, perm)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """Sum of x over the ranks of ``axes`` (an all_reduce over their
        group), on every one of them; x is not written."""
        if self.size(axes) == 1:
            return x
        with self._timed():
            return self._psum(x, axes)

    def _psum(self, x, axes):
        self.stats["calls"] += 1
        buf = (self._host(x) if self.staged and x.is_cuda
               else x.contiguous().clone())
        dist.all_reduce(buf, group=self.group(axes))
        self.stats["bytes"] += _nbytes(buf)
        if buf.device != x.device:
            self.stats["staged_bytes"] += _nbytes(buf)
            return buf.to(x.device)
        return buf

    def all_gather(self, x: torch.Tensor, axes) -> torch.Tensor:
        """x of every rank of ``axes`` stacked on a new leading dim in
        flat order over ``axes`` (on every one of them)."""
        n = self.size(axes)
        if n == 1:
            return x[None]
        with self._timed():
            return self._all_gather(x, axes, n)

    def _all_gather(self, x, axes, n):
        self.stats["calls"] += 1
        h = self._host(x.contiguous())
        parts = [torch.empty_like(h) for _ in range(n)]
        dist.all_gather(parts, h, group=self.group(axes))
        self.stats["bytes"] += _nbytes(h) * (n - 1)
        out = torch.stack(parts)
        if out.device != x.device:
            self.stats["staged_bytes"] += _nbytes(out)
            out = out.to(x.device)
        return out

    def _bytes_on_host(self, x: torch.Tensor) -> torch.Tensor:
        """x's bytes as a flat uint8 host tensor (staged from the card)."""
        if x.is_cuda and not self.staged:
            raise NotImplementedError(
                "host gathers over NCCL are not ported yet (ROADMAP.md "
                "item 5.7): the gloo transport stages them")
        return self._host(x.contiguous()).view(-1).view(torch.uint8)

    def gather_to(self, x: torch.Tensor, axes, dst: int = 0):
        """x of every rank of ``axes`` stacked in flat order over ``axes``
        (a new leading dim) in host memory on the rank at flat index
        ``dst``, None on the others.  Every rank's x has one shape and
        type; its bytes go as they are, any type."""
        n = self.size(axes)
        if n == 1:
            return x.detach().to("cpu")[None].clone()
        with self._timed():
            self.stats["calls"] += 1
            h = self._bytes_on_host(x)
            root = self.rank_of(axes, dst)
            parts = ([torch.empty_like(h) for _ in range(n)]
                     if self.rank == root else None)
            dist.gather(h, parts, dst=root, group=self.group(axes))
            if self.rank != root:
                self.stats["bytes"] += _nbytes(h)
                return None
            return torch.stack(parts).view(x.dtype).view(
                (n,) + tuple(x.shape))

    def scatter_from(self, stacked, axes, like: torch.Tensor,
                     src: int = 0) -> torch.Tensor:
        """The inverse of ``gather_to``: ``stacked`` (n, *like.shape) on
        the rank at flat index ``src`` (None elsewhere); every rank gets
        its row in host memory (like ``like``'s shape and type)."""
        n = self.size(axes)
        if n == 1:
            return stacked[0]
        with self._timed():
            self.stats["calls"] += 1
            root = self.rank_of(axes, src)
            nb = _nbytes(like)
            out = torch.empty(nb, dtype=torch.uint8)
            parts = None
            if self.rank == root:
                flat = stacked.contiguous().view(n, -1).view(torch.uint8)
                parts = [flat[i] for i in range(n)]
                self.stats["bytes"] += nb * (n - 1)
            dist.scatter(out, parts, src=root, group=self.group(axes))
            return out.view(like.dtype).view(tuple(like.shape))

    def broadcast_object(self, obj, src: int = 0):
        """A picklable host value of world rank ``src`` on every rank."""
        if self.world == 1:
            return obj
        with self._timed():
            self.stats["calls"] += 1
            box = [obj if self.rank == src else None]
            dist.broadcast_object_list(box, src=src)
            return box[0]

    def barrier(self):
        if self.world > 1:
            with self._timed():
                dist.barrier()

    @contextlib.contextmanager
    def counted(self, tag: str):
        """What the body adds to ``stats``, also added to
        ``stats_by[tag]``."""
        before = dict(self.stats)
        try:
            yield
        finally:
            acc = self.stats_by.setdefault(tag, dict.fromkeys(self.stats, 0))
            for k, v in self.stats.items():
                acc[k] += v - before[k]

    def reset_stats(self):
        for k in self.stats:
            self.stats[k] = 0
        self.stats_by.clear()


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def init_rank_mesh(shape, axes, *, backend: Optional[str] = None,
                   init_method: Optional[str] = None, rank=None, world=None,
                   local_rank=None, device=None,
                   timeout_s: float = TIMEOUT_S) -> RankMesh:
    """The mesh over this process's world: ``rank`` / ``world`` /
    ``local_rank`` as given, else ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` as torchrun sets them (unset: a 1-rank world, no
    process group).  ``init_method``: e.g. ``file:///dir/store`` (the
    tests), else ``env://`` (torchrun's MASTER_ADDR / MASTER_PORT).

    The rank's device is ``cuda:LOCAL_RANK % device_count`` unless
    ``device`` is given (``"cpu"`` for the tests); without a card and
    without ``device`` it raises.  ``backend`` (default): NCCL where each
    rank of the host has a card of its own (``LOCAL_WORLD_SIZE`` <=
    device_count), else gloo, CUDA tensors staged through pinned host
    buffers; the CPU is always gloo."""
    world = _env_int("WORLD_SIZE", 1) if world is None else int(world)
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    local_rank = (_env_int("LOCAL_RANK", rank) if local_rank is None
                  else int(local_rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the rank; pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and local_world <= torch.cuda.device_count() else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r} not in ('nccl', 'gloo')")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    staged = backend == "gloo" and dev.type == "cuda"
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method or "env://", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    return RankMesh(shape, axes, rank=rank, world=world, device=dev,
                    backend=backend if world > 1 else None, staged=staged,
                    timeout_s=timeout_s)


def describe(mesh: RankMesh) -> str:
    """The transport in words, for a launcher's first line."""
    if mesh.world == 1:
        return "1 rank, no process group"
    how = ("CUDA tensors staged through pinned host buffers" if mesh.staged
           else "tensors sent where they lie")
    return f"{mesh.world} ranks over {mesh.backend} ({how})"


# ---------------------------------------------------------------------------
# spawned worlds (tests, chip_smoke.py)
# ---------------------------------------------------------------------------

# the modules the forkserver's server imports once for every world's ranks
WORLD_PRELOAD = ("__main__", "numpy", "torch", "repro_torch.launch.train")
# and for ranks on the card: torch's compile stack, which a CUDA rank's
# first round imports (sympy, torch.distributed's tensor modules, triton:
# about 9 s a process on the H100's host, tools/world_startup.py)
CARD_PRELOAD = ("torch._dynamo",)
STARTUP: Dict[str, float] = {}  # a rank's start-up, time.time() stamps
_SERVER_STOP: list = []  # the atexit stop, once registered


def _world_child(rank, world, job, shape, axes, store, out_dir, device,
                 threads, env):
    STARTUP.clear()
    STARTUP["entry"] = time.time()
    os.environ.update(env)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    with open(job, "rb") as f:
        fn, args = pickle.load(f)
    STARTUP["job"] = time.time()
    mesh = init_rank_mesh(shape, axes, init_method=f"file://{store}",
                          device=device)
    STARTUP["mesh"] = time.time()
    try:
        out = fn(mesh, *args)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def start_world_server(device=None):
    """Starts the forkserver's server (where this process has none) with
    ``WORLD_PRELOAD`` and, for ranks on the card (``device`` None or CUDA),
    ``CARD_PRELOAD``; it imports them while the caller goes on, and the
    first world waits for it.  ``run_world`` calls it; a caller with work
    to do first may call it earlier."""
    import multiprocessing as mp
    from multiprocessing import forkserver
    card = device is None or torch.device(device).type == "cuda"
    mp.get_context("forkserver").set_forkserver_preload(
        list(WORLD_PRELOAD) + list(CARD_PRELOAD if card else ()))
    if not _SERVER_STOP:
        _SERVER_STOP.append(atexit.register(stop_world_server))
    forkserver.ensure_running()


def stop_world_server():
    """Stops the forkserver's server, if this process started one (at
    exit: the server outlives nothing that started it)."""
    from multiprocessing import forkserver
    forkserver._forkserver._stop()


def run_world(fn, world: int, *args, shape=None, axes=("data", "model"),
              device=None, timeout_s: float = 300.0, threads: int = 1,
              root=None, env=None) -> list:
    """Runs ``fn(mesh, *args)`` on each rank of a ``world``-rank world
    (processes forked by the ``forkserver`` start method's server; ``fn``
    and ``args`` picklable, ``fn`` a module-level function) over a mesh of
    ``shape`` (default (world, 1)) on ``axes``, and returns the ranks'
    return values (pickled through files under ``root`` or a temporary
    directory).  Each rank pins torch to ``threads`` threads.  A rank's
    non-zero exit or the timeout stops every rank and raises."""
    import multiprocessing as mp
    shape = (world, 1) if shape is None else tuple(shape)
    start_world_server(device)
    ctx = mp.get_context("forkserver")
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        store = Path(tmp) / "store"
        # the function and its arguments go through a file: a start()
        # that pipes a large argument waits for that child's imports
        job = Path(tmp) / "job.pkl"
        with open(job, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_world_child, args=(
            r, world, str(job), shape, tuple(axes), str(store), tmp, device,
            threads, dict(env or {})), daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [(r, p.exitcode) for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
                    break
                if time.monotonic() > deadline:
                    failed = f"the world did not end in {timeout_s:.0f} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
        if failed is None:
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode != 0]
            if bad:
                failed = f"rank {bad[0][0]} exited with {bad[0][1]}"
        if failed is not None:
            raise RuntimeError(f"{world}-rank world: {failed}")
        out = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
