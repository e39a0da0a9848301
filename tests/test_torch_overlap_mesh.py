"""The port's overlapped round engine with its FL replicas split over the
ranks of a gloo world, against the JAX package's ``make_overlap_round_step``
under shard_map on its fake CPU devices, on the CPU.

The smoke smollm (f32, one layer, d_model 64, d_ff 128), tau = q = 2,
tests/test_overlap.py's three layouts, all in one 4-rank world
(``dist.mesh.run_world``, spawned once for the module):
  A: C 2 x Dev 2 on the 4 ranks of ("data", "model") = (4, 1): one row a
     rank, a cluster spanning 2 ranks;
  B: C 4 x Dev 1 on the 2 "data" ranks of each pod of ("pod", "data") =
     (2, 2): 2 whole clusters a rank (each pod runs it alone);
  multi: C 2 x Dev 2 over ("pod", "data") = (2, 2), the multi-axis
     replica dims (the wire at the largest level, as the reference).
Each layout starts from one seeded state (seeded parameters moved by a
different offset in each cluster, ``pending`` by another: cluster-uniform
rows, as after a round) and runs one gossip round a case from it:
staleness 1 with every cluster stale
(the sparse wire's payloads encoded ahead, ``stale_payloads(mesh=)``)
and with the partial set {0}, on the dense fold and on the int8 wire at
per-cluster levels; in B also every cluster stale under a backhaul cut
(``conn``); the reference runs the same rounds on a mesh of the same
shape (``jax.jit`` at XLA level 0, ``test_torch_round.FAST_COMPILE``).
Staleness 0 is held bit for bit to the synchronous step on the same
ranks, and ``sparse_exchange_(stale=)`` / ``(payloads=)`` and
``sparse_neighbor_exchange(stale=)`` across ranks bit for bit to the
one-process calls in A and B.  The masked-step bits are the reference's;
the wire runs ``impl="ref"``.  Tolerances: tests/test_torch_overlap.py's
(loss 1e-5 relative; the state within atol 1e-4 / rtol 1e-3 but for
FLIP_SHARE of each field's entries).
"""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import RankMesh, run_world

# the ranks import this module: nothing of JAX at its top
pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the reference needs jax")

TAU, SEQ, WORLD = 2, 33, 4
HCEF = dict(tau=TAU, q=2, eta=0.1, momentum=0.9)
SPARSE = dict(sparse_gossip=True, wire_dtype="int8",
              theta_levels=(0.1, 0.6, 1.0))
RHO = np.array([0.9, 0.7, 1.0, 0.8])
THETA = np.array([0.1, 0.1, 0.4, 0.6])
LOSS_RTOL = 1e-5
STATE_TOL = dict(atol=1e-4, rtol=1e-3)  # test_torch_overlap.STATE_TOL
FLIP_SHARE = 1e-4                       # test_torch_overlap.FLIP_SHARE
FIELDS = ("params", "momentum", "ef")
# layout: (C, Dev, the reference's mesh shape and axes, the replica axes,
# the sparse wire's cluster levels)
LAYOUTS = {
    "A": (2, 2, (4, 1), ("data", "model"), ("data",), (0.1, 0.6)),
    "B": (4, 1, (2, 1), ("data", "model"), ("data",),
          (0.1, 0.6, 1.0, 0.6)),
    "multi": (2, 2, (2, 2, 1), ("pod", "data", "model"), ("pod", "data"),
              (0.1, 0.6)),
}
# (layout, fold, stale set or None for all, backhaul mask or None)
CASES = [(lay, fold, st, None) for lay in ("A", "B")
         for fold in ("dense", "sparse") for st in (None, (0,))]
CASES += [("B", "sparse", None, (1.0, 0.0, 1.0, 1.0)),
          ("multi", "sparse", None, None)]


def _name(case):
    lay, fold, st, conn = case
    return (f"{lay}-{fold}-{'all' if st is None else 'set0'}"
            + ("-conn" if conn is not None else ""))


def _tokens(rnd):
    return np.random.default_rng(40 + rnd).integers(0, 257, (4 * TAU * 2,
                                                             SEQ))


def _configs():
    """(the port's config, HCEFConfig kwargs of a fold)."""
    from repro_torch.configs import get_config, smoke_model
    cfg = smoke_model(get_config("smollm_135m").model).replace(
        num_layers=1, d_model=64, d_ff=128)
    return cfg


def _hcef_kw(fold, staleness=1):
    return dict(HCEF, overlap=True, staleness=staleness,
                **(SPARSE if fold == "sparse" else {}))


def _meshes(mesh):
    pd = RankMesh((2, 2), ("pod", "data"), rank=mesh.rank, world=mesh.world,
                  device=mesh.device, backend=mesh.backend)
    return {"A": (mesh, ("data",)), "B": (pd, ("data",)),
            "multi": (pd, ("pod", "data"))}


def initial_state(lay):
    """A layout's state as numpy trees of (R, ...) leaves: ``params``,
    ``pending`` (each cluster's rows alike), zero ``momentum`` and
    ``ef``."""
    from repro_torch.models import lm
    from repro_torch.tree import tree_map
    C, Dev = LAYOUTS[lay][:2]
    rng = np.random.default_rng(11)
    params0 = tree_map(lambda t: t.numpy(), lm.init(
        _configs(), torch.Generator().manual_seed(0), device="cpu"))

    def moved(x):
        off = 0.02 * rng.standard_normal((C, 1) + x.shape).astype(x.dtype)
        return np.repeat(x[None] + off, Dev, axis=0).reshape(
            (C * Dev,) + x.shape)
    params = tree_map(moved, params0)
    pending = tree_map(lambda x: moved(x[0]), params)
    zeros = tree_map(np.zeros_like, params)
    return {"params": params, "pending": pending, "momentum": zeros,
            "ef": zeros}


def _np_fields(state):
    from repro_torch.tree import flatten
    out = {f: {k: v.numpy().copy() for k, v in
               flatten(getattr(state.fl, f)).items()} for f in FIELDS}
    out["pending"] = {k: v.numpy().copy()
                      for k, v in flatten(state.pending).items()}
    return out


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rounds_on_rank(m, axes, lay, init, bits):
    """Each case's gossip round and the staleness-0 and synchronous steps
    from ``init`` (``initial_state``), on this rank of ``m``."""
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.convert import params_from_jax, shard_rows
    from repro_torch.core import round as tround
    from repro_torch.dist.policies import make_train_policy
    from repro_torch.tree import tree_map
    C, Dev, _, _, _, levels = LAYOUTS[lay]
    topo = FLTopology(C, Dev)
    cfg = _configs()
    policy = make_train_policy(m, topo, dp_axes=axes)
    bits_fn = lambda key, rho: bits  # noqa: E731
    batch = lambda rnd: {"tokens": torch.from_numpy(_tokens(rnd))}  # noqa
    rows = {k: shard_rows(params_from_jax(v, "cpu"), m, axes)
            for k, v in init.items()}
    state0 = tround.OverlapState(fl=tround.FLState(
        params=rows["params"], momentum=rows["momentum"], ef=rows["ef"],
        round_idx=1), pending=rows["pending"])

    def copy(st):
        return tround.OverlapState(
            fl=st.fl._replace(**{f: tree_map(torch.clone, getattr(st.fl, f))
                                 for f in FIELDS}),
            pending=tree_map(torch.clone, st.pending))

    out = {"first": policy.first_replica}
    for case in CASES:
        c_lay, fold, st, conn = case
        if c_lay != lay:
            continue
        step = tround.make_overlap_round_step(
            cfg, HCEFConfig(**_hcef_kw(fold)), topo, policy, gossip=True,
            impl="ref", stale_clusters=st, bits_fn=bits_fn,
            cluster_levels=levels if fold == "sparse" else None)
        state, mt = step(copy(state0), batch(1), RHO, THETA, 1001,
                         conn=None if conn is None
                         else np.asarray(conn, np.float32))
        out[_name(case)] = ({k: v.numpy() for k, v in mt.items()},
                            _np_fields(state))
    # staleness 0 against the synchronous step, on these ranks
    sync = tround.make_round_step(
        cfg, HCEFConfig(**HCEF, **SPARSE), topo, policy, gossip=True,
        impl="ref", cluster_levels=levels, bits_fn=bits_fn)
    over = tround.make_overlap_round_step(
        cfg, HCEFConfig(**_hcef_kw("sparse", staleness=0)), topo, policy,
        gossip=True, impl="ref", cluster_levels=levels, bits_fn=bits_fn)
    a = copy(state0)
    fl, ms = sync(a.fl, batch(1), RHO, THETA, 1001)
    b, mo = over(copy(state0), batch(1), RHO, THETA, 1001)
    out["staleness0"] = (
        all(torch.equal(ms[k], mo[k]) for k in ms) and "stale_frac" not in mo,
        _np_fields(tround.OverlapState(fl=fl, pending=fl.params)),
        _np_fields(b))
    return out


def _exchange_rows(C, Dev, seed):
    x = np.random.default_rng(seed).standard_normal((C, 2500))
    return torch.from_numpy(np.repeat(x, Dev, axis=0).astype(np.float32))


EXCHANGE = [(lay, wd, op) for lay in ("A", "B") for wd in ("int8", "int4")
            for op in ("stale", "set0", "payloads", "neighbor")]


def _exchange(lay, wd, op, mesh=None, axes=()):
    """One stale gossip of EXCHANGE on rows of 2500 columns in chunks of
    1024 (this rank's rows with ``mesh``; all with None)."""
    from repro_torch.dist import collectives as tcol
    C, Dev, _, _, _, levels = LAYOUTS[lay]
    x, s = _exchange_rows(C, Dev, 1), _exchange_rows(C, Dev, 2)
    kw = dict(clusters=C, dev=Dev, hkind="ring", wire_dtype=wd,
              cluster_theta=levels, impl="ref")
    mkw = {}
    if mesh is not None:
        n, f = mesh.size(axes), mesh.flat_index(axes)
        r = C * Dev // n
        x, s = x[f * r:(f + 1) * r].clone(), s[f * r:(f + 1) * r].clone()
        mkw = dict(mesh=mesh, axes=axes)
    if op == "neighbor":
        return tcol.sparse_neighbor_exchange(
            x, intra_done=True, stale=s, stale_clusters=(1,), **kw, **mkw)
    kw["chunk_cols"] = 1024
    if op == "payloads":
        tcol.sparse_exchange_(x, payloads=tcol.stale_payloads(s, **kw, **mkw),
                              **kw, **mkw)
    else:
        tcol.sparse_exchange_(x, stale=s, stale_clusters=(
            range(C) if op == "stale" else (0,)), **kw, **mkw)
    return x


def port_world(mesh, inits, bits):
    """Every layout's rounds and every EXCHANGE case on this rank."""
    meshes = _meshes(mesh)
    out = {lay: _rounds_on_rank(*meshes[lay], lay, inits[lay], bits)
           for lay in LAYOUTS}
    out["exchange"] = {}
    for lay, wd, op in EXCHANGE:
        m, axes = meshes[lay]
        out["exchange"][(lay, wd, op)] = (m.flat_index(axes),
                                          _exchange(lay, wd, op, m, axes))
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def _leaves(tree):
    import jax
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference(inits):
    """{case name: (metrics, fields)} of the reference's rounds."""
    import jax
    import jax.numpy as jnp
    from test_torch_round import FAST_COMPILE, _jit

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import FLTopology as JTopo
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    jcfg = j_smoke(j_get_config("smollm_135m").model).replace(
        num_layers=1, d_model=64, d_ff=128)
    out = {}
    for lay, (C, Dev, shape, axes, dp, levels) in LAYOUTS.items():
        jtopo = JTopo(clusters=C, devices_per_cluster=Dev)
        R = C * Dev
        mesh = make_mesh(shape, axes)
        policy = j_policy(mesh, jtopo, dp_axes=dp)
        init = jax.tree.map(jnp.asarray, inits[lay])
        state0 = jround.OverlapState(fl=jround.FLState(
            params=init["params"], momentum=init["momentum"], ef=init["ef"],
            round_idx=jnp.ones((), jnp.int32)), pending=init["pending"])

        def args(rnd):
            return ({"tokens": jnp.asarray(_tokens(rnd))},
                    jnp.asarray(RHO, jnp.float32),
                    jnp.asarray(THETA, jnp.float32),
                    jax.random.split(jax.random.PRNGKey(1000 + rnd), R))

        for case in CASES:
            c_lay, fold, st, conn = case
            if c_lay != lay:
                continue
            step = _jit(jround.make_overlap_round_step(
                jcfg, JHCEF(**_hcef_kw(fold)), jtopo, policy, gossip=True,
                impl="ref", stale_clusters=st,
                cluster_levels=levels if fold == "sparse" else None),
                FAST_COMPILE)
            extra = ()
            if conn is not None:
                extra = (jnp.ones(R, jnp.float32), jnp.ones(R, jnp.float32),
                         jnp.asarray(conn, jnp.float32))
            with mesh:
                s, mt = step(state0, *args(1), *extra)
            fields = {f: _leaves(getattr(s.fl, f)) for f in FIELDS}
            fields["pending"] = _leaves(s.pending)
            out[_name(case)] = (jax.tree.map(np.asarray, dict(mt)), fields)
    return out




@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's cases, the ranks' results): the world runs in a
    thread while the reference compiles."""
    import threading
    from test_torch_round import jax_bits
    torch.set_num_threads(1)
    inits = {lay: initial_state(lay) for lay in LAYOUTS}
    bits = jax_bits(TAU, 4)(1001, RHO)  # the reference's, at R 4
    got = {}

    def world():
        try:
            got["ranks"] = run_world(port_world, WORLD, inits, bits,
                                     device="cpu", timeout_s=240,
                                     root=tmp_path_factory.mktemp("world"))
        except BaseException as e:  # raised below
            got["ranks"] = e

    t = threading.Thread(target=world)
    t.start()
    want = reference(inits)
    t.join()
    if isinstance(got["ranks"], BaseException):
        raise got["ranks"]
    return want, got["ranks"]


def _gathered(ranks, lay, key):
    """The ranks' results of a layout's case, rows concatenated in replica
    order (B's two pods: each pod's, checked equal)."""
    parts = {}
    for r in ranks:
        first = r[lay]["first"]
        got = r[lay][key]
        if first in parts:  # B: the other pod, the same rows
            for f, leaves in got[1].items():
                for k, v in leaves.items():
                    assert np.array_equal(v, parts[first][1][f][k]), (f, k)
            continue
        parts[first] = got
    order = [parts[k] for k in sorted(parts)]
    fields = {f: {k: np.concatenate([p[1][f][k] for p in order])
                  for k in order[0][1][f]} for f in order[0][1]}
    return order[0][0], fields


@pytest.mark.parametrize("case", CASES, ids=[_name(c) for c in CASES])
def test_stale_round_on_ranks_matches_reference(runs, case):
    want, ranks = runs
    name = _name(case)
    jm, jf = want[name]
    tm, tf = _gathered(ranks, case[0], name)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=LOSS_RTOL)
    stale = case[2]
    C = LAYOUTS[case[0]][0]
    assert float(tm["stale_frac"]) == float(jm["stale_frac"]) == (
        1.0 if stale is None else len(stale) / C)
    if "theta_wire" in jm:
        assert float(tm["theta_wire"]) == float(jm["theta_wire"])
    for f, leaves in jf.items():
        assert set(tf[f]) == set(leaves), f
        off = size = 0
        for k, w in leaves.items():
            off += int((~np.isclose(tf[f][k], w, **STATE_TOL)).sum())
            size += w.size
        assert off <= FLIP_SHARE * size, (name, f, off, size)
    for k, v in tf["params"].items():  # pending is the new model
        assert np.array_equal(v, tf["pending"][k]), k


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_staleness0_is_the_synchronous_step_on_ranks(runs, layout):
    _, ranks = runs
    for r in ranks:
        metrics_equal, sync, over = r[layout]["staleness0"]
        assert metrics_equal
        for f in FIELDS:
            for k, v in sync[f].items():
                assert np.array_equal(v, over[f][k]), (f, k)
        for k, v in over["params"].items():
            assert np.array_equal(v, over["pending"][k]), k


@pytest.mark.parametrize("lay,wd,op", EXCHANGE)
def test_stale_exchange_on_ranks_is_the_one_process_call(runs, lay, wd, op):
    _, ranks = runs
    C, Dev = LAYOUTS[lay][:2]
    want = _exchange(lay, wd, op)
    n = {"A": 4, "B": 2}[lay]
    rows = C * Dev // n
    for r in ranks:
        f, got = r["exchange"][(lay, wd, op)]
        assert torch.equal(got, want[f * rows:(f + 1) * rows]), (lay, wd, op)
