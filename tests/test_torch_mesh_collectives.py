"""The port's collectives across ranks (``dist/mesh.py``, the ``axes=`` /
``mesh=`` paths of ``dist/collectives.py``) against the JAX package's
shard_map on its 8 fake CPU devices.

One 8-rank gloo world (a ``file://`` store under ``tmp_path``, spawned
once for the module) runs every case on two meshes over its ranks: (8,)
on ("data",) and (4, 2) on ("pod", "data"); each rank returns its rows.
The cases mirror tests/test_collectives.py: ``mix_local`` in layouts A
and B over (C, Dev, backhaul) and the multi-axis psum fallback (:36,
:58); the sparse exchange at full k, clustered and small k (:73, :86,
:98), at full theta on the f32 wire on both meshes (:135), the lossy v1
wires (:164), the misaligned multi-axis fallback (:223) and intra_done
rows (:241); per-cluster levels, the all-ones dense fallback, mixed
levels on layouts A and B, per-row plans, the low-level contraction
(:345-:414), also on the int4 wire; the masks, all-alive and partial
(:576, :609); the CHOCO wire error feedback; and the transport's own
zero-fill for a partial permutation.

Inputs come from numpy generators seeded by each case's name, in the
ranks and here alike.  The int4 wire runs ``impl="ref"`` (the exact
top-k, the reference's CPU route).  Tolerances: the reference's (1e-5
against the dense W); against the reference's own rows 1e-6 of the rows'
max, and bit for bit where its tests pin it (full theta f32 against the
dense mix on one axis, not ``complete``; the all-ones levels) and where
the sums run in the one-process order: every layout-B case is also held
bit for bit to the port's one-process result.
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.dist import collectives as tcol
from repro_torch.dist.mesh import RankMesh, run_world

MESHES = {"8": ((8,), ("data",)), "4x2": ((4, 2), ("pod", "data"))}
SHAPES = [(4, 2), (8, 1), (2, 4), (1, 8), (8, 2), (4, 4), (16, 1)]
WIRE_SHAPES = [(4, 2), (8, 1), (2, 4), (8, 2), (4, 4), (16, 1)]
HKINDS = ["ring", "complete", "erdos_renyi", "none"]
HETERO = [(4, 2, (0.1, 1.0, 0.25, 1.0)), (8, 1, (0.1,) * 4 + (1.0,) * 4),
          (2, 4, (0.1, 1.0)), (16, 1, (0.1, 0.1, 1.0, 1.0) * 4)]


def _case(name, mesh, op, C, Dev, L, **kw):
    return name, dict(mesh=mesh, op=op, C=C, Dev=Dev, L=L, **kw)


def _cases():
    out = []
    for C, Dev in SHAPES:
        for h in HKINDS:
            out.append(_case(f"mix-{C}x{Dev}-{h}", "8", "mix", C, Dev, 48,
                             hkind=h))
    out.append(_case("mix-multiaxis", "4x2", "mix", 4, 2, 32,
                     hkind="ring"))
    out += [_case("k-full", "8", "sparse", 8, 1, 64, kw=dict(k=64)),
            _case("k-clustered", "8", "sparse", 4, 2, 64, kw=dict(k=64)),
            _case("k-small", "8", "sparse", 8, 1, 64, kw=dict(k=16))]
    for m in MESHES:
        for C, Dev in WIRE_SHAPES:
            for h in ("ring", "complete", "erdos_renyi"):
                out.append(_case(f"full-{m}-{C}x{Dev}-{h}", m, "sparse", C,
                                 Dev, 96, hkind=h, dense_too=True,
                                 kw=dict(theta=1.0, wire_dtype="f32")))
    for wd in ("f32", "bf16", "int8"):
        out.append(_case(f"dtype-{wd}", "8", "sparse", 4, 2, 64,
                         seed="dtype", kw=dict(theta=1.0, wire_dtype=wd)))
    out.append(_case("misaligned", "4x2", "sparse", 2, 4, 64,
                     kw=dict(theta=1.0, wire_dtype="f32")))
    for done in (False, True):
        out.append(_case(f"intra-{done}", "8", "sparse", 4, 2, 64,
                         pre=done, seed="intra", kw=dict(theta=0.25)))
    for C, Dev in [(4, 2), (8, 1), (2, 4)]:
        out.append(_case(f"ones-{C}x{Dev}", "8", "sparse", C, Dev, 96,
                         dense_too=True, kw=dict(cluster_theta=(1.0,) * C)))
    for wd in ("f32", "int4"):
        for C, Dev, lv in HETERO:
            out.append(_case(f"hetero-{wd}-{C}x{Dev}", "8", "sparse", C, Dev,
                             96, kw=dict(cluster_theta=lv, wire_dtype=wd)))
        out.append(_case(f"per-row-{wd}", "8", "sparse", 16, 1, 96,
                         kw=dict(cluster_theta=(0.1, 1.0) * 8,
                                 wire_dtype=wd)))
        out.append(_case(f"hetero-multiaxis-{wd}", "4x2", "sparse", 8, 2, 96,
                         kw=dict(cluster_theta=(0.1, 1.0) * 4,
                                 wire_dtype=wd)))
    out.append(_case("low-mixed", "8", "sparse", 8, 1, 64,
                     kw=dict(cluster_theta=(0.1, 1.0) * 4)))
    out.append(_case("low-all", "8", "sparse", 8, 1, 64,
                     kw=dict(theta=0.1)))
    for ct in (None, (0.1, 0.3, 0.2, 0.3)):
        out.append(_case(f"alive-ones-{ct is not None}", "8", "sparse", 4, 2,
                         64, masks="ones", dense_too=False,
                         kw=dict(cluster_theta=ct or (0.25,) * 4)))
    for C, Dev in [(4, 2), (2, 4), (8, 1)]:
        for h in ("ring", "complete", "none"):
            out.append(_case(f"partial-{C}x{Dev}-{h}", "8", "mix", C, Dev, 33,
                             hkind=h, masks="partial"))
    for C, Dev in [(16, 1), (2, 4), (8, 2)]:
        for wd in ("f32", "int4"):
            out.append(_case(f"ef-{wd}-{C}x{Dev}", "8", "sparse", C, Dev, 80,
                             ef=True, kw=dict(theta=0.25, wire_dtype=wd)))
    out.append(_case("conn-int4", "8", "sparse", 8, 2, 80, masks="conn",
                     kw=dict(cluster_theta=(0.1, 0.25) * 4,
                             wire_dtype="int4")))
    return out


CASES = dict(_cases())


def _seed(name):
    return zlib.crc32(name.encode())


def inputs(name, case):
    """(x (R, L) f32, alive weights or None, conn or None, the wire-EF
    estimates or None), seeded by the case's name (or its ``seed``)."""
    rng = np.random.default_rng(_seed(case.get("seed", name)))
    C, Dev, L = case["C"], case["Dev"], case["L"]
    R = C * Dev
    x = rng.standard_normal((R, L)).astype(np.float32)
    alive = conn = ef = None
    if case.get("masks") == "ones":
        alive, conn = np.ones(R, np.float32), np.ones(C, np.float32)
    elif case.get("masks") == "partial":
        a = (rng.random(R) > 0.4).astype(np.float64)
        a[0] = 1.0
        alive = tcol.participation_weights(a, clusters=C, dev=Dev)
        conn = (rng.random(C) > 0.4).astype(np.float32)
        if case["hkind"] == "none":
            conn = None
    elif case.get("masks") == "conn":
        conn = np.ones(C, np.float32)
        conn[[1, 4]] = 0.0
    if case.get("ef"):
        ef = tuple(np.repeat(rng.standard_normal((C, L)).astype(
            np.float32), Dev, axis=0) for _ in range(2))
    return x, alive, conn, ef


def _kw(case):
    kw = dict(case.get("kw", {}))
    if kw.get("wire_dtype") == "int4":
        kw["impl"] = "ref"
    return kw


def port_case(mesh, axes, name, case):
    """One case on this rank's rows: (rows, [dense mix rows], [est
    rows])."""
    C, Dev = case["C"], case["Dev"]
    x, alive, conn, ef = inputs(name, case)
    n = mesh.size(axes)
    Rl = x.shape[0] // n
    sl = slice(mesh.flat_index(axes) * Rl, (mesh.flat_index(axes) + 1) * Rl)
    mine = torch.from_numpy(x[sl].copy())
    hk = case.get("hkind", "ring")
    aw = None if alive is None else alive[sl]
    if case["op"] == "mix":
        y = tcol.mix_local(mine, clusters=C, dev=Dev, axes=axes, mesh=mesh,
                           hkind=hk, alive=aw, conn=conn)
        return (y.numpy(),)
    kw = _kw(case)
    intra = bool(case.get("pre") or case.get("ef"))
    if intra:
        mine = tcol.mix_local(mine, clusters=C, dev=Dev, axes=axes,
                              mesh=mesh, hkind="none")
    wef = None if ef is None else tuple(torch.from_numpy(e[sl].copy())
                                        for e in ef)
    y = tcol.sparse_neighbor_exchange(
        mine, clusters=C, dev=Dev, axes=axes, mesh=mesh, hkind=hk,
        intra_done=intra, alive=aw, conn=conn, wire_ef=wef, **kw)
    out = [t.numpy() for t in (y if wef is not None else (y,))]
    if case.get("dense_too"):
        out.append(tcol.mix_local(torch.from_numpy(x[sl].copy()), clusters=C,
                                  dev=Dev, axes=axes, mesh=mesh,
                                  hkind=hk).numpy())
    return tuple(out)


def one_process(name, case):
    """The port's one-process result of a case, all R rows."""
    C, Dev = case["C"], case["Dev"]
    x, alive, conn, ef = inputs(name, case)
    hk = case.get("hkind", "ring")
    t = torch.from_numpy(x)
    if case["op"] == "mix":
        return (tcol.mix_local(t, clusters=C, dev=Dev, hkind=hk, alive=alive,
                               conn=conn).numpy(),)
    kw = _kw(case)
    intra = bool(case.get("pre") or case.get("ef"))
    if intra:
        t = tcol.mix_local(t, clusters=C, dev=Dev, hkind="none")
    wef = None if ef is None else tuple(torch.from_numpy(e) for e in ef)
    y = tcol.sparse_neighbor_exchange(t, clusters=C, dev=Dev, hkind=hk,
                                      intra_done=intra, alive=alive,
                                      conn=conn, wire_ef=wef, **kw)
    return tuple(v.numpy() for v in (y if wef is not None else (y,)))


def world_cases(mesh):
    """Every case on both meshes over the 8 ranks, and the zero-fill of a
    partial rotation; each rank's rows by case name."""
    two = RankMesh((4, 2), ("pod", "data"), rank=mesh.rank, world=8,
                   device="cpu")
    meshes = {"8": (mesh, ("data",)), "4x2": (two, ("pod", "data"))}
    out = {}
    for name, case in CASES.items():
        m, axes = meshes[case["mesh"]]
        out[name] = port_case(m, axes, name, case)
    t = torch.full((3,), float(mesh.rank))
    out["rotate"] = (mesh.rotate([t], ("data",), 3, src={0, 2, 5})[0].numpy(),
                     two.rotate([t], ("pod", "data"), 5)[0].numpy())
    out["stats"] = dict(mesh.stats)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's rows, each case's rows stacked in rank order
    (the flat order of both meshes)."""
    got = run_world(world_cases, 8, shape=(8, 1), axes=("data", "model"),
                    device="cpu", timeout_s=240,
                    root=tmp_path_factory.mktemp("world"))
    return {k: tuple(np.concatenate([g[k][i] for g in got])
                     for i in range(len(got[0][k])))
            if k not in ("rotate", "stats") else [g[k] for g in got]
            for k in got[0]}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (fake) devices")
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core import mixing
    from repro.dist import collectives as jcol
    from repro.dist.compat import make_mesh, shard_map

    meshes = {k: make_mesh(*v) for k, v in MESHES.items()}

    def run(name, case):
        C, Dev = case["C"], case["Dev"]
        x, alive, conn, ef = inputs(name, case)
        mk, axes = meshes[case["mesh"]], MESHES[case["mesh"]][1]
        spec = P(axes, None)
        hk = case.get("hkind", "ring")
        kw = dict(case.get("kw", {}))
        intra = bool(case.get("pre") or case.get("ef"))
        args, specs = [jnp.asarray(x)], [spec]
        if alive is not None:
            args.append(jnp.asarray(alive))
            specs.append(P(axes))
        if conn is not None:
            args.append(jnp.asarray(conn))
            specs.append(P(None))
        if ef is not None:
            args += [jnp.asarray(e) for e in ef]
            specs += [spec, spec]

        def f(*a):
            xl, i, al, cn, wef = a[0], 1, None, None, None
            if alive is not None:
                al, i = a[i], i + 1
            if conn is not None:
                cn, i = a[i], i + 1
            if ef is not None:
                wef = (a[i], a[i + 1])
            if case["op"] == "mix":
                return jcol.mix_local(xl, clusters=C, dev=Dev, axes=axes,
                                      hkind=hk, alive=al, conn=cn)
            if intra:
                xl = jcol.mix_local(xl, clusters=C, dev=Dev, axes=axes,
                                    hkind="none")
            return jcol.sparse_neighbor_exchange(
                xl, clusters=C, dev=Dev, axes=axes, hkind=hk,
                intra_done=intra, alive=al, conn=cn, wire_ef=wef, **kw)

        nout = 3 if ef is not None else 1
        g = jax.jit(shard_map(f, mesh=mk, in_specs=tuple(specs),
                              out_specs=(spec,) * nout if nout > 1 else spec,
                              check_vma=False))
        out = g(*args)
        return tuple(np.asarray(o) for o in (out if nout > 1 else (out,)))

    def dense_w(C, Dev, hkind):
        H = np.eye(C) if hkind == "none" else mixing.make_mixing(hkind, C)
        cl = np.repeat(np.arange(C), Dev)
        return H[np.ix_(cl, cl)] / Dev

    return run, dense_w, mixing


def _close_to_ref(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


def _check(world, ref, name, bits=False):
    """The case's rows against the reference's shard_map; with ``bits``
    (whole clusters a rank, the wire) also bit for bit against the port's
    one-process rows, whose sums run in the same order."""
    case = CASES[name]
    got = world[name]
    for g, w in zip(got, ref[0](name, case)):
        _close_to_ref(g, w)
    if bits:
        for g, w in zip(got, one_process(name, case)):
            np.testing.assert_array_equal(g, w)
    return case, got


@pytest.mark.parametrize("hkind", HKINDS)
@pytest.mark.parametrize("C,Dev", SHAPES)
def test_mix_local_matches_reference_shard_map(world, ref, C, Dev, hkind):
    case, got = _check(world, ref, f"mix-{C}x{Dev}-{hkind}")
    x = inputs(f"mix-{C}x{Dev}-{hkind}", case)[0]
    np.testing.assert_allclose(got[0], ref[1](C, Dev, hkind) @ x, atol=1e-5)


def test_mix_local_multiaxis_fallback(world, ref):
    case, got = _check(world, ref, "mix-multiaxis")
    x = inputs("mix-multiaxis", case)[0]
    np.testing.assert_allclose(got[0], ref[1](4, 2, "ring") @ x, atol=1e-5)


@pytest.mark.parametrize("name", ["k-full", "k-clustered", "k-small"])
def test_sparse_exchange_k(world, ref, name):
    case, got = _check(world, ref, name, bits=name == "k-small")
    x = inputs(name, case)[0]
    want = ref[1](case["C"], case["Dev"], "ring") @ x
    if name == "k-small":
        err = np.abs(got[0] - want).max()
        assert 0 < err < np.abs(want).max()
    else:
        np.testing.assert_allclose(got[0], want, atol=1e-5)


@pytest.mark.parametrize("hkind", ["ring", "complete", "erdos_renyi"])
@pytest.mark.parametrize("C,Dev", WIRE_SHAPES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sparse_full_theta_f32_matches_dense_mix(world, ref, mesh, C, Dev,
                                                 hkind):
    name = f"full-{mesh}-{C}x{Dev}-{hkind}"
    case, got = _check(world, ref, name)
    sparse, dense = got
    if mesh == "8" and hkind != "complete":
        np.testing.assert_array_equal(sparse, dense)  # bit for bit
    else:
        np.testing.assert_allclose(sparse, dense, atol=1e-6)
    np.testing.assert_allclose(
        sparse, ref[1](C, Dev, hkind) @ inputs(name, case)[0], atol=1e-5)


@pytest.mark.parametrize("wire_dtype", ["f32", "bf16", "int8"])
def test_sparse_wire_dtypes_stay_close(world, ref, wire_dtype):
    case, got = _check(world, ref, f"dtype-{wire_dtype}")
    x = inputs(f"dtype-{wire_dtype}", case)[0]
    f32 = world["dtype-f32"][0]
    tol = {"f32": 0.0, "bf16": 2.0 ** -8, "int8": 1 / 127.0}[wire_dtype]
    assert np.abs(got[0] - f32).max() <= tol * np.abs(x).max() + 1e-7


def test_sparse_multiaxis_misaligned_fallback(world, ref):
    case, got = _check(world, ref, "misaligned")
    np.testing.assert_allclose(
        got[0], ref[1](2, 4, "ring") @ inputs("misaligned", case)[0],
        atol=1e-5)


def test_sparse_intra_done_skips_intra_reduction(world, ref):
    _check(world, ref, "intra-True")
    _check(world, ref, "intra-False")
    np.testing.assert_allclose(world["intra-True"][0],
                               world["intra-False"][0], atol=1e-6)


@pytest.mark.parametrize("C,Dev", [(4, 2), (8, 1), (2, 4)])
def test_per_cluster_all_ones_bitwise_dense(world, ref, C, Dev):
    case, got = _check(world, ref, f"ones-{C}x{Dev}")
    np.testing.assert_array_equal(got[0], got[1])


@pytest.mark.parametrize("wire_dtype", ["f32", "int4"])
@pytest.mark.parametrize("C,Dev,levels", HETERO)
def test_per_cluster_hetero_matches_reference(world, ref, wire_dtype, C, Dev,
                                              levels):
    _check(world, ref, f"hetero-{wire_dtype}-{C}x{Dev}",
           bits=(C * Dev) // 8 % Dev == 0)


@pytest.mark.parametrize("wire_dtype", ["f32", "int4"])
def test_per_cluster_layout_b_per_row_no_escalation(world, ref, wire_dtype):
    case, got = _check(world, ref, f"per-row-{wire_dtype}", bits=True)
    # the shard-max escalated operator is another matrix: not this one
    x = torch.from_numpy(inputs(f"per-row-{wire_dtype}", case)[0])
    esc = tuple(max((0.1, 1.0)) for _ in range(16))
    escalated = tcol.sparse_neighbor_exchange(
        x, clusters=16, dev=1, cluster_theta=esc, hkind="ring",
        **{k: v for k, v in _kw(case).items() if k != "cluster_theta"})
    assert np.abs(got[0] - escalated.numpy()).max() > 1e-4


@pytest.mark.parametrize("wire_dtype", ["f32", "int4"])
def test_per_cluster_multiaxis_takes_the_largest_level(world, ref,
                                                       wire_dtype):
    """More than one replica axis ships every cluster at the largest
    level, as the reference does."""
    case, got = _check(world, ref, f"hetero-multiaxis-{wire_dtype}")
    x = torch.from_numpy(inputs(f"hetero-multiaxis-{wire_dtype}", case)[0])
    kw = {k: v for k, v in _kw(case).items() if k != "cluster_theta"}
    top = tcol.sparse_neighbor_exchange(x, clusters=8, dev=2, theta=1.0,
                                        hkind="ring", **kw)
    np.testing.assert_allclose(got[0], top.numpy(), atol=1e-6)


def test_per_cluster_low_level_contracts_towards_dense(world, ref):
    _check(world, ref, "low-mixed", bits=True)
    _check(world, ref, "low-all", bits=True)
    x = inputs("low-mixed", CASES["low-mixed"])[0]
    want = ref[2].ring(8) @ x
    got = world["low-mixed"][0]
    cos = (got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want))
    assert cos > 0.8
    x_low = inputs("low-all", CASES["low-all"])[0]
    want_low = ref[2].ring(8) @ x_low
    low = world["low-all"][0]
    rel = lambda g, w: np.abs(g - w).sum() / np.abs(w).sum()
    assert rel(got, want) < rel(low, want_low)


@pytest.mark.parametrize("per_cluster", [False, True])
def test_sparse_exchange_all_alive_bitwise(world, ref, per_cluster):
    """Host masks of all ones are the unmasked path itself."""
    name = f"alive-ones-{per_cluster}"
    case, got = _check(world, ref, name)
    x, _, _, _ = inputs(name, case)
    want = tcol.sparse_neighbor_exchange(
        torch.from_numpy(x), clusters=4, dev=2, hkind="ring", **case["kw"])
    np.testing.assert_array_equal(got[0], want.numpy())


@pytest.mark.parametrize("hkind", ["ring", "complete", "none"])
@pytest.mark.parametrize("C,Dev", [(4, 2), (2, 4), (8, 1)])
def test_mix_local_partial_mask_matches_reference(world, ref, C, Dev, hkind):
    """Partial participation across ranks equals the f64 live-count
    reference (reference :609) and the reference's shard_map."""
    name = f"partial-{C}x{Dev}-{hkind}"
    case, got = _check(world, ref, name)
    rng = np.random.default_rng(_seed(name))
    R = C * Dev
    x = rng.standard_normal((R, case["L"])).astype(np.float32)
    a = (rng.random(R) > 0.4).astype(np.float64)
    a[0] = 1.0
    conn = (rng.random(C) > 0.4).astype(np.float32)
    xb = x.astype(np.float64).reshape(C, Dev, -1)
    ab = a.reshape(C, Dev)
    cnt = ab.sum(1)
    means = np.where(cnt[:, None] > 0, (xb * ab[..., None]).sum(1)
                     / np.maximum(cnt, 1.0)[:, None], xb.sum(1) / Dev)
    if hkind != "none":
        H = ref[2].make_mixing(hkind, C)
        means = np.asarray(ref[2].participation_mixing(H, conn),
                           np.float64) @ means
    np.testing.assert_allclose(got[0], np.repeat(means, Dev, axis=0),
                               atol=1e-5)


@pytest.mark.parametrize("wire_dtype", ["f32", "int4"])
@pytest.mark.parametrize("C,Dev", [(16, 1), (2, 4), (8, 2)])
def test_wire_ef_matches_reference(world, ref, wire_dtype, C, Dev):
    """The CHOCO estimates across ranks: (y, est_self+, est_wsum+)."""
    case, got = _check(world, ref, f"ef-{wire_dtype}-{C}x{Dev}",
                       bits=(C * Dev) // 8 % Dev == 0)
    assert len(got) == 3


def test_sparse_conn_mask_int4_levels(world, ref):
    """A backhaul partition on the int4 wire at per-cluster levels, layout
    B on 8 ranks: the reference's rows, and the one-process rows bit for
    bit."""
    _check(world, ref, "conn-int4", bits=True)


def test_rotation_zero_fills_a_partial_permutation(world):
    """rotate(src=...) ships from the listed shards only; a rank that is
    no destination gets zeros and posts no receive."""
    eight = [r[0] for r in world["rotate"]]
    for i, got in enumerate(eight):
        s = (i - 3) % 8
        want = float(s) if s in (0, 2, 5) else 0.0
        np.testing.assert_array_equal(got, np.full(3, want, np.float32))
    two = [r[1] for r in world["rotate"]]
    for i, got in enumerate(two):  # flat (pod, data) index is the rank
        np.testing.assert_array_equal(got, np.full(3, float((i - 5) % 8),
                                                   np.float32))
    assert all(s["messages"] > 0 for s in world["stats"])
