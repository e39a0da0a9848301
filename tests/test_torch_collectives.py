"""The port's single-process gossip (``dist/collectives.py``) against the
JAX package's ``axes=()`` path, on the CPU.

``mix_local`` for every backhaul; ``sparse_neighbor_exchange`` on ring
and complete backhauls, C = 4 clusters of Dev = 2, for every wire dtype
and every way of sizing the payloads (``theta=``, ``k=``, and per-cluster
``cluster_theta=`` that mixes a dense-fallback level with wire levels);
the CHOCO wire error feedback over several rounds; and the column-chunked
exchange against the unchunked one.  The port runs its wire with
``impl="ref"`` (the exact top-k encode), which is the reference's CPU
route.  Tolerance: f32 2e-5 (the reference's); the chunked exchange is
held bit for bit to the unchunked one.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.dist import collectives as jcol  # noqa: E402
from repro_torch.dist import collectives as tcol  # noqa: E402
from repro_torch.dist.mesh import RankMesh  # noqa: E402

ALL = ("f32", "bf16", "int8", "int4", "fp8")
C, DEV, L = 4, 2, 2500  # L pads the last wire block
TOL = dict(atol=2e-5, rtol=2e-5)
# a dense-fallback level for the f32 / bf16 wires (and for int8 over bf16
# rows), wire levels for the rest, two clusters sharing a level
MIXED = (0.05, 1.0, 0.25, 0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rows(seed, dtype=np.float32, intra_done=False):
    x = np.random.default_rng(seed).standard_normal((C * DEV, L))
    if intra_done:  # every device row holds its cluster's mean
        x = np.repeat(x.reshape(C, DEV, L).mean(1), DEV, axis=0)
    return x.astype(np.float32)


def both(x, jdtype=jnp.float32, tdtype=torch.float32):
    return jnp.asarray(x, jdtype), torch.from_numpy(x).to(tdtype)


def close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("hkind", ["ring", "complete", "erdos_renyi", "none"])
def test_mix_local_matches_reference(hkind):
    jx, tx = both(rows(1))
    close(tcol.mix_local(tx, clusters=C, dev=DEV, hkind=hkind),
          jcol.mix_local(jx, clusters=C, dev=DEV, axes=(), hkind=hkind))
    jb, tb = both(rows(1), jnp.bfloat16, torch.bfloat16)
    got = tcol.mix_local(tb, clusters=C, dev=DEV, hkind=hkind)
    assert got.dtype == torch.bfloat16
    close(got, jcol.mix_local(jb, clusters=C, dev=DEV, axes=(),
                              hkind=hkind).astype(jnp.float32),
          atol=2e-2, rtol=2e-2)  # bf16 (tests/test_kernels.py:13)


LEVELS = {"theta": dict(theta=0.25), "k": dict(k=300),
          "cluster_theta": dict(cluster_theta=MIXED)}


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("level", sorted(LEVELS))
def test_sparse_exchange_ring_matches_reference(wd, level):
    jx, tx = both(rows(2))
    kw = dict(clusters=C, dev=DEV, hkind="ring", wire_dtype=wd,
              **LEVELS[level])
    want = jcol.sparse_neighbor_exchange(jx, axes=(), **kw)
    close(tcol.sparse_neighbor_exchange(tx, impl="ref", **kw), want)


@pytest.mark.parametrize("wd", ALL)
def test_sparse_exchange_complete_matches_reference(wd):
    jx, tx = both(rows(3, intra_done=True))
    kw = dict(clusters=C, dev=DEV, hkind="complete", wire_dtype=wd,
              cluster_theta=MIXED, intra_done=True)
    want = jcol.sparse_neighbor_exchange(jx, axes=(), **kw)
    close(tcol.sparse_neighbor_exchange(tx, impl="ref", **kw), want)


@pytest.mark.parametrize("wd", ALL)
def test_sparse_exchange_bf16_rows_mixed_levels(wd):
    """bf16 intra-done rows: the dense fallback ships bf16 rows.  At
    theta = 1 every wire but int4 reaches the padded row's 5000 bytes."""
    x = rows(4, intra_done=True)
    jx, tx = both(x, jnp.bfloat16, torch.bfloat16)
    plans = tcol._wire_plans(MIXED, L, 1024, wd, 2)
    assert (("dense",) in [k for k, _ in plans]) == (wd != "int4")
    kw = dict(clusters=C, dev=DEV, hkind="ring", wire_dtype=wd,
              cluster_theta=MIXED, intra_done=True)
    want = jcol.sparse_neighbor_exchange(jx, axes=(), **kw)
    got = tcol.sparse_neighbor_exchange(tx, impl="ref", **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))  # the same rounding to bf16


@pytest.mark.parametrize("wd", ["int8", "int4", "fp8"])
def test_wire_ef_rounds_match_reference(wd):
    """Three rounds of the CHOCO estimates, fed back as the reference's
    round step feeds them, on drifting means."""
    kw = dict(clusters=C, dev=DEV, hkind="ring", wire_dtype=wd,
              cluster_theta=MIXED, intra_done=True, wire_ef_gamma=0.8)
    z = np.zeros((C * DEV, L), np.float32)
    jest, test = (jnp.asarray(z), jnp.asarray(z)), (torch.zeros(C * DEV, L),
                                                    torch.zeros(C * DEV, L))
    for r in range(3):
        jx, tx = both(rows(10 + r, intra_done=True))
        jy, *jest = jcol.sparse_neighbor_exchange(jx, axes=(),
                                                  wire_ef=tuple(jest), **kw)
        ty, *test = tcol.sparse_neighbor_exchange(tx, wire_ef=tuple(test),
                                                  impl="ref", **kw)
        close(ty, jy)
        for a, b in zip(test, jest):
            assert a.dtype == torch.float32
            close(a, b)


def test_uniform_dense_fallback_is_the_dense_mix():
    jx, tx = both(rows(5))
    got = tcol.sparse_neighbor_exchange(tx, clusters=C, dev=DEV, theta=1.0,
                                        wire_dtype="f32")
    assert torch.equal(got, tcol.mix_local(tx, clusters=C, dev=DEV))
    close(got, jcol.sparse_neighbor_exchange(
        jx, clusters=C, dev=DEV, axes=(), theta=1.0, wire_dtype="f32"))


@pytest.mark.parametrize("wd", ALL)
def test_chunked_exchange_equals_unchunked(wd):
    """Column chunks of whole wire blocks (the last one ragged and padded)
    give the unchunked result bit for bit, the estimates included, on the
    kernels' route (the plain bisection) as on the exact one."""
    x = torch.from_numpy(rows(6, intra_done=True))
    est = (torch.from_numpy(rows(7, intra_done=True)) * 0.5,
           torch.from_numpy(rows(8, intra_done=True)) * 0.5)

    def run(impl, chunk):
        out = [t.clone() for t in (x,) + est]
        tcol.sparse_exchange_(out[0], clusters=C, dev=DEV, hkind="ring",
                              wire_dtype=wd, cluster_theta=MIXED,
                              wire_ef=out[1:], wire_block=256, impl=impl,
                              chunk_cols=chunk)
        return out

    for impl in (None, "ref"):
        whole = run(impl, None)
        for chunk in (256, 700):  # 700 rounds down to 512
            for a, b in zip(run(impl, chunk), whole):
                assert torch.equal(a, b), (impl, chunk)


@pytest.mark.parametrize("wd", ("int4", "fp8"))
def test_gossip_chunk_width_does_not_change_the_bits(wd):
    """The round's gossip configuration (bf16 rows, C = 2 on a ring,
    cluster levels (0.1, 0.6), wire block 1024, no wire EF) gives the
    same bits at every column chunk width: one wire block, four, a width
    that rounds down to whole blocks, and the whole row."""
    rng = np.random.default_rng(12)
    L = 5 * 1024 + 300
    means = rng.standard_normal((2, L)).astype(np.float32)
    x = torch.from_numpy(np.repeat(means, 2, axis=0)).to(torch.bfloat16)
    kw = dict(clusters=2, dev=2, hkind="ring", wire_dtype=wd,
              wire_block=1024, cluster_theta=(0.1, 0.6))
    outs = []
    for chunk in (1024, 4096, 3000, None):
        y = x.clone()
        tcol.sparse_exchange_(y, chunk_cols=chunk, **kw)
        outs.append(y.view(torch.int16))
    assert not torch.equal(outs[0], x.view(torch.int16))
    for y in outs[1:]:
        assert torch.equal(y, outs[0])


@pytest.mark.parametrize("clusters", (2, 4, 8, 16))
def test_gossip_cols_keeps_the_scratch_budget(clusters):
    """The round's gossip chunk width: GOSSIP_COLS at C = 2, narrower with
    more clusters, so that three (C, cols) f32 rows stay in the budget."""
    from repro_torch.core import round as rnd
    cols = rnd.gossip_cols(clusters)
    assert 3 * clusters * cols * 4 <= rnd.GOSSIP_SCRATCH_BYTES
    assert cols == rnd.GOSSIP_COLS * 2 // clusters
    assert cols >= 1024  # whole wire blocks at the largest wire block


@pytest.mark.parametrize("clusters", (2, 4, 8, 16))
def test_gossip_cols_with_wire_ef_keeps_the_scratch_budget(clusters):
    """With the wire EF a chunk holds the two new estimates too: four
    (C, cols) f32 rows, inside the budget at the one chunk width."""
    from repro_torch.core import round as rnd
    cols = rnd.gossip_cols(clusters)
    assert 4 * clusters * cols * 4 <= rnd.GOSSIP_SCRATCH_BYTES
    assert cols % 1024 == 0  # whole wire blocks at the largest wire block


def test_sparse_exchange_in_place_matches_functional():
    tx = torch.from_numpy(rows(9, intra_done=True)).to(torch.bfloat16)
    kw = dict(clusters=C, dev=DEV, hkind="ring", wire_dtype="int4",
              cluster_theta=(0.1, 0.6, 0.1, 0.6))
    want = tcol.sparse_neighbor_exchange(tx, intra_done=True, **kw)
    x = tx.clone()
    tcol.sparse_exchange_(x, chunk_cols=1024, **kw)
    assert torch.equal(x, want)


def test_argument_validation():
    tx = torch.from_numpy(rows(0, intra_done=True))
    z = torch.zeros_like(tx)
    base = dict(clusters=C, dev=DEV, theta=0.5)
    with pytest.raises(ValueError, match="intra_done"):
        tcol.sparse_neighbor_exchange(tx, wire_ef=(z, z), **base)
    with pytest.raises(ValueError, match="gossip hkind"):
        tcol.sparse_neighbor_exchange(tx, intra_done=True, hkind="none",
                                      wire_ef=(z, z), **base)
    with pytest.raises(ValueError, match="exactly one"):
        tcol.sparse_neighbor_exchange(tx, clusters=C, dev=DEV)
    with pytest.raises(ValueError, match="entries"):
        tcol.sparse_neighbor_exchange(tx, clusters=C, dev=DEV,
                                      cluster_theta=(0.5, 0.5))
    # mesh axes name a rank mesh: without one they raise; a 1-rank mesh
    # is the one-process path
    with pytest.raises(ValueError, match="mesh="):
        tcol.sparse_neighbor_exchange(tx, axes=("data",), **base)
    one = RankMesh((1, 1), ("data", "model"))
    assert torch.equal(
        tcol.sparse_neighbor_exchange(tx, axes=("data",), mesh=one, **base),
        tcol.sparse_neighbor_exchange(tx, **base))
    # the stale payloads are ported, with the reference's own checks
    with pytest.raises(ValueError, match="intra_done"):
        tcol.sparse_neighbor_exchange(tx, stale=tx, stale_clusters=(0,),
                                      **base)
    # the degraded-mode masks are ported: all links up is the unmasked
    # mix, and a partition with the wire EF raises as in the reference
    assert torch.equal(
        tcol.sparse_neighbor_exchange(tx, conn=np.ones(C), **base),
        tcol.sparse_neighbor_exchange(tx, **base))
    with pytest.raises(ValueError, match="conn"):
        tcol.sparse_neighbor_exchange(tx, intra_done=True, wire_ef=(z, z),
                                      conn=np.eye(C)[0], **base)
    with pytest.raises(ValueError, match="mesh="):
        tcol.mix_local(tx, clusters=C, dev=DEV, axes=("data",))
    assert torch.equal(
        tcol.mix_local(tx, clusters=C, dev=DEV, axes=("data",), mesh=one),
        tcol.mix_local(tx, clusters=C, dev=DEV))
