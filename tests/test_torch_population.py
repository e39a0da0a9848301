"""The port's population store, cohort swap and cohort draws against the
JAX package's, on the CPU.

The store (``runtime/population.PopulationStore``): gather / scatter are
exact copies, never-touched clients are zeros, the LRU spills pages and
reads them back bit for bit, bad ids are refused, save / restore rewinds
to the pinned page versions, a page write cut short leaves the previous
version.  ``elastic.cohort_swap`` keeps the population-global float64 EF
sum under ``==``; on the same data that sum is the reference store's,
bit for bit.  The cohort draws, reports, energy caps and vision shards
are numpy in both packages and held to the reference with ``==``; the
caps' effect on P2.1 / P2.2 within 1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.configs.base import FLTopology as JTopo  # noqa: E402
from repro.core import controller as jctrl  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.runtime.population import PopulationStore as JStore  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.configs.base import FLTopology  # noqa: E402
from repro_torch.convert import client_half_from_jax  # noqa: E402
from repro_torch.core import controller as tctrl  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import checkpoint as tckpt  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointError  # noqa: E402
from repro_torch.runtime.elastic import cohort_swap  # noqa: E402
from repro_torch.runtime.population import PopulationStore  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

CAP_TOL = 1e-9  # P2 with the caps: the same solver on the same arrays


def tmpl(dtype=torch.float32):
    m = lambda *s: torch.empty(s, dtype=dtype, device="meta")
    return {"ef": {"w": m(3, 2), "b": m(4)},
            "mom": {"w": m(3, 2), "b": m(4)}}


def cohort(rng, n, dtype=torch.float32):
    r = lambda *s: torch.from_numpy(rng.normal(0, 1, s).astype(
        np.float32)).to(dtype)
    return {"ef": {"w": r(n, 3, 2), "b": r(n, 4)},
            "mom": {"w": r(n, 3, 2), "b": r(n, 4)}}


def same(a, b):
    fa, fb = flatten(a), flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].view(torch.uint8), fb[k].view(torch.uint8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_scatter_exact_and_implicit_zeros(dtype):
    rng = np.random.default_rng(0)
    store = PopulationStore(20, tmpl(dtype))
    ids = np.array([3, 7, 11, 19])
    data = cohort(rng, 4, dtype)
    store.scatter(ids, data)
    same(store.gather(ids), data)
    zeros = store.gather(np.array([0, 12]))
    assert all(not v.any() for v in flatten(zeros).values())
    assert store.resident_count == 4  # reading zeros holds nothing
    # gather into tensors in place
    out = cohort(rng, 4, dtype)
    assert store.gather(ids, out=out) is out
    same(out, data)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_spill_reads_pages_back_bit_for_bit(dtype, tmp_path):
    rng = np.random.default_rng(1)
    store = PopulationStore(64, tmpl(dtype), root=tmp_path, resident_max=4)
    written = {}
    for cid in range(16):
        written[cid] = cohort(rng, 1, dtype)
        store.scatter(np.array([cid]), written[cid])
    assert store.resident_count <= 4
    pages = {int(p.name[7:15]) for p in tmp_path.glob("client_*.npy")}
    assert pages == set(range(12))  # evicted clients only
    for cid in (0, 5, 11, 15):
        same(store.gather(np.array([cid])), written[cid])


def test_bad_ids_and_shapes_rejected():
    rng = np.random.default_rng(2)
    store = PopulationStore(10, tmpl())
    with pytest.raises(ValueError, match="unique"):
        store.gather(np.array([1, 1]))
    with pytest.raises(ValueError, match="range"):
        store.gather(np.array([10]))
    with pytest.raises(ValueError, match="range"):
        store.scatter(np.array([-1]), cohort(rng, 1))
    with pytest.raises(ValueError, match="shape"):
        store.scatter(np.arange(2), cohort(rng, 3))
    with pytest.raises(ValueError, match="size"):
        cohort_swap(cohort(rng, 4), np.arange(4), np.arange(5), store)


def _seeded_store(rng, tmp_path, jax_too=False):
    """A store with several cohorts' history (and the reference's store
    fed the same bits)."""
    store = PopulationStore(100, tmpl(), root=tmp_path / "p", resident_max=8)
    jstore = None
    if jax_too:
        jt = {"ef": {"w": jax.ShapeDtypeStruct((3, 2), np.float32),
                     "b": jax.ShapeDtypeStruct((4,), np.float32)},
              "mom": {"w": jax.ShapeDtypeStruct((3, 2), np.float32),
                      "b": jax.ShapeDtypeStruct((4,), np.float32)}}
        jstore = JStore(100, jt, root=tmp_path / "j", resident_max=8)
    for _ in range(6):
        ids = rng.choice(100, 10, replace=False)
        data = cohort(rng, 10)
        store.scatter(ids, data)
        if jstore is not None:
            jstore.scatter(ids, jax.tree.map(lambda t: t.numpy(), data))
    return store, jstore


def test_cohort_swap_conserves_the_aggregate_exactly(tmp_path):
    rng = np.random.default_rng(3)
    store, jstore = _seeded_store(rng, tmp_path, jax_too=True)
    out_ids = rng.choice(100, 10, replace=False)
    in_ids = rng.choice(100, 10, replace=False)
    slots = cohort(rng, 10)
    before = store.aggregate("ef", extra_ids=out_ids, extra=slots)
    want = jstore.aggregate("ef", extra_ids=out_ids, extra={
        "ef": jax.tree.map(lambda t: t.numpy(), slots["ef"])})
    assert before != 0.0 and before == want  # the reference's f64 sum
    got = cohort_swap(slots, out_ids, in_ids, store)
    assert got is slots  # in place
    after = store.aggregate("ef", extra_ids=in_ids, extra=slots)
    assert before == after  # exact
    # the identity swap is a round trip
    keep = jax.tree.map(lambda t: t.clone(), slots)
    cohort_swap(slots, in_ids, in_ids, store)
    same(slots, keep)


def test_save_restore_and_training_after_save(tmp_path):
    rng = np.random.default_rng(4)
    store = PopulationStore(20, tmpl(), root=tmp_path / "pages",
                            resident_max=2)
    ids = np.array([1, 2, 3])
    store.scatter(ids, cohort(rng, 3))
    store.record_round(ids, 0, energy=np.full(3, 2.5), time=np.ones(3))
    saved = store.gather(ids)
    agg = store.aggregate("ef")
    store.save(tmp_path / "pop.npz")
    for _ in range(4):  # keep training past the manifest
        store.scatter(ids, cohort(rng, 3))
        store.scatter(np.array([7, 8]), cohort(rng, 2))
    store2 = PopulationStore(20, tmpl(), root=tmp_path / "pages",
                             resident_max=2)
    store2.restore(tmp_path / "pop.npz")
    same(store2.gather(ids), saved)
    assert store2.aggregate("ef") == agg
    assert np.array_equal(store2.energy_spent[ids], np.full(3, 2.5))
    assert store2.rounds_participated.sum() == 3
    # without a root the manifest holds the state itself
    emb = PopulationStore(12, tmpl())
    emb.scatter(ids, saved)
    emb.save(tmp_path / "emb.npz")
    emb2 = PopulationStore(12, tmpl())
    emb2.restore(tmp_path / "emb.npz")
    same(emb2.gather(ids), saved)
    with pytest.raises(CheckpointError, match="population"):
        PopulationStore(13, tmpl()).restore(tmp_path / "emb.npz")


def test_torn_page_write_keeps_the_old_version(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    store = PopulationStore(10, tmpl(), root=tmp_path, resident_max=1)
    ids = np.array([4])
    first = cohort(rng, 1)
    store.scatter(ids, first)
    store.flush()

    def torn(src, dst):  # the kill lands between fsync and rename
        raise OSError("killed mid-replace")

    real = tckpt.os.replace
    monkeypatch.setattr(tckpt.os, "replace", torn)
    store.scatter(ids, cohort(rng, 1))
    with pytest.raises(OSError):
        store.flush()
    monkeypatch.setattr(tckpt.os, "replace", real)
    store2 = PopulationStore(10, tmpl(), root=tmp_path, resident_max=1)
    store2._ver = {4: 1}
    same(store2.gather(ids), first)
    assert [p.name for p in tmp_path.iterdir()] == ["client_00000004."
                                                   "v000001.npy"]


def test_state_split_and_template():
    cfg = smoke_model(get_config("smollm_135m").model)
    hcef = get_config("smollm_135m").hcef
    state = tround.init_state(cfg, hcef, FLTopology(2, 2),
                              lm.init(cfg, seed=0, device="cpu"),
                              device="cpu")
    mesh, client = tround.split_state(state)
    assert set(mesh) == set(tround.MESH_FIELDS) == {"params", "round_idx"}
    assert set(client) == set(tround.CLIENT_FIELDS)
    assert tround.merge_state(mesh, client) == state
    t = tround.client_template(state)
    for k, v in flatten(t).items():
        f, rest = k.split("/", 1)
        full = flatten(getattr(state, f))[rest]
        assert v.shape == full.shape[1:] and v.dtype == full.dtype
    # the reference's client half comes over leaf for leaf
    jcfg = j_smoke(j_get_config("smollm_135m").model)
    jstate = jround.init_state(jcfg, j_get_config("smollm_135m").hcef,
                               JTopo(2, 2), jax.random.PRNGKey(0))
    _, jclient = jround.split_state(jstate)
    got = client_half_from_jax(jax.tree.map(np.asarray, jclient), "cpu")
    assert got["wire_ef"] is None
    assert set(flatten({k: v for k, v in got.items() if v is not None})) \
        == set(flatten(t))


def test_cohort_draws_and_reports_equal_reference():
    for seed in (0, 2):
        kw = dict(num_devices=8, population=500, seed=seed)
        t, j = HeterogeneityModel(**kw), JHet(**kw)
        assert np.array_equal(t.capability, j.capability)
        for rnd in range(5):
            assert np.array_equal(t.available(rnd), j.available(rnd))
            ids = t.sample_cohort(rnd, 8, seed=3)
            assert np.array_equal(ids, j.sample_cohort(rnd, 8, seed=3))
            assert t.available(rnd)[ids].all()
            a, b = t.sample_round(rnd, ids=ids), j.sample_round(rnd, ids=ids)
            for f in ("mu", "alpha", "nu", "p", "sigma2", "G2"):
                assert np.array_equal(getattr(a, f), getattr(b, f))
    # churn leaving too few available: the top-up path
    t = HeterogeneityModel(num_devices=8, population=9, avail_lo=0.0,
                           avail_hi=0.05)
    j = JHet(num_devices=8, population=9, avail_lo=0.0, avail_hi=0.05)
    assert np.array_equal(t.sample_cohort(1, 8), j.sample_cohort(1, 8))
    # the fixed roster's reports are unchanged by ids
    h = HeterogeneityModel(num_devices=4, seed=1)
    assert np.array_equal(h.sample_round(2).mu,
                          h.sample_round(2, ids=np.arange(4)).mu)
    for bad in (dict(num_devices=8, population=4),):
        with pytest.raises(ValueError, match="population"):
            HeterogeneityModel(**bad)
    with pytest.raises(ValueError, match="range"):
        HeterogeneityModel(num_devices=4, population=10).sample_round(
            0, ids=np.array([10]))


def _reports(cap=None, n=6):
    rng = np.random.default_rng(0)
    return tctrl.DeviceReports(
        sigma2=np.ones(n), G2=np.ones(n), mu=rng.uniform(75, 150, n),
        alpha=rng.uniform(1.5, 6, n), nu=rng.uniform(20, 100, n),
        p=rng.uniform(0.1, 1, n), energy_cap=cap)


def test_energy_caps_equal_reference_and_constrain_p2():
    kw = dict(time_budget=1e5, energy_budget=6e3, phi=10, q=2,
              population=100, cohort=6)
    parts, spent = np.array([0, 3, 5, 1, 0, 2]), np.array(
        [0.0, 1.0, 1e6, 3.0, 0.5, 2.0])
    caps = tctrl.population_energy_caps(tctrl.BudgetState(**kw), parts,
                                        spent)
    assert np.array_equal(caps, jctrl.population_energy_caps(
        jctrl.BudgetState(**kw), parts, spent))
    assert caps[2] == 0.0
    with pytest.raises(ValueError, match="population"):
        tctrl.population_energy_caps(tctrl.BudgetState(1.0, 1.0, 1, 1),
                                     parts, spent)
    for cap in (caps, np.full(6, 1e-6), np.full(6, 1e3)):
        rt, rj = _reports(cap), jctrl.DeviceReports(
            **dataclasses.asdict(_reports(cap)))
        rho = np.full(6, 0.5)
        np.testing.assert_allclose(
            tctrl.solve_p21_theta(rho, rt, 1e4, 1e9, 5),
            jctrl.solve_p21_theta(rho, rj, 1e4, 1e9, 5), rtol=CAP_TOL)
        theta = np.full(6, 0.05)
        np.testing.assert_allclose(
            tctrl.solve_p22_rho(theta, rt, 1e5, 1e9, 5),
            jctrl.solve_p22_rho(theta, rj, 1e5, 1e9, 5), rtol=CAP_TOL)
    tight = _reports(np.full(6, 1e-6))
    free = _reports()
    assert (tctrl.solve_p21_theta(np.full(6, 0.5), tight, 1e4, 1e9, 5)
            == 0.05).all()
    assert (tctrl.solve_p21_theta(np.full(6, 0.5), free, 1e4, 1e9, 5).mean()
            > 0.05)
    assert (tctrl.solve_p22_rho(np.full(6, 0.05), tight, 1e5, 1e9, 5)
            == 0.1).all()


def test_client_image_shard_and_batches_equal_reference():
    for kind in ("cifar", "femnist"):
        for cid in (0, 17, 100_000):
            for a, b in zip(tsyn.client_image_shard(kind, 16, cid, beta=0.1),
                            jsyn.client_image_shard(kind, 16, cid,
                                                    beta=0.1)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tsyn.client_image_shard("svhn", 4, 0)
    arrays = (np.arange(10), np.arange(10) * 2)
    ti, ji = (tsyn.batch_iterator(arrays, 3, seed=1),
              jsyn.batch_iterator(arrays, 3, seed=1))
    for _ in range(7):
        for a, b in zip(next(ti), next(ji)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("new_c,new_d", [(4, 2), (2, 4), (1, 2), (2, 1)])
def test_resize_state_matches_reference(new_c, new_d):
    """``elastic.resize_state`` on the same stacked state as the
    reference's: growing keeps each surviving device's EF scaled R'/R,
    shrinking folds it into the models (within 1e-6: the same f32 means)."""
    from repro.configs.base import FLTopology as JT
    from repro.runtime.elastic import resize_state as j_resize
    from repro_torch.runtime.elastic import resize_state
    rng = np.random.default_rng(new_c * 10 + new_d)
    R = 4
    make = lambda s: {"w": rng.normal(size=(R,) + s).astype(np.float32)}
    params, ef, mom = make((3, 2)), make((3, 2)), make((3, 2))
    params["w"] = np.repeat(params["w"][::2], 2, axis=0)  # clusters agree
    t = lambda d: {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    got = resize_state(t(params), t(ef), t(mom), FLTopology(2, 2),
                       FLTopology(new_c, new_d))
    want = j_resize(params, ef, mom, JT(2, 2), JT(new_c, new_d))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"].numpy(), np.asarray(w["w"]),
                                   rtol=1e-6, atol=1e-6)
        assert g["w"].shape[0] == new_c * new_d


def test_row_by_row_paths_keep_the_bits(monkeypatch):
    """The paths a card's large leaves take, run here on host tensors:
    a held client's rows rewritten in place on scatter, a first-time
    client's slot rows zeroed where they lie on gather."""
    from repro_torch.runtime import population
    monkeypatch.setattr(population, "_by_row", lambda t: True)
    rng = np.random.default_rng(6)
    store = PopulationStore(10, tmpl())
    ids = np.array([2, 5])
    first, second = cohort(rng, 2), cohort(rng, 2)
    store.scatter(ids, jax.tree.map(lambda t: t.clone(), first))
    held = [r.data_ptr() for r in store._resident[5]]
    store.scatter(ids, jax.tree.map(lambda t: t.clone(), second))
    assert [r.data_ptr() for r in store._resident[5]] == held  # in place
    slots = cohort(rng, 3)
    store.gather(np.array([5, 7, 2]), out=slots)
    got = flatten(slots)
    for k, v in flatten(second).items():
        assert torch.equal(got[k][0], v[1]) and torch.equal(got[k][2], v[0])
        assert not got[k][1].any()  # client 7 never took part
