"""The port's overlapped round engine against the JAX package's, on the CPU.

All on the smoke smollm (f32, 2 layers, d_model 64, d_ff 128; the
reference's tests/test_overlap.py model), 2 clusters x 2 devices, tau 2,
q 2, the reference's parameters and masked-step bits:

  * staleness 0, a round without gossip and an empty stale set give the
    synchronous step's bits, ``pending`` included, off the mesh and on the
    fused branch (the port alone);
  * staleness 1 off the mesh: round 0 (no gossip), then the gossip round
    with every cluster stale, with {1} stale, and with every cluster stale
    under a dead device and cluster 1 partitioned, against the reference's
    ``make_overlap_round_step`` under ``jax.jit``;
  * staleness 1 on the fused branch (the int4 wire at cluster levels, one
    gossip round, the stale payloads encoded before the local steps)
    against the reference's mesh branch on a one-device host mesh, both on
    the exact top-k (``impl="ref"``);
  * the eta = 0 level-1.0 fixed point, off the mesh and fused;
  * ``sparse_neighbor_exchange(stale=)`` against the reference at every
    wire dtype, and the pre-encoded payloads (``stale_payloads``) against
    the in-line stale path, bit for bit;
  * ``overlap_round_time`` and ``decide_stale_clusters`` equal to the
    reference's; the errors the reference raises; the train launcher's
    ``--overlap``.

Tolerances: tests/test_torch_round_lm.py's (loss 1e-5 relative, the state
within atol 1e-4 / rtol 1e-3), the collectives' f32 2e-5.  Each package's
reference program compiles once per module (module-scoped fixtures).
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.configs.base import FLTopology as JTopo  # noqa: E402
from repro.configs.base import HCEFConfig as JHCEF  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.dist import collectives as jcol  # noqa: E402
from repro.dist.policies import make_train_policy as j_policy  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.configs.base import FLTopology, HCEFConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.dist import collectives as tcol  # noqa: E402
from repro_torch.dist.policies import make_train_policy  # noqa: E402
from repro_torch.fl import cost_model as tcost  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

from test_torch_round import STATE_TOL, jax_bits  # noqa: E402

C, DEV, R, TAU, Q, SEQ = 2, 2, 4, 2, 2, 33
HCEF = dict(tau=TAU, q=Q, eta=0.1, momentum=0.9)
SPARSE = dict(sparse_gossip=True, wire_dtype="int4",
              theta_levels=(0.1, 0.6, 1.0))
LEVELS = (0.1, 0.6)  # the fused gossip's cluster levels
RHO = np.array([0.9, 0.7, 1.0, 0.8])
THETA = np.array([0.1, 0.1, 0.4, 0.6])
LOSS_RTOL = 1e-5
# tests/test_torch_round_chaos.py's FLIP_SHARE: a delta entry at a block's
# top-k threshold can be kept on one side and left in the EF on the other
# (ROADMAP.md section 3).  Measured: one EF entry of 427,264 in the
# off-mesh rounds with every cluster stale and with {1} stale, none in the
# parameters or elsewhere
FLIP_SHARE = 1e-4
FIELDS = ("params", "momentum", "ef")
# the off-mesh stale variants: (stale_clusters, alive, conn); the port
# runs "all" unmasked, the reference with masks of all ones (one trace
# with "cut"; its traced ones are not bitwise its unmasked mix)
VARIANTS = {"all": (None, np.ones(R, bool), np.ones(C, bool)),
            "one": ((1,), None, None),
            "cut": (None, np.array([1, 1, 1, 0], bool),
                    np.array([1, 0], bool))}


def _tokens(rnd):
    return np.random.default_rng(40 + rnd).integers(0, 257, (R * TAU * 2,
                                                             SEQ))


def _masks(alive, conn):
    if alive is None:
        return ()
    return (alive.astype(np.float32),
            tcol.participation_weights(alive, clusters=C, dev=DEV),
            conn.astype(np.float32))


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares (as
    tests/test_torch_launch_chaos.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """The smoke config of each package and seeded weights as numpy."""
    jcfg = j_smoke(j_get_config("smollm_135m").model).replace(d_model=64,
                                                            d_ff=128)
    cfg = smoke_model(get_config("smollm_135m").model).replace(d_model=64,
                                                             d_ff=128)
    params0 = tree_map(lambda t: t.numpy(), lm.init(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    return jcfg, cfg, params0


def _port_state(cfg, hcef, params0):
    return tround.init_overlap_state(cfg, hcef, FLTopology(C, DEV),
                                     params_from_jax(params0, "cpu"),
                                     device="cpu")


def _ref_state(jhcef, params0):
    """The reference's ``init_overlap_state`` from ``params0``."""
    p = jax.tree.map(lambda x: jnp.broadcast_to(jnp.asarray(x)[None],
                                                (R,) + x.shape), params0)
    zeros = jax.tree.map(jnp.zeros_like, p)
    fl = jround.FLState(params=p, momentum=zeros if jhcef.momentum else None,
                        ef=zeros, round_idx=jnp.zeros((), jnp.int32))
    return jround.OverlapState(fl=fl, pending=p)


def _ref_call(step, state, rnd, masks=(), mesh=None):
    keys = jax.random.split(jax.random.PRNGKey(1000 + rnd), R)
    args = (state, {"tokens": jnp.asarray(_tokens(rnd))},
            jnp.asarray(RHO, jnp.float32), jnp.asarray(THETA, jnp.float32),
            keys, *(jnp.asarray(a) for a in masks))
    if mesh is None:
        return step(*args)
    with mesh:
        return step(*args)


def _port_call(step, state, rnd, masks=()):
    return step(state, {"tokens": torch.from_numpy(_tokens(rnd))}, RHO,
                THETA, 1000 + rnd,
                **dict(zip(("alive", "alive_w", "conn"), masks)))


def _port_fields(state):
    out = {f: {k: v.numpy() for k, v in flatten(getattr(state.fl, f))
               .items()} for f in FIELDS}
    out["pending"] = {k: v.numpy() for k, v in flatten(state.pending)
                      .items()}
    return out


def _ref_fields(state):
    out = {f: _leaves(getattr(state.fl, f)) for f in FIELDS}
    out["pending"] = _leaves(state.pending)
    return out


def _assert_close(got, want, what):
    """Every field within STATE_TOL but for at most FLIP_SHARE of its
    entries (top-k threshold flips)."""
    for f, leaves in want.items():
        assert set(got[f]) == set(leaves), (what, f)
        off = size = 0
        for k, w in leaves.items():
            off += int((~np.isclose(got[f][k], w, **STATE_TOL)).sum())
            size += w.size
        assert off <= FLIP_SHARE * size, (what, f, off, size)


# ---------------------------------------------------------------------------
# staleness 0, no gossip, an empty stale set: the synchronous bits
# ---------------------------------------------------------------------------

SYNC_LIKE = {"staleness0": (0, True, None), "no_gossip": (1, False, None),
             "empty_set": (1, True, ())}


@pytest.mark.parametrize("fused", [False, True], ids=["off_mesh", "fused"])
@pytest.mark.parametrize("case", sorted(SYNC_LIKE))
def test_sync_like_steps_are_the_synchronous_bits(setup, case, fused):
    _, cfg, params0 = setup
    staleness, gossip, stale = SYNC_LIKE[case]
    hcef = HCEFConfig(**HCEF, **(SPARSE if fused else {}))
    topo = FLTopology(C, DEV)
    policy = make_train_policy(topo) if fused else None
    levels = LEVELS if fused and gossip else None
    sync = tround.make_round_step(cfg, hcef, topo, policy, gossip=gossip,
                                  cluster_levels=levels,
                                  bits_fn=jax_bits(TAU, R))
    hov = dataclasses.replace(hcef, overlap=True, staleness=staleness)
    over = tround.make_overlap_round_step(
        cfg, hov, topo, policy, gossip=gossip, cluster_levels=levels,
        stale_clusters=stale, bits_fn=jax_bits(TAU, R))
    a = _port_state(cfg, hcef, params0)
    a_fl, ma = _port_call(sync, a.fl, 0)
    b, mb = _port_call(over, _port_state(cfg, hov, params0), 0)
    assert "stale_frac" not in mb
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for f in FIELDS:
        for k, v in flatten(getattr(a_fl, f)).items():
            assert torch.equal(v, flatten(getattr(b.fl, f))[k]), (f, k)
    for k, v in flatten(b.fl.params).items():  # pending refreshed
        p = flatten(b.pending)[k]
        assert torch.equal(v, p) and v.data_ptr() != p.data_ptr(), k


# ---------------------------------------------------------------------------
# staleness 1 against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def off_mesh(setup):
    """Each variant's stale gossip step twice (rounds 0 and 1: round 1's
    pending is round 0's result), one reference compile a variant.
    {variant: (port, reference)} of (losses, stale_frac, state fields)."""
    jcfg, cfg, params0 = setup
    jhcef = JHCEF(**HCEF, overlap=True, staleness=1)
    hcef = HCEFConfig(**HCEF, overlap=True, staleness=1)
    jtopo, topo = JTopo(C, DEV), FLTopology(C, DEV)
    out, jsteps = {}, {}
    for name, (stale, alive, conn) in VARIANTS.items():
        masks = _masks(alive, conn)
        if stale not in jsteps:
            jsteps[stale] = jax.jit(jround.make_overlap_round_step(
                jcfg, jhcef, jtopo, gossip=True, stale_clusters=stale))
        jstep = jsteps[stale]
        tstep = tround.make_overlap_round_step(
            cfg, hcef, topo, gossip=True, stale_clusters=stale,
            bits_fn=jax_bits(TAU, R))
        js, ts = _ref_state(jhcef, params0), _port_state(cfg, hcef, params0)
        jl, tl = [], []
        for rnd in range(2):
            js, jm = _ref_call(jstep, js, rnd, masks)
            ts, tm = _port_call(tstep, ts, rnd,
                                () if name == "all" else masks)
            jl.append(np.asarray(jm["loss"]))
            tl.append(tm["loss"].numpy())
        out[name] = ((tl, float(tm["stale_frac"]), _port_fields(ts)),
                     (jl, float(jm["stale_frac"]), _ref_fields(js)))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_off_mesh_stale_round_matches_reference(off_mesh, variant):
    (tl, tf, got), (jl, jf, want) = off_mesh[variant]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tf == jf == (0.5 if variant == "one" else 1.0)
    _assert_close(got, want, variant)
    for k, v in got["params"].items():  # pending is the new model
        assert np.array_equal(v, got["pending"][k])
        assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])


def test_the_stale_set_decides_what_ships(off_mesh):
    """With {1} stale cluster 0 ships its fresh model, so cluster 1's
    result differs from the all-stale round's."""
    got = {v: off_mesh[v][0][2]["params"] for v in ("all", "one")}
    assert any(not np.array_equal(got["all"][k][2], got["one"][k][2])
               for k in got["all"])


@pytest.fixture(scope="module")
def fused(setup):
    """One fused stale gossip round of each package (int4 at LEVELS,
    every cluster stale): (port, reference) of (losses, theta_wire,
    stale_frac, fields)."""
    jcfg, cfg, params0 = setup
    jhcef = JHCEF(**HCEF, **SPARSE, overlap=True, staleness=1)
    hcef = HCEFConfig(**HCEF, **SPARSE, overlap=True, staleness=1)
    mesh = make_host_mesh()
    jpolicy = j_policy(mesh, JTopo(C, DEV), dp_axes=("data",))
    js, jm = _ref_call(jax.jit(jround.make_overlap_round_step(
        jcfg, jhcef, JTopo(C, DEV), jpolicy, gossip=True, impl="ref",
        cluster_levels=LEVELS)), _ref_state(jhcef, params0), 0,
        mesh=mesh)
    topo = FLTopology(C, DEV)
    ts, tm = _port_call(tround.make_overlap_round_step(
        cfg, hcef, topo, make_train_policy(topo), gossip=True, impl="ref",
        cluster_levels=LEVELS, bits_fn=jax_bits(TAU, R)),
        _port_state(cfg, hcef, params0), 0)
    return ((tm["loss"].numpy(), float(tm["theta_wire"]),
             float(tm["stale_frac"]), _port_fields(ts)),
            (np.asarray(jm["loss"]), float(jm["theta_wire"]),
             float(jm["stale_frac"]), _ref_fields(js)))


def test_fused_stale_round_matches_reference(fused):
    (tl, tw, tf, got), (jl, jw, jf, want) = fused
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tw == jw == np.float32(0.6) and tf == jf == 1.0
    _assert_close(got, want, "fused")
    for k, v in got["params"].items():
        assert np.array_equal(v, got["pending"][k])


@pytest.mark.parametrize("fused_branch", [False, True],
                         ids=["off_mesh", "fused"])
def test_eta0_level1_fixed_point(setup, fused_branch):
    """eta 0 and uniform models at level 1.0: nobody moved, so mixing the
    stale (unchanged) models returns them (H's rows sum to 1)."""
    _, cfg, params0 = setup
    kw = dict(HCEF, eta=0.0, momentum=0.0, overlap=True, staleness=1)
    if fused_branch:  # the f32 wire at level 1.0 ships the dense rows
        kw.update(SPARSE, wire_dtype="f32")
    hcef = HCEFConfig(**kw)
    topo = FLTopology(C, DEV)
    state = _port_state(cfg, hcef, params0)
    before = {k: v.clone() for k, v in flatten(state.fl.params).items()}
    step = tround.make_overlap_round_step(
        cfg, hcef, topo, make_train_policy(topo) if fused_branch else None,
        gossip=True, cluster_levels=(1.0, 1.0) if fused_branch else None,
        bits_fn=jax_bits(TAU, R))
    state, m = step(state, {"tokens": torch.from_numpy(_tokens(0))},
                    np.ones(R), np.ones(R), 7)
    assert float(m["stale_frac"]) == 1.0
    for k, v in flatten(state.fl.params).items():
        np.testing.assert_allclose(v.numpy(), before[k].numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the stale gossip
# ---------------------------------------------------------------------------

WIRE_DTYPES = ("f32", "bf16", "int8", "int4", "fp8")
GC, GDEV, GL = 4, 2, 2500  # tests/test_torch_collectives.py's rows
GOSSIP_LEVELS = (0.05, 1.0, 0.25, 0.05)  # a dense-fallback level and wires


def _cluster_rows(seed):
    x = np.random.default_rng(seed).standard_normal((GC * GDEV, GL))
    return np.repeat(x.reshape(GC, GDEV, GL).mean(1), GDEV,
                     axis=0).astype(np.float32)


# (stale set, backhaul mask): every cluster, two, every cluster with
# cluster 1 partitioned
STALE_CASES = (((0, 1, 2, 3), None), ((1, 2), None),
               ((0, 1, 2, 3), (1.0, 0.0, 1.0, 1.0)))


@pytest.mark.parametrize("wd", WIRE_DTYPES)
def test_stale_exchange_matches_reference(wd):
    """STALE_CASES at ``wd``, the reference's three under one ``jax.jit``
    (its eager int4 route compiles op by op for 14 s)."""
    x, s = _cluster_rows(1), _cluster_rows(2)
    kw = dict(clusters=GC, dev=GDEV, hkind="ring", wire_dtype=wd,
              cluster_theta=GOSSIP_LEVELS, intra_done=True)
    want = jax.jit(lambda x, s: [jcol.sparse_neighbor_exchange(
        x, axes=(), stale=s, stale_clusters=st, conn=None if conn is None
        else jnp.asarray(conn), **kw) for st, conn in STALE_CASES])(
        jnp.asarray(x), jnp.asarray(s))
    for (st, conn), w in zip(STALE_CASES, want):
        got = tcol.sparse_neighbor_exchange(
            torch.from_numpy(x), impl="ref", stale=torch.from_numpy(s),
            stale_clusters=st, conn=None if conn is None else np.asarray(
                conn, np.float32), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5, err_msg=f"{st} {conn}")


@pytest.mark.parametrize("wd", WIRE_DTYPES)
def test_pre_encoded_payloads_are_the_in_line_bits(wd):
    """``stale_payloads`` then ``sparse_exchange_(payloads=)`` against
    ``sparse_exchange_(stale=, stale_clusters=all)``, in chunks of 1024
    columns, on bf16 rows and with a partition."""
    x = torch.from_numpy(_cluster_rows(3)).to(torch.bfloat16)
    s = torch.from_numpy(_cluster_rows(4)).to(torch.bfloat16)
    conn = np.array([1, 1, 0, 1], np.float32)
    kw = dict(clusters=GC, dev=GDEV, hkind="ring", wire_dtype=wd,
              cluster_theta=GOSSIP_LEVELS, chunk_cols=1024)
    want = x.clone()
    tcol.sparse_exchange_(want, stale=s, stale_clusters=range(GC), conn=conn,
                          **kw)
    pre = tcol.stale_payloads(s, **kw)
    assert len(pre) == 3  # chunks
    got = x.clone()
    tcol.sparse_exchange_(got, payloads=pre, conn=conn, **kw)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not torch.equal(want, x)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wire", [None, "int4"])
def test_cost_model_matches_reference(wire):
    cluster_of = np.repeat(np.arange(C), DEV)
    rng = np.random.default_rng(5)
    wkw = dict(wire_dtype=wire, wire_block=1024) if wire else {}
    het, jhet = (H(num_devices=R, model_bits=2.3e6 * 32)
                 for H in (HeterogeneityModel, JHet))
    seen = set()
    for rnd in range(6):
        rep, jrep = het.sample_round(rnd), jhet.sample_round(rnd)
        np.testing.assert_array_equal(rep.mu, jrep.mu)
        rho = rng.uniform(0.2, 1.0, R)
        theta = rng.choice([0.1, 0.6, 1.0], R)
        alive = rng.random(R) > 0.3 if rnd % 2 else None
        conn = rng.random(C) > 0.3 if rnd % 3 == 2 else None
        for q in (0.25, 0.9):
            args = (rho, theta, rep.mu, rep.nu, TAU, cluster_of)
            kw = dict(backhaul=het.backhaul_time(), alive=alive,
                      quantile=q, **wkw)
            got = tcost.decide_stale_clusters(*args, **kw)
            assert got == jcost.decide_stale_clusters(*args, **kw)
            seen.add(got)
            for gossip in (False, True):
                okw = dict(backhaul=het.backhaul_time(), gossip=gossip,
                           alive=alive, conn=conn, stale_clusters=got,
                           fold=0.5, **wkw)
                t, pc = tcost.overlap_round_time(*args, **okw)
                jt, jpc = jcost.overlap_round_time(*args, **okw)
                assert t == jt
                np.testing.assert_array_equal(pc, jpc)
    assert len(seen) > 1  # the sets differ between rounds


# ---------------------------------------------------------------------------
# errors, as the reference raises them
# ---------------------------------------------------------------------------

def test_errors_raised_as_in_the_reference(setup):
    _, cfg, _ = setup
    for kw in (dict(staleness=2), dict(staleness=1),
               dict(overlap=True, staleness=1, sparse_gossip=True,
                    wire_ef=True)):
        with pytest.raises(ValueError):
            HCEFConfig(**kw)
        with pytest.raises(ValueError):
            JHCEF(**kw)
    HCEFConfig(overlap=True, staleness=1)  # ported
    topo = FLTopology(C, DEV)
    with pytest.raises(ValueError, match="overlap"):
        tround.make_overlap_round_step(cfg, HCEFConfig(), topo)
    hov = HCEFConfig(overlap=True, staleness=1)
    with pytest.raises(ValueError, match="out of range"):
        tround.make_overlap_round_step(cfg, hov, topo, stale_clusters=(2,))
    x = torch.from_numpy(_cluster_rows(0))
    base = dict(clusters=GC, dev=GDEV, theta=0.5)
    for kw, match in ((dict(stale=x, stale_clusters=(0,)), "intra_done"),
                      (dict(stale=x, intra_done=True), "together"),
                      (dict(stale=x, stale_clusters=(), intra_done=True),
                       "non-empty"),
                      (dict(stale=x, stale_clusters=(4,), intra_done=True),
                       "non-empty"),
                      (dict(stale=x, stale_clusters=(0,), intra_done=True,
                            wire_ef=(x, x)), "wire_ef")):
        with pytest.raises(ValueError, match=match):
            tcol.sparse_neighbor_exchange(x, **base, **kw)
        with pytest.raises(ValueError):
            jx = jnp.asarray(x.numpy())
            jkw = {k: (jx if isinstance(v, torch.Tensor) else
                       (jx, jx) if k == "wire_ef" else v)
                   for k, v in kw.items()}
            jcol.sparse_neighbor_exchange(jx, axes=(), **base, **jkw)


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------

SMOKE = ["--device", "cpu", "--arch", "smollm_135m", "--rounds", "4",
         "--seq", "16"]


@pytest.mark.parametrize("quantile", ["0.9", "0.2"])
def test_launcher_stale_sets_are_the_references(quantile, monkeypatch,
                                                capsys):
    """The launcher's stale set each gossip round (round 4 at q = 4)
    against the reference's ``decide_stale_clusters`` on the same
    reports and controls; at 0.9 one cluster is stale, at 0.2 both."""
    calls = []

    def both(*args, **kw):
        got = tcost.decide_stale_clusters(*args, **kw)
        calls.append((got, jcost.decide_stale_clusters(*args, **kw)))
        return got

    monkeypatch.setattr(train, "decide_stale_clusters", both)
    out = train.main(SMOKE + ["--overlap", "--stale-quantile", quantile])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    assert len(calls) == 1 and calls[0][0] == calls[0][1]
    assert calls[0][0] == ((1,) if quantile == "0.9" else (0, 1))
    assert out["history"][3]["stale"] == list(calls[0][0])
    assert f"stale={len(calls[0][0])}/2" in lines[3]
    assert all("stale" not in h for h in out["history"][:3])
    assert isinstance(out["state"], tround.OverlapState)
    assert set(out["timings"]) == {"device_round", "compress", "aggregate",
                                   "gossip", "pending"}


def test_launcher_staleness0_is_the_plain_run(capsys):
    plain = train.main(SMOKE)
    over = train.main(SMOKE + ["--overlap", "--staleness", "0"])
    assert ([h["loss"] for h in plain["history"]]
            == [h["loss"] for h in over["history"]])
    assert ([h["time"] for h in plain["history"]]
            == [h["time"] for h in over["history"]])
    for f in FIELDS:
        for k, v in flatten(getattr(plain["state"], f)).items():
            assert torch.equal(v, flatten(getattr(over["state"].fl, f))[k])
    for k, v in flatten(over["state"].fl.params).items():
        assert torch.equal(v, flatten(over["state"].pending)[k])


def test_phase_timings_keep_every_key():
    """``timings`` gets every phase's key with the current-stream timer:
    a stale gossip round's stage 1, its fold and the pending refresh."""
    cfg = smoke_model(get_config("smollm_135m").model)
    topo = FLTopology(C, DEV)
    hcef = HCEFConfig(tau=TAU, q=Q, eta=0.1, overlap=True, staleness=1,
                      **SPARSE)
    params0 = lm.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    state = tround.init_overlap_state(cfg, hcef, topo, params0,
                                      device="cpu")
    timings = {}
    step = tround.make_overlap_round_step(cfg, hcef, topo,
                                          make_train_policy(topo),
                                          gossip=True, cluster_levels=LEVELS)
    step(state, {"tokens": torch.from_numpy(_tokens(0))}, RHO, THETA, 3,
         timings=timings)
    assert set(timings) == {"device_round", "compress", "aggregate",
                            "gossip", "pending"}
    assert all(len(v) == 1 and v[0] >= 0 for v in timings.values())
