"""The port's fused round step with its FL replicas split over the ranks
of a gloo world against the JAX package's round step on a mesh of its
fake CPU devices, on the CPU.

Smoke smollm (f32), tau = 2, the reference's ``make_round_step(...,
policy=make_train_policy(make_mesh((n, 1), ("data", "model")), topo,
dp_axes=("data",)))`` under ``jax.jit`` (XLA backend level 0,
``test_torch_round.FAST_COMPILE``) and ``with mesh:``, beside the port's
``make_round_step`` on an n-rank world (``dist.mesh.run_world``, one a
layout, spawned once for the module):
  layout A: 2 clusters x 4 devices on 4 ranks (R_local 2, a cluster
    spanning g = 2 ranks: the intra mean a recursive-doubling exchange);
  layout B: 4 clusters x 2 devices on 2 ranks (Cl = 2 whole clusters a
    rank).
Each runs, from the reference's ``init_state`` parameters (handed to the
ranks with ``convert.params_from_jax`` and cut with
``init_state(replicas=R_local)``, at one layer), an intra round and then
gossip rounds from its state: the dense gossip (``mix_local`` across
ranks); the sparse int8 wire at per-cluster levels (0.1, 0.6: two wire
plans, partial rotations) with the CHOCO wire error feedback (passing
``cluster_levels``; the int4 wire across ranks, whose reference compiles
for twice as long, is held in tests/test_torch_mesh_collectives.py and on
the card in chip_smoke.py's phases 42-44); and in layout A one chaos
round (the dense gossip with two devices dropped and one cluster's link
cut).  The masked-step bits are the reference's, computed here and
handed to the ranks; the wire runs ``impl="ref"``.  Tolerances:
``test_torch_round.py``'s (loss 1e-5 relative, the state atol 1e-4 /
rtol 1e-3); the metrics come back for all R on every rank.
"""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world

# the ranks import this module: nothing of JAX at its top
pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the reference needs jax")
STATE_TOL = dict(atol=1e-4, rtol=1e-3)  # test_torch_round.STATE_TOL

TAU, SEQ = 2, 17
LEVELS = (0.1, 0.6, 1.0)
HIST_RTOL = 1e-5
LAYOUTS = {"A": (2, 4, 4), "B": (4, 2, 2)}  # C, Dev, ranks
RHO = 0.85
SCENARIOS = ("dense", "sparse", "chaos")
# HCEFConfig: the sparse scenario's wire (its intra round is the dense
# one's: no wire runs there, and the wire-EF estimates start at zero)
HCEF = dict(tau=TAU, q=2, eta=0.1, momentum=0.9, sparse_gossip=True,
            wire_dtype="int8", wire_ef=True, theta_levels=LEVELS)


def plan(layout):
    """The round inputs (tokens of the intra round and of the gossip
    round, rho, theta) and each scenario's gossip round (cluster levels
    or None, masks or None), as numpy."""
    C, Dev, _ = LAYOUTS[layout]
    R = C * Dev
    rng = np.random.default_rng(7)
    theta = np.where(np.repeat(np.arange(C), Dev) % 2 == 0, 0.08,
                     0.5).astype(np.float64)
    rho = np.full(R, RHO)
    rho[1] = 0.6
    alive = np.ones(R, np.float32)
    alive[[1, R - 2]] = 0.0
    conn = np.ones(C, np.float32)
    conn[1] = 0.0
    gossip = {"dense": (None, None),
              "sparse": (tuple(0.1 if c % 2 == 0 else 0.6
                               for c in range(C)), None)}
    if layout == "A":
        gossip["chaos"] = (None, (alive, conn))
    toks = [rng.integers(0, 257, (R * TAU * 2, SEQ)) for _ in range(2)]
    return toks, rho, theta, gossip


def configs(sparse):
    """(ModelConfig kwargs, HCEFConfig kwargs) of a scenario's step: the
    smoke smollm at one layer."""
    kw = dict(HCEF)
    if not sparse:
        kw.update(sparse_gossip=False, wire_ef=False)
    return dict(num_layers=1), kw


def port_world(mesh, layout, params0, bits):
    """The intra round, then each scenario's gossip round from its state,
    on this rank: {scenario: ([round 0, gossip round metrics], final state
    rows)}."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.convert import params_from_jax, shard_rows
    from repro_torch.core import round as tround
    from repro_torch.dist.collectives import participation_weights
    from repro_torch.dist.policies import make_train_policy
    from repro_torch.tree import flatten, tree_map
    C, Dev, _ = LAYOUTS[layout]
    topo = FLTopology(C, Dev)
    policy = make_train_policy(mesh, topo, dp_axes=("data",))
    toks, rho, theta, gossip = plan(layout)

    def step(sparse, g, levels=None):
        mkw, hkw = configs(sparse)
        cfg = smoke_model(get_config("smollm_135m").model).replace(**mkw)
        return tround.make_round_step(
            cfg, HCEFConfig(**hkw), topo, policy, gossip=g, impl="ref",
            cluster_levels=levels,
            bits_fn=lambda key, rho_: bits[key - 1000])

    mkw, hkw = configs(True)
    cfg = smoke_model(get_config("smollm_135m").model).replace(**mkw)
    whole = tround.init_state(cfg, HCEFConfig(**hkw), topo,
                              params_from_jax(params0, "cpu"), device="cpu")
    cut = lambda t: shard_rows(t, mesh, policy.replica_axes)
    state0 = whole._replace(params=cut(whole.params),
                            momentum=cut(whole.momentum), ef=cut(whole.ef),
                            wire_ef=cut(whole.wire_ef))
    assert all(v.shape[0] == policy.local_replicas
               for v in flatten(state0.ef).values())
    state0, m0 = step(False, False)(state0, {"tokens": torch.from_numpy(
        toks[0])}, rho, theta, 1000)
    out = {}
    for sc, (levels, masks) in gossip.items():
        state = state0._replace(**{f: tree_map(torch.clone, getattr(
            state0, f)) for f in ("params", "momentum", "ef", "wire_ef")})
        kw = {}
        if masks is not None:
            kw = dict(alive=masks[0], conn=masks[1],
                      alive_w=participation_weights(masks[0], clusters=C,
                                                    dev=Dev))
        state, m = step(sc == "sparse", True, levels)(
            state, {"tokens": torch.from_numpy(toks[1])}, rho, theta, 1001,
            **kw)
        fields = ("params", "momentum", "ef") + (
            ("wire_ef",) if sc == "sparse" else ())
        out[sc] = ([{k: v.numpy() for k, v in mm.items()} for mm in (m0, m)],
                   {f: {k: v.numpy() for k, v in
                        flatten(getattr(state, f)).items()} for f in fields})
    return out


def _leaves(tree):
    import jax
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference(layout):
    """The reference's rounds of a layout on its n-device mesh (its
    initial parameters and masked-step bits as ``reference_inputs``)."""
    import jax
    import jax.numpy as jnp
    from test_torch_round import FAST_COMPILE, _jit

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import FLTopology as JTopo
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    from repro.dist.collectives import participation_weights
    from repro.dist.compat import make_mesh
    from repro.dist.policies import make_train_policy as j_policy
    C, Dev, n = LAYOUTS[layout]
    jtopo = JTopo(clusters=C, devices_per_cluster=Dev)
    mesh = make_mesh((n, 1), ("data", "model"))
    policy = j_policy(mesh, jtopo, dp_axes=("data",))
    R = C * Dev
    toks, rho, theta, gossip = plan(layout)

    def step(sparse, g, levels=None):
        mkw, hkw = configs(sparse)
        jcfg = j_smoke(j_get_config("smollm_135m").model).replace(**mkw)
        return _jit(jround.make_round_step(
            jcfg, JHCEF(**hkw), jtopo, policy, gossip=g, impl="ref",
            cluster_levels=levels), FAST_COMPILE)

    args = lambda r: ({"tokens": jnp.asarray(toks[r])},
                      jnp.asarray(rho, jnp.float32),
                      jnp.asarray(theta, jnp.float32),
                      jax.random.split(jax.random.PRNGKey(1000 + r), R))
    mkw, hkw = configs(True)
    jcfg = j_smoke(j_get_config("smollm_135m").model).replace(**mkw)
    state0 = jround.init_state(jcfg, JHCEF(**hkw), jtopo,
                               jax.random.PRNGKey(0))
    with mesh:
        state0, m0 = step(False, False)(state0, *args(0))
    out = {}
    for sc, (levels, masks) in gossip.items():
        extra = ()
        if masks is not None:
            aw = participation_weights(masks[0], clusters=C, dev=Dev)
            extra = (jnp.asarray(masks[0]), jnp.asarray(aw),
                     jnp.asarray(masks[1]))
        with mesh:
            state, m = step(sc == "sparse", True, levels)(
                state0, *args(1), *extra)
        fields = ("params", "momentum", "ef") + (
            ("wire_ef",) if sc == "sparse" else ())
        out[sc] = ([jax.tree.map(np.asarray, mm) for mm in (m0, m)],
                   {f: _leaves(getattr(state, f)) for f in fields})
    return out


def reference_inputs(layout):
    """The reference's initial parameters (one replica, numpy) and its
    masked-step bits of both rounds, (R, tau) each."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.configs.base import FLTopology as JTopo
    from repro.configs.base import HCEFConfig as JHCEF
    from repro.core import round as jround
    C, Dev, _ = LAYOUTS[layout]
    mkw, hkw = configs(True)
    jcfg = j_smoke(j_get_config("smollm_135m").model).replace(**mkw)
    state0 = jround.init_state(jcfg, JHCEF(**hkw), JTopo(C, Dev),
                               jax.random.PRNGKey(0))
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), state0.params)
    _, rho, _, _ = plan(layout)
    r32 = jnp.clip(jnp.asarray(rho, jnp.float32), 0.0, 1.0)
    bits = [np.asarray(jax.vmap(
        lambda k, p: jax.random.bernoulli(k, p, (TAU,)))(
            jax.random.split(jax.random.PRNGKey(1000 + r), C * Dev), r32),
        np.float32) for r in range(2)]
    return params0, bits


CASES = [(lay, sc) for lay in LAYOUTS for sc in SCENARIOS
         if sc != "chaos" or lay == "A"]


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    """{layout: (reference, [rank results])}: the reference's rounds of
    both layouts, then both worlds at once (each from a thread)."""
    import threading
    want = {lay: reference(lay) for lay in LAYOUTS}
    got = {}

    def world(layout, params0, bits):
        try:
            got[layout] = run_world(port_world, LAYOUTS[layout][2], layout,
                                    params0, bits, device="cpu",
                                    timeout_s=240,
                                    root=tmp_path_factory.mktemp("world"))
        except BaseException as e:  # raised below
            got[layout] = e

    threads = [threading.Thread(target=world,
                                args=(lay,) + reference_inputs(lay))
               for lay in LAYOUTS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in got.values():
        if isinstance(g, BaseException):
            raise g
    return {lay: (want[lay], got[lay]) for lay in LAYOUTS}


@pytest.mark.parametrize("layout,scenario", CASES)
def test_history_matches_reference(all_runs, layout, scenario):
    """Loss, g2, sigma2 and the steps per round, for all R on every rank;
    theta_wire on the sparse gossip round."""
    want, got = all_runs[layout]
    jh = want[scenario][0]
    for rank_out in got:
        th = rank_out[scenario][0]
        assert len(th) == len(jh)
        for w, g in zip(jh, th):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=HIST_RTOL)
            np.testing.assert_array_equal(g["steps"], w["steps"])
            np.testing.assert_allclose(g["g2"], w["g2"], rtol=1e-5)
            np.testing.assert_allclose(g["sigma2"], w["sigma2"], rtol=1e-4,
                                       atol=1e-6)
            if "theta_wire" in w:
                assert float(g["theta_wire"]) == float(w["theta_wire"])


@pytest.mark.parametrize("layout,scenario", CASES)
def test_final_state_matches_reference(all_runs, layout, scenario):
    """Every field's rows, gathered from the ranks in order, within the
    round tolerances; every device of a cluster holds its model."""
    want, got = all_runs[layout]
    C, Dev, _ = LAYOUTS[layout]
    ws = want[scenario][1]
    for field, leaves in ws.items():
        for k, w in leaves.items():
            g = np.concatenate([r[scenario][1][field][k] for r in got])
            np.testing.assert_allclose(g, w, err_msg=f"{field} {k}",
                                       **STATE_TOL)
            if field == "params":
                cl = g.reshape((C, Dev) + g.shape[1:])
                assert all(np.array_equal(cl[c, 0], cl[c, d])
                           for c in range(C) for d in range(Dev))
    if scenario == "sparse":
        est = [v for r in got
               for k, v in r[scenario][1]["wire_ef"].items()
               if k.startswith("est_self")]
        assert max(np.abs(v).max() for v in est) > 0
