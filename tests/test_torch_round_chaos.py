"""The port's round step under the degraded-mode masks against the JAX
package's, on the CPU, all on the smoke smollm (f32, 2 layers).

  * the off-mesh step: a 2-round history (tau 2, q 2) under a chaos trace
    (dropped devices in the first round, a dropped device and a
    partitioned cluster in the gossip round), each package with its own controller on the live devices,
    fault plan and cost model, from the reference's parameters, the same
    tokens and the reference's masked-step bits; at
    tests/test_torch_round_lm.py's tolerances;
  * the fused branch with the sparse gossip over the int4 wire at
    per-cluster levels, one dead device in both rounds and a partitioned
    cluster in the gossip round, against the reference's mesh branch on a one-device
    mesh, both on the exact top-k (``impl="ref"``) as
    tests/test_torch_round_sparse.py runs it;
  * a dead, partitioned cluster keeps its parameters bit for bit and its
    EF takes the pending update, in both branches;
  * the masks at None, all ones, or a chaos plan at zero probabilities
    give the unmasked round bit for bit.

The masked mix is held to a tolerance, not bitwise: the reference's own
traced all-ones mask is not bitwise its unmasked mix (its four failing
``mix_local`` tests, ROADMAP.md section 3).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.configs.base import FLTopology as JTopo  # noqa: E402
from repro.configs.base import HCEFConfig as JHCEF  # noqa: E402
from repro.core import controller as jctrl  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.dist import collectives as jcol  # noqa: E402
from repro.dist.policies import make_train_policy as j_policy  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.configs.base import FLTopology, HCEFConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import controller as tctrl  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    cluster_levels_from_theta, quantize_theta)
from repro_torch.data.synthetic import synthetic_tokens  # noqa: E402
from repro_torch.dist import collectives as tcol  # noqa: E402
from repro_torch.dist.policies import make_train_policy  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl import cost_model as tcost  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.runtime import chaos as tchaos  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

from test_torch_round import (FAST_COMPILE, G2_RTOL,  # noqa: E402
                              HIST_RTOL, SIGMA2_RTOL, STATE_TOL, _jit,
                              jax_bits)

ROUNDS, TAU, Q, SEQ, N_SEQ, R, C, DEV = 2, 2, 2, 33, 32, 4, 2, 2
HCEF = dict(tau=TAU, q=Q, eta=0.1, momentum=0.9)
BUDGET = dict(time_budget=3e4, energy_budget=4e3, phi=50, q=Q)
MODEL_BITS = 2.3e6 * 32
# seed 2: a device drops in round 0, and in the gossip round 1 another
# drops and cluster 1's link is cut (asserted below)
CHAOS = dict(seed=2, dropout_prob=0.3, partition_prob=0.5,
             coordinator_fail_prob=0.3)
SPARSE_THETA = np.array([0.05, 0.1, 0.4, 0.6])
FLIP_SHARE = 1e-4  # chip_smoke.py's Q_FLIP_SHARE
LEVELS = (0.1, 0.6, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params0():
    jcfg = j_smoke(j_get_config("smollm_135m").model)
    jstate = jround.init_state(jcfg, JHCEF(**HCEF), JTopo(C, DEV),
                               jax.random.PRNGKey(0))
    return jcfg, jstate, jax.tree.map(lambda x: np.asarray(x[0]),
                                      jstate.params)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _off_mesh_history(port: bool, chaos=CHAOS):
    """ROUNDS of the off-mesh step as the train launcher drives it with
    --chaos; returns (history, final state fields as numpy, trace)."""
    jcfg, jstate, params0 = _params0()
    topo = FLTopology(C, DEV)
    if port:
        cfg = smoke_model(get_config("smollm_135m").model)
        state = tround.init_state(cfg, HCEFConfig(**HCEF), topo, params0,
                                  device="cpu")
        steps = {g: tround.make_round_step(cfg, HCEFConfig(**HCEF), topo,
                                           gossip=g, bits_fn=jax_bits(TAU, R))
                 for g in (False, True)}
        ctrl, Het, cost, Budget, ch = (tbase, HeterogeneityModel, tcost,
                                       tctrl.BudgetState, tchaos)
    else:
        state = jstate
        steps = {g: _jit(jround.make_round_step(jcfg, JHCEF(**HCEF),
                                                JTopo(C, DEV), gossip=g),
                         FAST_COMPILE)
                 for g in (False, True)}
        ctrl, Het, cost, Budget, ch = (jbase, JHet, jcost, jctrl.BudgetState,
                                       jchaos)
    controller = ctrl.make_controller("hcef", TAU)
    het = Het(num_devices=R, model_bits=MODEL_BITS)
    budget = Budget(backhaul_time=het.backhaul_time(), **BUDGET)
    plan = (ch.FaultPlan(ch.ChaosConfig(**chaos), R, C)
            if chaos is not None else None)
    cluster_of = np.repeat(np.arange(C), DEV)
    corpus = synthetic_tokens(jcfg.vocab_size, n_seq=N_SEQ, seq_len=SEQ,
                              n_devices=R, beta=0.5)
    rng = np.random.default_rng(0)
    hist, trace = [], []
    for rnd in range(ROUNDS):
        reports = het.sample_round(rnd)
        gossip = (rnd + 1) % Q == 0
        alive = conn = None
        if plan is not None:
            alive0 = plan.sample_available(rnd)
            rho, theta = ch.controls_on_live(controller, reports, budget,
                                             alive0)
        else:
            rho, theta = controller.controls(reports, budget)
        idx = rng.integers(0, N_SEQ, (R, 2 * TAU))
        tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
        masks = ()
        if plan is not None:
            f = plan.step(rnd, gossip_round=gossip,
                          per_device_time=cost.per_device_time(
                              rho, theta, reports.mu, reports.nu, TAU),
                          alive=alive0)
            alive, conn = f.alive, f.cluster_conn
            trace.append((alive.tolist(), conn.tolist()))
            if not (alive.all() and conn.all()):
                masks = (alive.astype(np.float32),
                         jcol.participation_weights(alive, clusters=C,
                                                    dev=DEV),
                         conn.astype(np.float32))
        if port:
            kw = dict(zip(("alive", "alive_w", "conn"), masks))
            state, m = steps[gossip](state, {"tokens": torch.from_numpy(
                tokens)}, rho, theta, 1000 + rnd, **kw)
            m = {k: v.numpy() for k, v in m.items()}
        else:
            keys = jax.random.split(jax.random.PRNGKey(1000 + rnd), R)
            state, m = steps[gossip](
                state, {"tokens": jnp.asarray(tokens)},
                jnp.asarray(rho, jnp.float32),
                jnp.asarray(theta, jnp.float32), keys,
                *(jnp.asarray(a) for a in masks))
            m = jax.tree.map(np.asarray, m)
        t, _ = cost.round_time(rho, theta, reports.mu, reports.nu, TAU,
                               cluster_of, gossip=gossip,
                               backhaul=het.backhaul_time(), alive=alive,
                               conn=conn)
        e = cost.round_energy(rho, theta, reports.mu, reports.nu,
                              reports.alpha, reports.p, TAU, alive=alive)
        budget.time_spent_this += t
        budget.energy_spent_this += e
        budget.r += 1
        if gossip:
            budget.time_spent_prev += budget.time_spent_this
            budget.energy_spent_prev += budget.energy_spent_this
            budget.time_spent_this = budget.energy_spent_this = 0.0
            budget.r = 0
            budget.l += 1
        hist.append({"loss": float(m["loss"].mean()), "g2": m["g2"],
                     "sigma2": m["sigma2"], "steps": m["steps"],
                     "rho_mean": float(np.mean(rho)),
                     "theta_mean": float(np.mean(theta)),
                     "time": budget.time_spent_prev + budget.time_spent_this,
                     "energy": (budget.energy_spent_prev
                                + budget.energy_spent_this)})
    fields = ("params", "momentum", "ef")
    final = ({f: {k: v.numpy() for k, v in flatten(getattr(state, f)).items()}
              for f in fields} if port else
             {f: _leaves(getattr(state, f)) for f in fields})
    return hist, final, trace


@pytest.fixture(scope="module")
def off_mesh():
    return _off_mesh_history(port=False), _off_mesh_history(port=True)


def test_off_mesh_chaos_history_matches_reference(off_mesh):
    (want, _, wtrace), (got, _, trace) = off_mesh
    assert trace == wtrace
    assert not all(trace[0][0]) and not all(trace[1][0])  # devices drop
    assert not all(trace[1][1])  # a link cut on a gossip round
    for r, (g, w) in enumerate(zip(got, want)):
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (r, k, g[k], w[k])
        np.testing.assert_array_equal(g["steps"], w["steps"])
        np.testing.assert_allclose(g["g2"], w["g2"], rtol=G2_RTOL)
        np.testing.assert_allclose(g["sigma2"], w["sigma2"],
                                   rtol=SIGMA2_RTOL)


@pytest.mark.parametrize("field", ["params", "momentum", "ef"])
def test_off_mesh_chaos_state_matches_reference(off_mesh, field):
    """Within STATE_TOL but for top-k threshold flips: an entry kept on
    one side and left in the EF on the other (ROADMAP.md section 3).  At
    most FLIP_SHARE of a field's entries.  Measured: none here (the
    parameters within 1.2e-7); with tau 4, 2 of w_up's 65,536 entries
    3.0e-4 apart in parameters and EF."""
    (_, want, _), (_, got, _) = off_mesh
    assert set(got[field]) == set(want[field])
    off = size = 0
    for k, w in want[field].items():
        close = np.isclose(got[field][k], w, **{"atol": STATE_TOL["atol"],
                                                "rtol": STATE_TOL["rtol"]})
        off += int((~close).sum())
        size += w.size
    assert off <= FLIP_SHARE * size, (field, off, size)


def test_zero_chaos_is_no_chaos_bit_for_bit():
    zero = dict(CHAOS, dropout_prob=0.0, partition_prob=0.0,
                coordinator_fail_prob=0.0)
    a, fa, _ = _off_mesh_history(port=True, chaos=zero)
    b, fb, _ = _off_mesh_history(port=True, chaos=None)
    assert [h["loss"] for h in a] == [h["loss"] for h in b]
    for f in fa:
        for k in fa[f]:
            assert np.array_equal(fa[f][k], fb[f][k]), (f, k)


def _fused_rounds(port: bool, masks_of):
    """ROUNDS of the fused branch (int4 wire, per-cluster levels, no
    wire EF); ``masks_of(rnd)`` gives (alive, conn) or None."""
    kw = dict(tau=2, q=Q, eta=0.1, momentum=0.9, sparse_gossip=True,
              wire_dtype="int4", theta_levels=LEVELS)
    jcfg, _, params0 = _params0()
    theta = quantize_theta(SPARSE_THETA, LEVELS)
    levels = cluster_levels_from_theta(SPARSE_THETA, LEVELS,
                                       np.repeat(np.arange(C), DEV))
    rho = np.array([0.9, 0.7, 1.0, 0.8])
    rng = np.random.default_rng(0)
    if port:
        cfg, topo = smoke_model(get_config("smollm_135m").model), \
            FLTopology(C, DEV)
        hcef = HCEFConfig(**kw)
        state = tround.init_state(cfg, hcef, topo,
                                  params_from_jax(params0, "cpu"),
                                  device="cpu")
        policy = make_train_policy(topo)
    else:
        mesh = make_host_mesh()
        jtopo, jhcef = JTopo(C, DEV), JHCEF(**kw)
        jpolicy = j_policy(mesh, jtopo, dp_axes=("data",))
        state = jround.init_state(jcfg, jhcef, jtopo, jax.random.PRNGKey(0))
        jsteps = {}
    losses = []
    for rnd in range(ROUNDS):
        gossip = (rnd + 1) % Q == 0
        cl = levels if gossip else None
        tokens = rng.integers(0, jcfg.vocab_size, (R * 2 * 2, SEQ))
        mk = masks_of(rnd)
        masks = () if mk is None else (
            np.asarray(mk[0], np.float32),
            tcol.participation_weights(mk[0], clusters=C, dev=DEV),
            np.asarray(mk[1], np.float32))
        if port:
            step = tround.make_round_step(cfg, hcef, topo, policy,
                                          gossip=gossip, impl="ref",
                                          cluster_levels=cl,
                                          bits_fn=jax_bits(2, R))
            state, m = step(state, {"tokens": torch.from_numpy(tokens)},
                            rho, theta, 1000 + rnd,
                            **dict(zip(("alive", "alive_w", "conn"), masks)))
            losses.append(m["loss"].numpy())
        else:
            if (gossip, cl) not in jsteps:
                jsteps[gossip, cl] = _jit(jround.make_round_step(
                    jcfg, jhcef, jtopo, jpolicy, gossip=gossip, impl="ref",
                    cluster_levels=cl), FAST_COMPILE)
            keys = jax.random.split(jax.random.PRNGKey(1000 + rnd), R)
            with mesh:
                state, m = jsteps[gossip, cl](
                    state, {"tokens": jnp.asarray(tokens)},
                    jnp.asarray(rho, jnp.float32),
                    jnp.asarray(theta, jnp.float32), keys,
                    *(jnp.asarray(a) for a in masks))
            losses.append(np.asarray(m["loss"]))
    fields = ("params", "momentum", "ef")
    final = ({f: {k: v.numpy() for k, v in flatten(getattr(state, f)).items()}
              for f in fields} if port else
             {f: _leaves(getattr(state, f)) for f in fields})
    return losses, final


def _gossip_faults(rnd):
    """One dead device every round; cluster 1 cut in the gossip rounds."""
    alive = np.array([1, 1, 1, 0], bool)
    conn = np.array([1, (rnd + 1) % Q != 0], bool)
    return alive, conn


def test_fused_sparse_branch_under_masks_matches_reference():
    want_l, want = _fused_rounds(False, _gossip_faults)
    got_l, got = _fused_rounds(True, _gossip_faults)
    for r in range(ROUNDS):
        np.testing.assert_allclose(got_l[r], want_l[r], rtol=1e-5)
    for f in want:
        for k, w in want[f].items():
            np.testing.assert_allclose(got[f][k], w, err_msg=f"{f} {k}",
                                       **STATE_TOL)
    for v in got["params"].values():  # every device holds its cluster's
        assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])


@pytest.mark.parametrize("fused", [False, True])
def test_dead_partitioned_cluster_keeps_its_model(fused):
    cfg = smoke_model(get_config("smollm_135m").model)
    topo = FLTopology(C, DEV)
    kw = dict(tau=2, q=Q, eta=0.1)
    if fused:
        kw.update(sparse_gossip=True, wire_dtype="int4", theta_levels=LEVELS)
    hcef = HCEFConfig(**kw)
    _, _, params0 = _params0()
    state = tround.init_state(cfg, hcef, topo, params_from_jax(params0,
                                                               "cpu"),
                              device="cpu")
    before = {k: v.clone() for k, v in flatten(state.params).items()}
    step = tround.make_round_step(
        cfg, hcef, topo, make_train_policy(topo) if fused else None,
        gossip=True)
    alive = np.array([1, 1, 0, 0], np.float32)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (R * 2 * 2, SEQ)))
    state, _ = step(state, {"tokens": tokens}, np.ones(R),
                    np.array([0.3, 0.3, 0.6, 0.6]), 3, alive=alive,
                    alive_w=tcol.participation_weights(alive, clusters=C,
                                                       dev=DEV),
                    conn=np.array([1.0, 0.0], np.float32))
    after, ef = flatten(state.params), flatten(state.ef)
    for k, v in after.items():
        assert torch.equal(v[DEV:], before[k][DEV:]), k  # bit for bit
    assert any(bool(e[DEV:].abs().max() > 0) for e in ef.values())
    assert any(not torch.equal(v[:DEV], before[k][:DEV])
               for k, v in after.items())  # the live cluster moved


@pytest.mark.parametrize("fused", [False, True])
def test_all_ones_masks_are_the_unmasked_round_bit_for_bit(fused):
    cfg = smoke_model(get_config("smollm_135m").model)
    topo = FLTopology(C, DEV)
    kw = dict(tau=2, q=Q, eta=0.1)
    if fused:
        kw.update(sparse_gossip=True, wire_dtype="int4", theta_levels=LEVELS)
    hcef = HCEFConfig(**kw)
    _, _, params0 = _params0()
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (R * 2 * 2, SEQ)))
    out = []
    for masks in ({}, dict(alive=np.ones(R), alive_w=np.ones(R),
                           conn=np.ones(C))):
        state = tround.init_state(cfg, hcef, topo,
                                  params_from_jax(params0, "cpu"),
                                  device="cpu")
        step = tround.make_round_step(
            cfg, hcef, topo, make_train_policy(topo) if fused else None,
            gossip=True)
        state, m = step(state, {"tokens": tokens}, np.ones(R),
                        np.array([0.3, 0.3, 0.6, 0.6]), 3, **masks)
        out.append({f: flatten(getattr(state, f))
                    for f in ("params", "ef", "momentum")})
    for f in out[0]:
        for k, v in out[0][f].items():
            assert torch.equal(v, out[1][f][k]), (f, k)


def test_masks_are_checked_as_in_the_reference():
    cfg = smoke_model(get_config("smollm_135m").model)
    topo = FLTopology(C, DEV)
    step = tround.make_round_step(cfg, HCEFConfig(tau=2), topo)
    with pytest.raises(ValueError, match="alive_w"):
        step(None, None, None, None, 0, alive=np.ones(R))
    hcef = HCEFConfig(tau=2, sparse_gossip=True, wire_dtype="int4",
                      wire_ef=True)
    step = tround.make_round_step(cfg, hcef, topo, make_train_policy(topo),
                                  gossip=True)
    with pytest.raises(ValueError, match="wire_ef"):
        step(None, None, None, None, 0, alive=np.ones(R),
             alive_w=np.ones(R), conn=np.ones(C))
