"""The port's degraded-mode pieces against the JAX package's, on the CPU.

The fault plan, the coordinator registry, the straggler deadline, the
participation weights and mixing and the controller on the live subset
are numpy in both packages (the mixing float32): they are held to the
reference with ``==``, the cost model with the masks within 1e-12, the
live-subset controller within 1e-9.  ``fold_dropped_updates`` is held to
its conservation law bit for bit, in f32 and bf16, and to the
reference's fold.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import mixing as jmix  # noqa: E402
from repro.dist import collectives as jcol  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import failover as jfail  # noqa: E402
from repro_torch.core import controller as tctrl  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.dist import collectives as tcol  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl import cost_model as tcost  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.runtime import chaos as tchaos  # noqa: E402
from repro_torch.runtime import failover as tfail  # noqa: E402

COST_TOL = 1e-12  # the cost model: the same numpy arithmetic
LIVE_TOL = 1e-9   # P2 on a live subset (the same solver, other arrays)
CHAOS = dict(dropout_prob=0.3, partition_prob=0.3,
             coordinator_fail_prob=0.3, deadline_slack=1.2)


def _trace(mod, seed, R, C, rounds=10, restore_at=None):
    """A fault plan's trace, with per-device times from the paper's
    heterogeneity model; ``restore_at``: continue from a state_dict taken
    at that round, in a fresh plan."""
    het = HeterogeneityModel(num_devices=R, seed=seed)
    plan = mod.FaultPlan(mod.ChaosConfig(seed=seed, **CHAOS), R, C)
    out, state = [], None
    for rnd in range(rounds):
        if rnd == restore_at:
            state = plan.state_dict()
            plan = mod.FaultPlan(mod.ChaosConfig(seed=seed, **CHAOS), R, C)
            plan.load_state_dict(state)
        rep = het.sample_round(rnd)
        t = tcost.per_device_time(np.ones(R), np.full(R, 0.3), rep.mu,
                                  rep.nu, 4)
        f = plan.step(rnd, gossip_round=rnd % 2 == 1, per_device_time=t,
                      alive=plan.sample_available(rnd))
        out.append((f.alive.tolist(), f.cluster_conn.tolist(),
                    f.coordinator, f.deadline, f.n_deadline_missed))
    return out, state


@pytest.mark.parametrize("seed,R,C", [(0, 4, 2), (1, 8, 4), (7, 64, 8)])
def test_fault_plan_trace_equals_reference(seed, R, C):
    got, _ = _trace(tchaos, seed, R, C)
    want, _ = _trace(jchaos, seed, R, C)
    assert got == want
    # the trace degrades: devices drop and links go down
    assert any(not all(a) for a, *_ in got)
    assert any(not all(c) for _, c, *_ in got)


@pytest.mark.parametrize("seed", [0, 3])
def test_fault_plan_state_dict_round_trips_as_the_reference(seed):
    whole, _ = _trace(tchaos, seed, 8, 4)
    got, sd = _trace(tchaos, seed, 8, 4, restore_at=5)
    want, jsd = _trace(jchaos, seed, 8, 4, restore_at=5)
    assert got == whole == want
    assert sd == jsd


def test_sample_available_equals_reference():
    for seed in (0, 1, 5):
        for R in (1, 4, 64):
            for p in (0.0, 0.2, 0.9):
                cfg = dict(seed=seed, dropout_prob=p)
                t = tchaos.FaultPlan(tchaos.ChaosConfig(**cfg), R, 2)
                j = jchaos.FaultPlan(jchaos.ChaosConfig(**cfg), R, 2)
                for rnd in range(6):
                    a = t.sample_available(rnd)
                    assert np.array_equal(a, j.sample_available(rnd))
                    assert a.any()  # never all dead
    # the issue's trace: seed 0 drops one device of four in rounds 0-3
    plan = tchaos.FaultPlan(tchaos.ChaosConfig(dropout_prob=0.2), 4, 2)
    assert [int(plan.sample_available(r).sum()) for r in range(4)] == [3] * 4


def test_chaos_config_validation():
    for bad in (dict(dropout_prob=1.0), dict(deadline_slack=0.5),
                dict(coordinator_servers=0)):
        with pytest.raises(ValueError):
            tchaos.ChaosConfig(**bad)


def test_straggler_deadline_and_registry_equal_reference():
    rng = np.random.default_rng(0)
    mu = rng.uniform(1, 5, 16)
    for q in (0.5, 0.9):
        for alive in (None, rng.random(16) > 0.4, np.eye(16)[3] > 0,
                      np.zeros(16, bool)):
            assert (tfail.straggler_deadline(mu, 4, q, alive=alive)
                    == jfail.straggler_deadline(mu, 4, q, alive=alive))
    with pytest.raises(ValueError):
        tfail.straggler_deadline(mu, 4, alive=np.ones(3, bool))
    kw = dict(num_servers=3, fail_prob=0.4, recover_prob=0.3, seed=2)
    t, j = tfail.CoordinatorRegistry(**kw), jfail.CoordinatorRegistry(**kw)
    assert [t.step() for _ in range(30)] == [j.step() for _ in range(30)]
    assert t.elections == j.elections > 0
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("C,dev", [(2, 2), (4, 2), (8, 8)])
def test_participation_weights_equal_reference(C, dev):
    rng = np.random.default_rng(C * dev)
    for _ in range(5):
        alive = rng.random(C * dev) > 0.4
        alive[:dev] = False  # a fully dead cluster
        t = tcol.participation_weights(alive, clusters=C, dev=dev)
        assert t.dtype == np.float32
        assert np.array_equal(t, jcol.participation_weights(
            alive, clusters=C, dev=dev))
    ones = tcol.participation_weights(np.ones(C * dev), clusters=C,
                                      dev=dev)
    assert np.array_equal(ones, np.ones(C * dev, np.float32))


@pytest.mark.parametrize("kind", ["ring", "complete", "erdos_renyi"])
@pytest.mark.parametrize("C", [2, 4, 8, 16])
def test_participation_mixing_equals_reference(kind, C):
    H = tmix.make_mixing(kind, C, 0.4, 0)
    rng = np.random.default_rng(C)
    masks = [np.ones(C), np.eye(C)[0], 1 - np.eye(C)[C - 1],
             (rng.random(C) > 0.5).astype(float), np.zeros(C)]
    for conn in masks:
        got = tmix.participation_mixing(H, conn)
        want = np.asarray(jmix.participation_mixing(
            jnp.asarray(H, jnp.float32), jnp.asarray(conn, jnp.float32)))
        assert got.dtype == np.float32
        assert np.array_equal(got, want), conn
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)
    assert np.array_equal(tmix.participation_mixing(H, np.ones(C)),
                          H.astype(np.float32))


def _reports(R, seed=0):
    rep = HeterogeneityModel(num_devices=R, seed=seed).sample_round(2)
    rng = np.random.default_rng(seed)
    return dataclasses.replace(rep, sigma2=rng.uniform(1, 10, R),
                               G2=rng.uniform(0.5, 4, R))


@pytest.mark.parametrize("wire", [None, "int4"])
@pytest.mark.parametrize("gossip", [False, True])
def test_cost_model_masks_match_reference(wire, gossip):
    R = 16
    rep = _reports(R)
    rng = np.random.default_rng(1)
    rho, theta = rng.uniform(0.1, 1, R), rng.uniform(0.05, 1, R)
    cluster_of = np.repeat(np.arange(4), 4)
    alive = rng.random(R) > 0.3
    alive[4:8] = False  # a fully dead cluster
    conn = np.array([1, 0, 1, 1], bool)
    kw = ({} if wire is None else
          dict(wire_dtype=wire, wire_block=1024, dense_bits=32))
    for a, c in ((None, None), (alive, None), (alive, conn)):
        t, tc = tcost.round_time(rho, theta, rep.mu, rep.nu, 5, cluster_of,
                                 backhaul=172.6, gossip=gossip, alive=a,
                                 conn=c, **kw)
        j, jc = jcost.round_time(rho, theta, rep.mu, rep.nu, 5, cluster_of,
                                 backhaul=172.6, gossip=gossip, alive=a,
                                 conn=c, **kw)
        assert abs(t - j) <= COST_TOL * abs(j)
        np.testing.assert_allclose(tc, jc, rtol=COST_TOL)
        e = tcost.round_energy(rho, theta, rep.mu, rep.nu, rep.alpha,
                               rep.p, 5, alive=a, **kw)
        je = jcost.round_energy(rho, theta, rep.mu, rep.nu, rep.alpha,
                                rep.p, 5, alive=a, **kw)
        assert abs(e - je) <= COST_TOL * abs(je)
    np.testing.assert_allclose(
        tcost.per_device_time(rho, theta, rep.mu, rep.nu, 5, **kw),
        jcost.per_device_time(rho, theta, rep.mu, rep.nu, 5, **kw),
        rtol=COST_TOL)
    # a dead cluster costs nothing; a cut link skips its transfer
    _, tc = tcost.round_time(rho, theta, rep.mu, rep.nu, 5, cluster_of,
                             backhaul=172.6, gossip=gossip, alive=alive,
                             conn=conn, **kw)
    assert tc[1] == 0.0


def _budget(mod):
    return mod.BudgetState(time_budget=3e4, energy_budget=4e3, phi=50, q=2,
                           backhaul_time=20.0)


@pytest.mark.parametrize("scheme", ["hcef", "cef"])
def test_controls_on_live_match_reference(scheme):
    rep = _reports(8, seed=3)
    t = tbase.make_controller(scheme, 4)
    j = jbase.make_controller(scheme, 4)
    ones = np.ones(8, bool)
    got = tchaos.controls_on_live(t, rep, _budget(tctrl), ones)
    want = jchaos.controls_on_live(j, rep, _budget(tctrl), ones)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    alive = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)
    got = tchaos.controls_on_live(t, rep, _budget(tctrl), alive)
    want = jchaos.controls_on_live(j, rep, _budget(tctrl), alive)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=LIVE_TOL, atol=LIVE_TOL)
    # dead devices take the floors
    assert np.all(got[0][~alive] == t.rho_min)
    assert np.all(got[1][~alive] == t.theta_min)


def _split(rng, R, L, dtype):
    """Q's exact split of delta + ef_old: top half kept, the rest in EF."""
    x = torch.from_numpy(rng.normal(size=(R, L)).astype(np.float32)).to(
        dtype)
    keep = x.abs() >= x.abs().median(dim=1, keepdim=True).values
    keep[0, 0] = True
    comp = torch.where(keep, x, torch.zeros_like(x))
    ef = torch.where(keep, torch.zeros_like(x), x)
    ef[0, 0] = -0.0  # a kept entry beside a -0 residual
    return x, comp, ef


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_dropped_updates_conserves_exactly(dtype):
    rng = np.random.default_rng(0)
    R, L = 8, 257
    x, comp, ef = _split(rng, R, L, dtype)
    alive = np.array([1, 0, 1, 1, 0, 0, 1, 1], bool)
    contrib, ef_out = tchaos.fold_dropped_updates({"w": comp}, {"w": ef},
                                                  alive)
    assert contrib["w"].dtype == ef_out["w"].dtype == dtype
    assert torch.equal(contrib["w"] + ef_out["w"], x)
    assert torch.equal(contrib["w"] + ef_out["w"], comp + ef)
    assert not contrib["w"][~torch.from_numpy(alive)].any()
    # the reference's fold on the same bits
    jc, je = jchaos.fold_dropped_updates(
        {"w": jnp.asarray(comp.float().numpy())},
        {"w": jnp.asarray(ef.float().numpy())}, jnp.asarray(alive))
    assert np.array_equal(contrib["w"].float().numpy(), np.asarray(jc["w"]))
    assert np.array_equal(ef_out["w"].float().numpy(), np.asarray(je["w"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_dropped_updates_all_alive_is_the_identity(dtype):
    rng = np.random.default_rng(1)
    _, comp, ef = _split(rng, 4, 100, dtype)
    comp[1, 3] = float("nan")
    for alive in (np.ones(4, bool), torch.ones(4)):
        c, e = tchaos.fold_dropped_updates({"w": comp}, {"w": ef}, alive)
        assert torch.equal(c["w"].view(torch.int16 if dtype ==
                                       torch.bfloat16 else torch.int32),
                           comp.view(c["w"].view(torch.int16 if dtype ==
                                     torch.bfloat16 else torch.int32).dtype))
        assert torch.equal(e["w"].view(torch.uint8), ef.view(torch.uint8))
