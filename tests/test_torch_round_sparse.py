"""The port's fused round step (the sparse gossip wire) against the JAX
package's mesh branch on a one-device mesh, on the CPU.

The reference runs ``make_round_step(..., policy=make_train_policy(
make_host_mesh(), topo, dp_axes=("data",)))`` under ``jax.jit`` and ``with
mesh:``: at one shard its fused branch is layout B with every cluster
local, which is what the port's policy selects.  Smoke mamba2 (f32), 2
clusters x 2 devices, tau = 2, 4 rounds with q = 2 (rounds 2 and 4
gossip), sparse gossip over the int4 wire on the level grid (0.1, 0.6,
1), the per-device theta (0.05, 0.1, 0.4, 0.6) giving per-cluster levels
(0.1, 0.6): two plans, partial rotations and zero payloads.  Round 2 passes ``cluster_levels``, round 4
the traced-theta fallback (the smallest level >= max theta).  Without
the CHOCO wire error feedback here, with it in
tests/test_torch_round_wire_ef.py.  Both run the exact
top-k (``impl="ref"``: the reference's CPU route for Q and the wire), the
weights come over with ``convert.params_from_jax`` and the masked-step
bits are the reference's.  Tolerances as tests/test_torch_round.py's.

Also the train launcher's ``--mesh host --sparse-gossip --wire-dtype
int4``: theta quantized to the grid and the wire's bytes charged, against
the reference launcher's arithmetic, and ``--wire-ef`` raising there as
the reference's round step does.
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
from repro.core.compression import quantize_theta as j_quantize  # noqa: E402
from repro.dist.policies import make_train_policy as j_policy  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.configs.base import FLTopology, HCEFConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    cluster_levels_from_theta, quantize_theta)
from repro_torch.dist.mesh import RankMesh  # noqa: E402
from repro_torch.dist.policies import make_train_policy  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_round import FAST_COMPILE, _jit  # noqa: E402

ROUNDS, TAU, Q, SEQ = 4, 2, 2, 33
RHO = np.array([0.9, 0.7, 1.0, 0.8])
THETA = np.array([0.05, 0.1, 0.4, 0.6])
# a short grid keeps the reference's traced-theta switch (one branch a
# level) quick to compile
LEVELS = (0.1, 0.6, 1.0)
HIST_RTOL = 1e-5
STATE_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_bits(tau, n):
    def bits(key, rho):
        keys = jax.random.split(jax.random.PRNGKey(key), n)
        r = jnp.clip(jnp.asarray(rho, jnp.float32), 0.0, 1.0)
        draw = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (tau,)))
        return np.asarray(draw(keys, r), np.float32)
    return bits


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _run(wire_ef: bool, fallback: bool = True):
    """Both packages' 4 rounds; returns {side: (losses, theta_wire, final
    state fields as numpy)}.  ``fallback``: round 4 takes the traced-theta
    fallback instead of the static levels."""
    kw = dict(tau=TAU, q=Q, eta=0.1, momentum=0.9, sparse_gossip=True,
              wire_dtype="int4", wire_ef=wire_ef, theta_levels=LEVELS)
    jcfg = j_smoke(j_get_config("mamba2_1p3b").model)
    jtopo, jhcef = JTopo(clusters=2, devices_per_cluster=2), JHCEF(**kw)
    cfg = smoke_model(get_config("mamba2_1p3b").model)
    topo, hcef = FLTopology(2, 2), HCEFConfig(**kw)
    R = topo.num_devices
    theta = quantize_theta(THETA, hcef.theta_levels)
    levels = cluster_levels_from_theta(THETA, hcef.theta_levels,
                                       np.repeat(np.arange(2), 2))
    assert levels == (0.1, 0.6)
    mesh = make_host_mesh()
    jpolicy = j_policy(mesh, jtopo, dp_axes=("data",))
    jstate = jround.init_state(jcfg, jhcef, jtopo, jax.random.PRNGKey(0))
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate.params)
    state = tround.init_state(cfg, hcef, topo,
                              params_from_jax(params0, "cpu"), device="cpu")
    policy = make_train_policy(topo)
    rng = np.random.default_rng(0)
    out = {"ref": ([], []), "port": ([], [])}
    jsteps = {}
    for rnd in range(ROUNDS):
        gossip = (rnd + 1) % Q == 0
        cl = levels if gossip and not (rnd == 3 and fallback) else None
        tokens = rng.integers(0, cfg.vocab_size, (R * TAU * 2, SEQ))
        if (gossip, cl) not in jsteps:
            jsteps[gossip, cl] = _jit(jround.make_round_step(
                jcfg, jhcef, jtopo, jpolicy, gossip=gossip, impl="ref",
                cluster_levels=cl), FAST_COMPILE)
        step = jsteps[gossip, cl]
        keys = jax.random.split(jax.random.PRNGKey(1000 + rnd), R)
        with mesh:
            jstate, jm = step(jstate, {"tokens": jnp.asarray(tokens)},
                              jnp.asarray(RHO, jnp.float32),
                              jnp.asarray(theta, jnp.float32), keys)
        tstep = tround.make_round_step(
            cfg, hcef, topo, policy, gossip=gossip, impl="ref",
            cluster_levels=cl, bits_fn=jax_bits(TAU, R))
        state, m = tstep(state, {"tokens": torch.from_numpy(tokens)}, RHO,
                         theta, 1000 + rnd)
        for side, met in (("ref", jax.tree.map(np.asarray, jm)),
                          ("port", {k: v.numpy() for k, v in m.items()})):
            out[side][0].append(met["loss"])
            out[side][1].append(met.get("theta_wire"))
    fields = ("params", "momentum", "ef") + (("wire_ef",) if wire_ef else ())
    finals = {"ref": {f: _leaves(getattr(jstate, f)) for f in fields},
              "port": {f: {k: v.numpy() for k, v in
                           flatten(getattr(state, f)).items()}
                       for f in fields}}
    return {s: out[s] + (finals[s],) for s in out}, state


def check_history(res, state):
    """Losses within HIST_RTOL; theta_wire 0.6 on both gossip rounds."""
    (jl, jtw, _), (tl, ttw, _) = res["ref"], res["port"]
    assert state.round_idx == ROUNDS
    for r in range(ROUNDS):
        np.testing.assert_allclose(tl[r], jl[r], rtol=HIST_RTOL)
        if (r + 1) % Q:
            assert ttw[r] is None and jtw[r] is None
        else:
            assert float(ttw[r]) == float(jtw[r]) == np.float32(0.6)


def check_final_state(res, wire_ef):
    """Parameters, momentum, EF (and the wire-EF estimates) within
    STATE_TOL; every device of a cluster holds its model."""
    want, got = res["ref"][2], res["port"][2]
    assert set(got) == set(want)
    for field in want:
        assert set(got[field]) == set(want[field]), field
        for k, w in want[field].items():
            np.testing.assert_allclose(got[field][k], w, err_msg=f"{field} "
                                       f"{k}", **STATE_TOL)
    for v in got["params"].values():
        assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])
    if wire_ef:
        moved = max(np.abs(v).max() for v in got["wire_ef"].values())
        assert moved > 0


@pytest.fixture(scope="module")
def runs():
    return _run(wire_ef=False)


def test_history_matches_reference(runs):
    check_history(*runs)


def test_final_state_matches_reference(runs):
    check_final_state(runs[0], wire_ef=False)


def test_fused_branch_raises_like_the_reference():
    cfg = smoke_model(get_config("mamba2_1p3b").model)
    topo = FLTopology(2, 2)
    hcef = HCEFConfig(sparse_gossip=True, wire_dtype="int4", wire_ef=True)
    with pytest.raises(ValueError, match="mesh policy"):
        tround.make_round_step(cfg, hcef, topo, gossip=True)
    with pytest.raises(ValueError, match="mesh policy"):
        tround.make_round_step(cfg, HCEFConfig(sparse_gossip=True), topo,
                               cluster_levels=(0.1, 0.6))
    with pytest.raises(ValueError, match="theta_levels"):
        tround.make_round_step(cfg, hcef, topo, make_train_policy(topo),
                               cluster_levels=(0.1, 0.3))
    with pytest.raises(ValueError, match="sparse_gossip"):
        tround.make_round_step(cfg, HCEFConfig(), topo,
                               make_train_policy(topo),
                               cluster_levels=(0.1, 0.6))
    # the rank mesh's policy: R = 4 does not tile 3 data ranks (a mesh of
    # 3 x 1 needs no process group to be made)
    with pytest.raises(ValueError, match="do not tile"):
        make_train_policy(RankMesh((3, 1), ("data", "model"), world=3),
                          topo, dp_axes=("data",))


def test_launcher_sparse_gossip_history_matches_reference_arithmetic(capsys):
    """--mesh host --sparse-gossip --wire-dtype int4: no policy, so the
    dense aggregate runs, but theta is quantized and the simulated time
    and energy charge the int4 wire (dense_bits=16), as the reference's
    launcher does (train.py:256-299).  Its controller, heterogeneity and
    cost model replayed here give the same numbers."""
    rounds = 4
    out = train.main(["--device", "cpu", "--arch", "mamba2_1p3b",
                      "--rounds", str(rounds), "--seq", "40",
                      "--sparse-gossip", "--wire-dtype", "int4"])
    hcef = j_get_config("mamba2_1p3b").hcef
    R = 4
    cluster_of = np.repeat(np.arange(2), 2)
    het = JHet(num_devices=R, model_bits=out["n_params"] * 16)
    budget = jctrl.BudgetState(
        time_budget=hcef.time_budget or np.inf,
        energy_budget=hcef.energy_budget or np.inf,
        phi=max(rounds // hcef.q, 1), q=hcef.q,
        backhaul_time=het.backhaul_time())
    controller = jbase.make_controller("hcef", hcef.tau)
    wire_kw = dict(wire_dtype="int4", wire_block=hcef.wire_block,
                   dense_bits=16)
    for rnd, rec in enumerate(out["history"]):
        reports = het.sample_round(rnd)
        rho, theta = controller.controls(reports, budget)
        theta = j_quantize(theta, hcef.theta_levels)
        gossip = (rnd + 1) % hcef.q == 0
        t, _ = jcost.round_time(rho, theta, reports.mu, reports.nu,
                                hcef.tau, cluster_of, gossip=gossip,
                                backhaul=het.backhaul_time(), **wire_kw)
        e = jcost.round_energy(rho, theta, reports.mu, reports.nu,
                               reports.alpha, reports.p, hcef.tau,
                               **wire_kw)
        budget.time_spent_this += t
        budget.energy_spent_this += e
        budget.r += 1
        if gossip:
            budget.time_spent_prev += budget.time_spent_this
            budget.energy_spent_prev += budget.energy_spent_this
            budget.time_spent_this = budget.energy_spent_this = 0.0
            budget.r = 0
            budget.l += 1
        assert rec["gossip"] == gossip
        assert rec["theta_mean"] == pytest.approx(float(np.mean(theta)),
                                                  rel=1e-12)
        assert rec["time"] == pytest.approx(
            budget.time_spent_prev + budget.time_spent_this, rel=1e-12)
        assert rec["energy"] == pytest.approx(
            budget.energy_spent_prev + budget.energy_spent_this, rel=1e-12)
        assert np.isfinite(rec["loss"])
    # the wire is charged: the int4 payload is a fraction of the dense one
    dense = train.main(["--device", "cpu", "--arch", "mamba2_1p3b",
                        "--rounds", str(rounds), "--seq", "40"])
    assert out["history"][-1]["time"] < dense["history"][-1]["time"]
    capsys.readouterr()


def test_launcher_wire_ef_on_the_host_mesh_raises():
    argv = ["--device", "cpu", "--arch", "mamba2_1p3b", "--rounds", "1",
            "--seq", "40"]
    with pytest.raises(ValueError, match="mesh policy"):
        train.main(argv + ["--sparse-gossip", "--wire-ef"])
    with pytest.raises(ValueError, match="sparse_gossip"):
        train.main(argv + ["--wire-ef"])


def test_cluster_levels_of_quantized_theta_match_reference():
    """The reference's launcher passes the float32 quantized theta to
    ``cluster_levels_from_theta``, which quantizes it again: each float32
    level lies above its float64 grid value, so the cluster's wire level
    rises one step (0.1 -> 0.2, 0.6 -> 0.8; ROADMAP.md section 3).  The
    port's copy does the same."""
    from repro.core.compression import cluster_levels_from_theta as j_cl
    lv = HCEFConfig().theta_levels  # the default grid
    cl = np.repeat(np.arange(2), 2)
    q = quantize_theta(THETA, lv)
    np.testing.assert_array_equal(q, j_quantize(THETA, lv))
    assert cluster_levels_from_theta(q, lv, cl) == j_cl(q, lv, cl) == \
        (0.2, 0.8)
    assert cluster_levels_from_theta(THETA, lv, cl) == (0.1, 0.6)


def test_fused_dense_gossip_matches_the_off_mesh_round():
    """With a policy but no sparse gossip, the fused branch mixes with
    ``mix_local`` (the per-cluster mean, then H); on f32 parameters that
    is the off-mesh round's (C, R) GEMM up to the order of f32 sums."""
    cfg = smoke_model(get_config("mamba2_1p3b").model)
    topo, hcef = FLTopology(2, 2), HCEFConfig(tau=TAU, q=Q, eta=0.1)
    params0 = params_from_jax(jax.tree.map(
        lambda x: np.asarray(x[0]), jround.init_state(
            j_smoke(j_get_config("mamba2_1p3b").model), JHCEF(),
            JTopo(2, 2), jax.random.PRNGKey(0)).params), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4 * TAU * 2, SEQ)))
    out = {}
    for name, policy in (("off_mesh", None),
                         ("fused", make_train_policy(topo))):
        state = tround.init_state(cfg, hcef, topo, params0, device="cpu")
        step = tround.make_round_step(cfg, hcef, topo, policy, gossip=True,
                                      bits_fn=jax_bits(TAU, 4))
        state, m = step(state, {"tokens": tokens}, RHO, THETA, 5)
        assert "theta_wire" not in m
        out[name] = flatten(state.params)
    for k, v in out["off_mesh"].items():
        np.testing.assert_allclose(out["fused"][k].numpy(), v.numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=k)
