"""The port's HCEF round step against the JAX package's, on the CPU.

A 4-round history on the smoke mamba2 (f32) at the train launcher's host
topology (2 clusters x 2 devices), tau = 4 and q = 2 (rounds 2 and 4
gossip), under ``examples/quickstart.py``'s budgets (3e4 s, 4e3 J) spread
over phi = 50 global rounds, which makes theta < 1 in every round
(quickstart's phi = 12 leaves theta = 1 in the first four).  Each package
runs its own controller, heterogeneity model and cost model, from the
reference's ``init_state`` parameters, the same token batches (the
launcher's numpy stream) and the reference's masked-step bits
(``jax.random.bernoulli`` per device, handed to the port as its
``bits_fn``).  Loss, rho, theta, the g2 / sigma2 statistics, the simulated
time and energy and the final parameters, momentum and EF are compared.
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
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.configs.base import FLTopology, HCEFConfig  # noqa: E402
from repro_torch.core import controller as tctrl  # noqa: E402
from repro_torch.core import round as tround  # noqa: E402
from repro_torch.data.synthetic import synthetic_tokens  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl import cost_model as tcost  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ROUNDS, TAU, Q, SEQ, N_SEQ = 4, 4, 2, 33, 32
HCEF = dict(tau=TAU, q=Q, eta=0.1, momentum=0.9)
BUDGET = dict(time_budget=3e4, energy_budget=4e3, phi=50, q=Q)
MODEL_BITS = 2.3e6 * 32

# f32 on the CPU.  Measured over the 4 rounds: loss, controls, time and
# energy equal; g2 within 5.4e-7 and sigma2 (a difference of squared
# gradient norms) within 2.8e-6 relative; parameters, momentum and EF
# within 6e-7.  A delta entry at a block's top-k threshold can be kept on
# one side and left in the EF on the other (ROADMAP.md section 3), which
# the state's atol 1e-4 allows for, as the FedSim tests do.
HIST_RTOL = {"loss": 1e-5, "rho_mean": 1e-6, "theta_mean": 1e-6,
             "time": 1e-6, "energy": 1e-6}
G2_RTOL, SIGMA2_RTOL = 1e-5, 1e-4
STATE_TOL = dict(atol=1e-4, rtol=1e-3)


def jax_bits(tau, n):
    """The reference's masked-step bits for a key integer (round.py:220
    under vmap over split keys), as the port's ``bits_fn``."""
    def bits(key, rho):
        keys = jax.random.split(jax.random.PRNGKey(key), n)
        r = jnp.clip(jnp.asarray(rho, jnp.float32), 0.0, 1.0)
        draw = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (tau,)))
        return np.asarray(draw(keys, r), np.float32)
    return bits


def _jit(fn, compiler_options=None):
    """``jax.jit(fn)``, compiled on its first call with XLA's
    ``compiler_options`` where given."""
    jitted = jax.jit(fn)
    if not compiler_options:
        return jitted
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jitted.lower(*args).compile(
                compiler_options=compiler_options))
        return compiled[0](*args)
    return call


def _history(port: bool, arch: str = "mamba2_1p3b", rounds: int = ROUNDS,
             q: int = Q, compiler_options=None):
    """``rounds`` rounds of each package's make_round_step on ``arch``'s
    smoke model, gossip every ``q``-th, driven as the train launcher
    drives it; the reference's steps compiled with ``compiler_options``.
    Returns (history, final state as numpy, the state)."""
    hcef_kw, budget_kw = dict(HCEF, q=q), dict(BUDGET, q=q)
    jcfg = j_smoke(j_get_config(arch).model)
    jtopo = JTopo(clusters=2, devices_per_cluster=2)
    R = jtopo.num_devices
    jstate = jround.init_state(jcfg, JHCEF(**hcef_kw), jtopo,
                               jax.random.PRNGKey(0))
    if port:
        cfg = smoke_model(get_config(arch).model)
        hcef, topo = HCEFConfig(**hcef_kw), FLTopology(2, 2)
        params0 = jax.tree.map(lambda x: np.asarray(x[0]), jstate.params)
        state = tround.init_state(cfg, hcef, topo, params0, device="cpu")
        steps = {g: tround.make_round_step(cfg, hcef, topo, gossip=g,
                                           bits_fn=jax_bits(TAU, R))
                 for g in (False, True)}
        ctrl, Het, cost, Budget = tbase, HeterogeneityModel, tcost, \
            tctrl.BudgetState
    else:
        state = jstate
        steps = {g: _jit(jround.make_round_step(jcfg, JHCEF(**hcef_kw),
                                                jtopo, gossip=g),
                         compiler_options)
                 for g in (False, True)}
        ctrl, Het, cost, Budget = jbase, JHet, jcost, jctrl.BudgetState
    controller = ctrl.make_controller("hcef", TAU)
    het = Het(num_devices=R, model_bits=MODEL_BITS)
    budget = Budget(backhaul_time=het.backhaul_time(), **budget_kw)
    cluster_of = np.repeat(np.arange(2), 2)
    corpus = synthetic_tokens(jcfg.vocab_size, n_seq=N_SEQ, seq_len=SEQ,
                              n_devices=R, beta=0.5)
    rng = np.random.default_rng(0)
    hist = []
    for rnd in range(rounds):
        reports = het.sample_round(rnd)
        rho, theta = controller.controls(reports, budget)
        gossip = (rnd + 1) % q == 0
        idx = rng.integers(0, N_SEQ, (R, 2 * TAU))
        tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
        if port:
            state, m = steps[gossip](state, {"tokens": torch.from_numpy(
                tokens)}, rho, theta, 1000 + rnd)
            m = {k: v.numpy() for k, v in m.items()}
        else:
            keys = jax.random.split(jax.random.PRNGKey(1000 + rnd), R)
            state, m = steps[gossip](
                state, {"tokens": jnp.asarray(tokens)},
                jnp.asarray(rho, jnp.float32),
                jnp.asarray(theta, jnp.float32), keys)
            m = jax.tree.map(np.asarray, m)
        t, _ = cost.round_time(rho, theta, reports.mu, reports.nu, TAU,
                               cluster_of, gossip=gossip,
                               backhaul=het.backhaul_time())
        e = cost.round_energy(rho, theta, reports.mu, reports.nu,
                              reports.alpha, reports.p, TAU)
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
    if port:
        final = {f: {k: v.float().numpy() for k, v in
                     flatten(getattr(state, f)).items()}
                 for f in ("params", "momentum", "ef")}
    else:
        final = {f: {"/".join(str(k.key) for k in path): np.asarray(v)
                     for path, v in jax.tree_util.tree_flatten_with_path(
                         getattr(state, f))[0]}
                 for f in ("params", "momentum", "ef")}
    return hist, final, state


@pytest.fixture(scope="module")
def histories():
    return _history(port=False), _history(port=True)


def test_four_round_history_matches_reference(histories):
    (want, _, _), (got, _, state) = histories
    assert state.round_idx == ROUNDS
    # two gossip rounds; Q drops coordinates in some round; some steps
    # masked and some not
    assert min(h["theta_mean"] for h in got) < 1.0
    steps = np.concatenate([h["steps"] for h in got])
    assert steps.min() < TAU and steps.max() > 0
    assert all(b["time"] > a["time"] and b["energy"] > a["energy"]
               for a, b in zip(got, got[1:]))
    for r, (g, w) in enumerate(zip(got, want)):
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (r, k, g[k], w[k])
        np.testing.assert_array_equal(g["steps"], w["steps"])
        np.testing.assert_allclose(g["g2"], w["g2"], rtol=G2_RTOL)
        np.testing.assert_allclose(g["sigma2"], w["sigma2"],
                                   rtol=SIGMA2_RTOL)


@pytest.mark.parametrize("field", ["params", "momentum", "ef"])
def test_final_state_matches_reference(histories, field):
    (_, want, _), (_, got, _) = histories
    assert set(got[field]) == set(want[field])
    for k, w in want[field].items():
        np.testing.assert_allclose(got[field][k], w, err_msg=k, **STATE_TOL)
    if field == "params":  # every device of a cluster holds its model
        for v in got[field].values():
            assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])


def test_unported_options_raise_naming_the_roadmap():
    # the overlap options are ported, with the reference's own checks
    HCEFConfig(overlap=True, staleness=1)
    with pytest.raises(ValueError, match="requires overlap"):
        HCEFConfig(staleness=1)
    # the wire options are ported, with the reference's own checks
    with pytest.raises(ValueError, match="sparse_gossip"):
        HCEFConfig(wire_ef=True)
    # the dense, moe and ssm families train; the others wait for their item
    cfg = smoke_model(get_config("smollm_135m").model).replace(
        family="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tround.make_round_step(cfg, HCEFConfig(), FLTopology(2, 2))
