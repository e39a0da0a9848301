"""The port's FedSim round against the JAX package's.

The numpy copies (controller, heterogeneity, mixing, cost model, synthetic
data) must give the reference's numbers exactly.  The round itself is held
to the reference within the tolerances below, from the same parameters,
data and masked-step bits: one device round, Algorithm 2 and the
aggregation; a 10-round HCEF run shaped like ``benchmarks/common.make_sim``
(the FEMNIST-shaped MLP, budgets that make theta < 1, two gossip rounds);
a save and restore of the port that continues bit for bit; and a
checkpoint written by the reference that restores into the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.resnet20_cifar10 import VisionConfig as JVC  # noqa: E402
from repro.core import controller as jctrl  # noqa: E402
from repro.core import mixing as jmix  # noqa: E402
from repro.core import wire_format as jwire  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl import cost_model as jcost  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.models.vision import make_vision_model as j_model  # noqa: E402
from repro.runtime.driver import FedSim as JFedSim  # noqa: E402
from repro.runtime.driver import FedSimConfig as JFedSimConfig  # noqa: E402
from repro_torch.configs.vision import VisionConfig  # noqa: E402
from repro_torch.core import controller as tctrl  # noqa: E402
from repro_torch.core import mixing as tmix  # noqa: E402
from repro_torch.core import wire_format as twire  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl import cost_model as tcost  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.launch import fedsim as fedsim_launch  # noqa: E402
from repro_torch.models.vision import make_vision_model  # noqa: E402
from repro_torch.runtime.driver import FedSim, FedSimConfig  # noqa: E402

# Tolerances of the port's round against the reference's, both f32 on the
# CPU.  Products and sums run in other orders (XLA vs ATen), measured at
# <= 1e-5 relative on loss, rho, theta, time and energy over 10 rounds;
# sigma^2 and G^2 (a squared norm of a gradient difference) at <= 1e-3.
HIST_RTOL = {"loss": 1e-4, "rho_mean": 1e-4, "theta_mean": 1e-4,
             "time": 1e-4, "energy": 1e-4, "sigma2": 1e-2, "G2": 1e-2}
ACC_ATOL = 1 / 256  # one eval prediction of 256
STATE_TOL = dict(atol=1e-5, rtol=1e-4)
# After rounds with theta < 1 a coordinate at the top-k threshold can be
# kept by one side and dropped by the other (6 of 1.6 M entries after 10
# rounds, <= 3.6e-5 apart, measured): the difference rides the EF buffer.
RUN_TOL = dict(atol=1e-4, rtol=1e-3)

N, C, TAU, Q = 8, 4, 5, 5
N_TRAIN, N_TEST = 2048, 512
BUDGETS = dict(time_budget=8.5e5, energy_budget=2e4, phi=200)


# ---------------------------------------------------------------------------
# numpy copies
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reports(mod_het, seed=3):
    het = mod_het(num_devices=16, model_bits=269_722 * 32, seed=1)
    rep = het.sample_round(seed)
    rng = np.random.default_rng(seed)
    return dataclasses.replace(
        rep, sigma2=rng.uniform(1, 10, 16).astype(np.float32),
        G2=rng.uniform(0.5, 4, 16).astype(np.float32))


def _budget(mod):
    return mod.BudgetState(time_budget=8.5e4, energy_budget=1.5e4, phi=200,
                           q=5, l=3, r=2, time_spent_prev=900.0,
                           energy_spent_prev=80.0, time_spent_this=200.0,
                           energy_spent_this=15.0, backhaul_time=172.6)


@pytest.mark.parametrize("scheme", sorted(tbase.CONTROLLERS))
def test_controllers_match_reference(scheme):
    tr, jr = _reports(HeterogeneityModel), _reports(JHet)
    for f in ("mu", "alpha", "nu", "p", "sigma2", "G2"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    t = tbase.make_controller(scheme, 5).controls(tr, _budget(tctrl))
    j = jbase.make_controller(scheme, 5).controls(jr, _budget(jctrl))
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    diag_t, diag_j = {}, {}
    tctrl.solve_p2(tr, _budget(tctrl), 5, diagnostics=diag_t)
    jctrl.solve_p2(jr, _budget(jctrl), 5, diagnostics=diag_j)
    np.testing.assert_array_equal(diag_t["p21_time_infeasible"],
                                  diag_j["p21_time_infeasible"])


@pytest.mark.parametrize("profile", ["paper_edge", "tpu_pod"])
def test_heterogeneity_matches_reference(profile):
    for n in (4, 64):
        kw = dict(num_devices=n, profile=profile, seed=2)
        t, j = HeterogeneityModel(**kw), JHet(**kw)
        for r in (0, 5):
            a, b = t.sample_round(r), j.sample_round(r)
            for f in ("mu", "alpha", "nu", "p", "sigma2", "G2"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert t.backhaul_time() == j.backhaul_time()


@pytest.mark.parametrize("kind", ["ring", "complete", "erdos_renyi"])
@pytest.mark.parametrize("m", [1, 2, 8])
def test_mixing_matches_reference(kind, m):
    H = tmix.make_mixing(kind, m, 0.4, 0)
    np.testing.assert_array_equal(H, jmix.make_mixing(kind, m, 0.4, 0))
    tmix.check_mixing(H)
    assert tmix.zeta(H) == jmix.zeta(H)


@pytest.mark.parametrize("wire", [None, "f32", "int8", "int4", "fp8"])
@pytest.mark.parametrize("gossip", [False, True])
def test_cost_model_matches_reference(wire, gossip):
    rep = _reports(JHet)
    rng = np.random.default_rng(0)
    rho, theta = rng.uniform(0.1, 1, 16), rng.uniform(0.05, 1, 16)
    cluster_of = np.repeat(np.arange(4), 4)
    kw = ({} if wire is None else
          dict(wire_dtype=wire, wire_block=1024, dense_bits=32))
    t, tc = tcost.round_time(rho, theta, rep.mu, rep.nu, 5, cluster_of,
                             backhaul=172.6, gossip=gossip, **kw)
    j, jc = jcost.round_time(rho, theta, rep.mu, rep.nu, 5, cluster_of,
                             backhaul=172.6, gossip=gossip, **kw)
    assert t == j
    np.testing.assert_array_equal(tc, jc)
    assert (tcost.round_energy(rho, theta, rep.mu, rep.nu, rep.alpha, rep.p,
                               5, **kw)
            == jcost.round_energy(rho, theta, rep.mu, rep.nu, rep.alpha,
                                  rep.p, 5, **kw))
    if wire is not None:
        np.testing.assert_array_equal(
            twire.compression_ratio_bytes(theta, wire_dtype=wire),
            jwire.compression_ratio_bytes(theta, wire_dtype=wire))


def test_synthetic_data_matches_reference():
    for kind in ("cifar", "femnist"):
        for a, b in zip(tsyn.synthetic_images(kind, 64, seed=3, noise=1.0),
                        jsyn.synthetic_images(kind, 64, seed=3, noise=1.0)):
            np.testing.assert_array_equal(a, b)
    y = jsyn.synthetic_images("cifar", 300, seed=0)[1]
    for a, b in zip(tsyn.dirichlet_partition(y, 8, 0.5, seed=1),
                    jsyn.dirichlet_partition(y, 8, 0.5, seed=1)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the round
# ---------------------------------------------------------------------------

def jax_bits(tau, n):
    """The reference's masked-step bits for a key integer (driver.py:183,
    :371), as the port's ``bits_fn``."""
    def bits(key, rho):
        keys = jax.random.split(jax.random.PRNGKey(key), n)
        r = jnp.clip(jnp.asarray(rho, jnp.float32), 0.0, 1.0)
        draw = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (tau,)))
        return np.asarray(draw(keys, r), np.float32)
    return bits


def _data(syn):
    X, Y = syn.synthetic_images("femnist", N_TRAIN, seed=0, noise=1.25)
    Xt, Yt = syn.synthetic_images("femnist", N_TEST, seed=1, noise=1.25)
    parts = syn.dirichlet_partition(Y, N, beta=1.0, seed=0)
    return [(X[p], Y[p]) for p in parts], (Xt, Yt)


def make_pair(**cfg_kw):
    """(reference FedSim, port FedSim on the CPU) as make_sim("hcef",
    dataset="femnist") builds them, at N devices in C clusters, from the
    same parameters, data and bits."""
    kw = {**dict(n_devices=N, n_clusters=C, tau=TAU, q=Q, eta=0.02,
                 batch_size=50, seed=0), **cfg_kw}
    jvc = JVC(name="mlp-femnist", kind="mlp", image_size=28, channels=1,
              num_classes=62)
    j_init, j_loss, j_acc, _ = j_model(jvc)
    params0 = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    bits = 32.0 * sum(p.size for p in params0.values())
    data, test = _data(jsyn)
    ref = JFedSim(JFedSimConfig(**kw), init_fn=j_init, loss_fn=j_loss,
                  acc_fn=j_acc, device_data=data, test_data=test,
                  controller=jbase.make_controller("hcef", TAU),
                  het=JHet(num_devices=N, model_bits=bits, seed=0),
                  **BUDGETS)
    tvc = VisionConfig(name="mlp-femnist", kind="mlp", image_size=28,
                       channels=1, num_classes=62)
    _, t_loss, t_acc, _ = make_vision_model(tvc)
    data, test = _data(tsyn)
    port = FedSim(FedSimConfig(**kw), params0=params0, loss_fn=t_loss,
                  acc_fn=t_acc, device_data=data, test_data=test,
                  controller=tbase.make_controller("hcef", TAU),
                  het=HeterogeneityModel(num_devices=N, model_bits=bits,
                                         seed=0),
                  bits_fn=jax_bits(TAU, N), device="cpu", **BUDGETS)
    return ref, port


def _close_trees(got, want, tol=STATE_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)


def _close_history(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert set(g) == set(w), (set(g) ^ set(w))
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (w["round"], k,
                                                          g[k], w[k])
        if "acc" in w:
            assert abs(g["acc"] - w["acc"]) <= ACC_ATOL


def test_device_round_stats_and_aggregate_match_reference():
    ref, port = make_pair()
    rng = np.random.default_rng(4)
    # one round's worth of state away from the initial one
    params = {k: v + 0.01 * rng.normal(size=v.shape).astype(np.float32)
              for k, v in jax.tree.map(np.asarray, ref.params).items()}
    mom = {k: 0.1 * rng.normal(size=v.shape).astype(np.float32)
           for k, v in params.items()}
    port.params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    port.mom = {k: torch.from_numpy(v.copy()) for k, v in mom.items()}
    imgs = rng.normal(size=(N, TAU + 2, 50, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 62, (N, TAU + 2, 50)).astype(np.int32)
    rho = rng.uniform(0.1, 1.0, N)
    key = 12345

    jb = {"images": jnp.asarray(imgs[:, :TAU]),
          "labels": jnp.asarray(labels[:, :TAU])}
    keys = jax.random.split(jax.random.PRNGKey(key), N)
    j_delta, j_mom, j_loss = ref._device_round(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in mom.items()}, jb, keys,
        jnp.asarray(rho, jnp.float32))
    bits = torch.from_numpy(jax_bits(TAU, N)(key, rho))
    assert 0 < float(bits.mean()) < 1  # some steps masked, some not
    tb = {"images": torch.from_numpy(imgs[:, :TAU]),
          "labels": torch.from_numpy(labels[:, :TAU])}
    t_delta, t_mom, t_loss = port.device_round(tb, bits)
    _close_trees(t_delta, j_delta)
    _close_trees(t_mom, j_mom)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss),
                               **STATE_TOL)

    j_s2, j_G2 = ref._stats({k: jnp.asarray(v) for k, v in params.items()},
                            {"images": jnp.asarray(imgs[:, TAU]),
                             "labels": jnp.asarray(labels[:, TAU])},
                            {"images": jnp.asarray(imgs[:, TAU + 1]),
                             "labels": jnp.asarray(labels[:, TAU + 1])})
    t_s2, t_G2 = port.stats(
        {"images": torch.from_numpy(imgs[:, TAU]),
         "labels": torch.from_numpy(labels[:, TAU])},
        {"images": torch.from_numpy(imgs[:, TAU + 1]),
         "labels": torch.from_numpy(labels[:, TAU + 1])})
    np.testing.assert_allclose(t_s2.numpy(), np.asarray(j_s2), rtol=1e-4)
    np.testing.assert_allclose(t_G2.numpy(), np.asarray(j_G2), rtol=1e-4)

    comp = {k: 0.01 * rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()}
    for gossip in (False, True):
        j_new = ref._aggregate({k: jnp.asarray(v) for k, v in params.items()},
                               {k: jnp.asarray(v) for k, v in comp.items()},
                               jnp.asarray(gossip))
        t_new = port.aggregate({k: torch.from_numpy(v)
                                for k, v in comp.items()}, gossip)
        _close_trees(t_new, j_new, dict(atol=1e-6, rtol=1e-6))
        # every device of a cluster holds the cluster's model
        w = t_new["w0"].reshape(C, N // C, -1)
        assert torch.equal(w, w[:, :1].expand_as(w))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """10 rounds of each, with a checkpoint of each after round 5."""
    d = tmp_path_factory.mktemp("fedsim")
    ref, port = make_pair()
    ref_hist = ref.run(10, eval_every=5, ckpt_dir=d / "ref", ckpt_every=5)
    port_hist = port.run(10, eval_every=5, ckpt_dir=d / "port",
                         ckpt_every=5)
    return dict(ref=ref, port=port, ref_hist=ref_hist, port_hist=port_hist,
                ref_ckpt=d / "ref" / "ckpt_000005.npz",
                port_ckpt=d / "port" / "ckpt_000005.npz")


def test_ten_round_hcef_history_matches_reference(runs):
    hist = runs["port_hist"]
    assert len(hist) == 10 and [h["round"] for h in hist] == list(
        range(1, 11))
    # two gossip rounds (q = 5), Q really drops coordinates, rho adapts
    assert runs["port"].budget.l == 2
    assert min(h["theta_mean"] for h in hist) < 0.9
    assert max(h["rho_mean"] for h in hist) > 0.1
    assert all(b["time"] > a["time"] and b["energy"] > a["energy"]
               for a, b in zip(hist, hist[1:]))
    _close_history(hist, runs["ref_hist"])
    _close_trees(runs["port"].params, runs["ref"].params, RUN_TOL)


def test_port_restore_continues_bit_for_bit(runs):
    _, port = make_pair()
    port.restore(runs["port_ckpt"])
    assert port.round == 5 and len(port.history) == 5
    port.run(5, eval_every=5)
    assert port.history == runs["port_hist"]
    for k, v in runs["port"].params.items():
        assert torch.equal(port.params[k], v)
        assert torch.equal(port.ef[k], runs["port"].ef[k])
        assert torch.equal(port.mom[k], runs["port"].mom[k])


def test_reference_checkpoint_restores_into_port(runs):
    _, port = make_pair()
    port.restore(runs["ref_ckpt"])
    with np.load(runs["ref_ckpt"]) as ck:
        for k, v in port.params.items():
            np.testing.assert_array_equal(v.numpy(), ck[f"params/{k}"])
            np.testing.assert_array_equal(port.ef[k].numpy(), ck[f"ef/{k}"])
    assert port.round == 5 and port.budget.l == 1
    port.run(5, eval_every=5)
    _close_history(port.history[5:], runs["ref_hist"][5:])
    _close_trees(port.params, runs["ref"].params, RUN_TOL)


def test_sparse_gossip_and_fedprox_match_reference():
    """theta rounded up to the wire's levels, the int4 wire's byte ratio
    in the cost model, per-cluster levels, and the FedProx objective."""
    ref, port = make_pair(q=2, sparse_gossip=True, wire_dtype="int4",
                          local_objective="fedprox", prox_mu=0.1)
    want = ref.run(3, eval_every=3)
    got = port.run(3, eval_every=3)
    _close_history(got, want)
    levels = set(ref.cfg.theta_levels)
    for g, w in zip(got, want):
        assert g["cluster_levels"] == w["cluster_levels"]
        assert set(g["cluster_levels"]) <= levels


def test_unported_modes_raise_naming_the_roadmap():
    ref, port = make_pair()
    data = [(port._X[:8].numpy(), port._Y[:8].numpy())] * N
    kw = dict(params0={"w": np.zeros(2, np.float32)}, loss_fn=None,
              acc_fn=None, device_data=data, test_data=(data[0]),
              controller=tbase.make_controller("hcef", TAU),
              het=HeterogeneityModel(num_devices=N), device="cpu")
    # fault injection and population mode are ported: FedSim takes them,
    # with the reference's own checks on a population
    from repro_torch.runtime.chaos import ChaosConfig
    sim = FedSim(FedSimConfig(n_devices=N, n_clusters=C),
                 chaos=ChaosConfig(dropout_prob=0.2), **kw)
    assert sim.fault_plan is not None and sim.pop_store is None
    with pytest.raises(ValueError, match="population"):
        FedSim(FedSimConfig(n_devices=N, n_clusters=C, population=2 * N),
               **kw)
    with pytest.raises(ValueError, match="data"):
        FedSim(FedSimConfig(n_devices=N, n_clusters=C, population=2 * N),
               **dict(kw, het=HeterogeneityModel(num_devices=N,
                                                 population=2 * N)))


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = ["--model", "mlp", "--devices", "2", "--clusters", "1",
            "--n-train", "64", "--rounds", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        fedsim_launch.main(args)
    fedsim_launch.main(args + ["--device", "cpu"])  # only when asked
