"""The port's FedSim under fault injection and in population mode
against the JAX package's, on the CPU (the FEMNIST-shaped MLP at 8
devices in 4 clusters, as tests/test_torch_fedsim.py runs it).

  * chaos (dropout, deadline misses, partitions on gossip rounds,
    coordinator churn) and population mode (a cohort of 8 of 40 clients a
    round, per-client shards, energy caps, the store): the histories
    within tests/test_torch_fedsim.py's tolerances, the chaos records and
    cohorts equal, the final state within its run tolerance but for
    top-k threshold flips (at most FLIP_SHARE of the entries);
  * in the port, population == n_devices is bit for bit the fixed
    roster, and a chaos plan at zero probabilities bit for bit no chaos;
  * a chaos run in population mode restores from a checkpoint and
    continues bit for bit.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.configs.resnet20_cifar10 import VisionConfig as JVC  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.fl import baselines as jbase  # noqa: E402
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa: E402
from repro.models.vision import make_vision_model as j_model  # noqa: E402
from repro.runtime.chaos import ChaosConfig as JChaos  # noqa: E402
from repro.runtime.driver import FedSim as JFedSim  # noqa: E402
from repro.runtime.driver import FedSimConfig as JFedSimConfig  # noqa: E402
from repro_torch.configs.vision import VisionConfig  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.fl import baselines as tbase  # noqa: E402
from repro_torch.fl.heterogeneity import HeterogeneityModel  # noqa: E402
from repro_torch.models.vision import make_vision_model  # noqa: E402
from repro_torch.runtime.chaos import ChaosConfig  # noqa: E402
from repro_torch.runtime.driver import FedSim, FedSimConfig  # noqa: E402

from test_torch_fedsim import (BUDGETS, C, N, RUN_TOL, TAU,  # noqa: E402
                               _close_history, _data, jax_bits)

ROUNDS = 4
CHAOS = dict(seed=1, dropout_prob=0.25, partition_prob=0.4,
             coordinator_fail_prob=0.3)
POP = 40
# After rounds with theta < 1 an entry at a block's top-k threshold can be
# kept on one side and left in the EF on the other (ROADMAP.md section 3):
# the state is held to RUN_TOL but for at most FLIP_SHARE of its entries
# (measured: 2 of 1.6 M entries in the population run, 8.3e-4 apart).
FLIP_SHARE = 1e-5
CHAOS_KEYS = ("participation", "n_deadline_missed", "coordinator",
              "n_partitioned", "staleness_max", "cohort_new",
              "resident_clients")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shard(syn):
    return lambda cid: syn.client_image_shard("femnist", 64, cid, beta=0.5)


def build(port: bool, *, chaos=None, population=0, data=True,
          shards=False, verify=False, **cfg_kw):
    """The pair's one side.  Population mode reads per-client shards from
    ``device_data`` (``data``) or ``data_fn``; ``shards`` gives the fixed
    roster those shards too; ``verify`` checks the port's cohort swaps."""
    kw = {**dict(n_devices=N, n_clusters=C, tau=TAU, q=2, eta=0.02,
                 batch_size=50, seed=0, population=population), **cfg_kw}
    jvc = JVC(name="mlp-femnist", kind="mlp", image_size=28, channels=1,
              num_classes=62)
    j_init, j_loss, j_acc, _ = j_model(jvc)
    params0 = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0)))
    bits = 32.0 * sum(p.size for p in params0.values())
    het_kw = dict(num_devices=N, model_bits=bits, seed=0,
                  population=population)
    syn = tsyn if port else jsyn
    device_data, test = _data(syn)
    pop_kw = {}
    if shards:
        device_data = [_shard(syn)(c) for c in range(N)]
    if population:
        pop_kw = dict(data_fn=None if data else _shard(syn))
        if data:
            device_data = [_shard(syn)(c) for c in range(population)]
        else:
            device_data = None
    if not port:
        return JFedSim(JFedSimConfig(**kw), init_fn=j_init, loss_fn=j_loss,
                       acc_fn=j_acc, device_data=device_data,
                       test_data=test,
                       controller=jbase.make_controller("hcef", TAU),
                       het=JHet(**het_kw),
                       chaos=None if chaos is None else JChaos(**chaos),
                       **pop_kw, **BUDGETS)
    tvc = VisionConfig(name="mlp-femnist", kind="mlp", image_size=28,
                       channels=1, num_classes=62)
    _, t_loss, t_acc, _ = make_vision_model(tvc)
    return FedSim(FedSimConfig(**kw), params0=params0, loss_fn=t_loss,
                  acc_fn=t_acc, device_data=device_data, test_data=test,
                  controller=tbase.make_controller("hcef", TAU),
                  het=HeterogeneityModel(**het_kw),
                  chaos=None if chaos is None else ChaosConfig(**chaos),
                  bits_fn=jax_bits(TAU, N), device="cpu",
                  verify_conservation=verify, **pop_kw, **BUDGETS)


def _check_pair(ref, port):
    want = ref.run(ROUNDS, eval_every=3)
    got = port.run(ROUNDS, eval_every=3)
    _close_history(got, want)
    for g, w in zip(got, want):
        for k in CHAOS_KEYS:
            assert g.get(k) == w.get(k), (w["round"], k)
        if "energy_cap_mean" in w:
            assert abs(g["energy_cap_mean"] - w["energy_cap_mean"]) <= \
                1e-4 * abs(w["energy_cap_mean"])
    for mine, theirs in ((port.params, ref.params), (port.ef, ref.ef)):
        assert set(mine) == set(theirs)
        for k, w in theirs.items():
            g, w = mine[k].numpy(), np.asarray(w)
            off = ~np.isclose(g, w, **{"atol": RUN_TOL["atol"],
                                       "rtol": RUN_TOL["rtol"]})
            assert off.sum() <= FLIP_SHARE * w.size, (k, int(off.sum()))
    return got


def test_chaos_history_matches_reference():
    got = _check_pair(build(False, chaos=CHAOS), build(True, chaos=CHAOS))
    assert min(h["participation"] for h in got) < 1.0
    assert max(h["n_partitioned"] for h in got) > 0
    assert all(np.isfinite(h["loss"]) for h in got)


def test_population_and_chaos_history_matches_reference():
    ref = build(False, chaos=CHAOS, population=POP, data=False)
    port = build(True, chaos=CHAOS, population=POP, data=False)
    got = _check_pair(ref, port)
    assert np.array_equal(port.cohort_ids, ref.cohort_ids)
    assert np.array_equal(port.pop_store.rounds_participated,
                          ref.pop_store.rounds_participated)
    np.testing.assert_allclose(port.pop_store.energy_spent,
                               ref.pop_store.energy_spent, rtol=1e-4)
    assert port.pop_store.rounds_participated.sum() == ROUNDS * N
    assert max(h["cohort_new"] for h in got) > 0


def _bitwise(a, b):
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    for name in ("params", "ef", "mom"):
        for k, v in getattr(a, name).items():
            assert torch.equal(v, getattr(b, name)[k]), (name, k)


def test_population_equal_to_the_roster_is_bit_for_bit():
    roster = build(True, shards=True)
    pop = build(True, population=N, data=True)
    roster.run(3, eval_every=3)
    pop.run(3, eval_every=3)
    _bitwise(roster, pop)
    assert pop.pop_store.rounds_participated.tolist() == [3] * N


def test_zero_chaos_is_no_chaos_bit_for_bit():
    zero = dict(seed=0, dropout_prob=0.0, partition_prob=0.0,
                coordinator_fail_prob=0.0)
    a, b = build(True), build(True, chaos=zero)
    a.run(3, eval_every=3)
    b.run(3, eval_every=3)
    _bitwise(a, b)
    assert all(h["participation"] == 1.0 for h in b.history)


def test_cohort_swaps_conserve_and_restore_continues(tmp_path):
    a = build(True, chaos=CHAOS, population=POP, data=False,
              resident_max=8, verify=True)
    a.cfg.resident_max = 8
    a.run(2, eval_every=2)
    # the first swap fills empty slots: the second is the first checked
    checks = [h["swap_check"] for h in a.history if "swap_check" in h]
    assert len(checks) == 1 and checks[-1]["ef_before"] != 0.0
    assert all(c["equal"] for c in checks)
    assert checks[-1]["state_before"] != checks[-1]["ef_before"]
    ck = tmp_path / "ck.npz"
    a.save(ck)
    a.run(2, eval_every=2)
    b = build(True, chaos=CHAOS, population=POP, data=False, verify=True)
    b.restore(ck)
    b.run(2, eval_every=2)
    # the checks' host ms are the only numbers of a run's own clock
    drop_ms = lambda hist: [
        {**h, "swap_check": {**h["swap_check"], "host_ms": None}}
        if "swap_check" in h else h for h in hist]
    assert drop_ms(b.history) == drop_ms(a.history)
    assert len([h for h in a.history if "swap_check" in h]) == 3
    assert np.array_equal(a.cohort_ids, b.cohort_ids)
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k])
