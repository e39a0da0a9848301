"""The port's three examples (``experiments/quickstart.py``,
``paper_models_demo.py``, ``serve_lm.py``) against the JAX package's, on
the CPU.

- quickstart: its first 2 rounds (the second gossips) against the
  reference's loop (examples/quickstart.py) on the same inputs: the
  reference's ``init_state`` weights, its masked-step bits
  (``jax.random.bernoulli`` per device, the port's ``bits_fn``), the same
  corpus and batches; each side runs its own controller.  The history
  within ``test_torch_round.py``'s tolerances, the parameters, momentum
  and EF within its state tolerance.
- paper_models_demo: ResNet-20 and the FEMNIST CNN at full size, their
  parameter counts, and the first SGD step on 8 images from the
  reference's weights: the loss and the parameters after it.
- serve_lm: its greedy tokens against the reference's ``Engine.generate``
  as examples/serve_lm.py builds it, for the dense and the SSM family,
  f32, the weights times 10 with every emitting row's top-2 margin
  checked (``test_torch_generate.py``'s rule); ``--continuous`` refuses a
  family without a paged cache.
"""
import functools

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
from repro.core.controller import BudgetState as JBudget  # noqa: E402
from repro.data.synthetic import synthetic_images as j_images  # noqa
from repro.data.synthetic import synthetic_tokens as j_tokens  # noqa
from repro.fl.baselines import make_controller as j_controller  # noqa
from repro.fl.heterogeneity import HeterogeneityModel as JHet  # noqa
from repro.models.vision import make_vision_model as j_vision  # noqa
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import PagedConfig as JPaged  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.experiments import (paper_models_demo,  # noqa: E402
                                     quickstart, serve_lm)
from repro_torch.tree import flatten  # noqa: E402
from test_torch_generate import MARGIN, models  # noqa: E402
from test_torch_round import (FAST_COMPILE, HIST_RTOL,  # noqa: E402
                              STATE_TOL, _jit, jax_bits)

QS_ROUNDS = 2
# one plain SGD step from the same weights: f32 convolutions and sums in
# other orders in XLA and ATen.  ResNet-20's step on 8 images moves the
# loss from 4.01 to 1.18 (batch statistics over 8 images): the
# reference's own loss after it differs by 2.0e-5 relative between XLA's
# backend optimisation levels 0 and 3, and the port's parameters are
# within 4.4e-5 of the reference's (the largest update is 0.081)
DEMO_LOSS_RTOL = 1e-4
DEMO_PARAM_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def init_state():
    """The reference's ``init_state`` from key 0 (jitted: eager, its
    init takes seconds), shared by both sides."""
    cfg = j_smoke(j_get_config("smollm_135m").model)
    topo = JTopo(clusters=2, devices_per_cluster=2)
    hcef = JHCEF(tau=4, q=2, eta=0.1, momentum=0.9)
    return _jit(lambda k: jround.init_state(cfg, hcef, topo, k),
                FAST_COMPILE)(jax.random.PRNGKey(0))


def reference_quickstart(rounds):
    """examples/quickstart.py's loop for ``rounds`` rounds, its steps
    compiled at FAST_COMPILE.  Returns (rows, final state)."""
    cfg = j_smoke(j_get_config("smollm_135m").model)
    topo = JTopo(clusters=2, devices_per_cluster=2)
    hcef = JHCEF(tau=4, q=2, eta=0.1, momentum=0.9)
    R = topo.num_devices
    state = init_state()
    step_gossip = _jit(jround.make_round_step(cfg, hcef, topo, gossip=True),
                       FAST_COMPILE)
    step_intra = _jit(jround.make_round_step(cfg, hcef, topo, gossip=False),
                      FAST_COMPILE)
    corpus = j_tokens(cfg.vocab_size, n_seq=64, seq_len=33, n_devices=R,
                      beta=0.5)
    controller = j_controller("hcef", hcef.tau)
    het = JHet(num_devices=R, model_bits=2.3e6 * 32)
    budget = JBudget(time_budget=3e4, energy_budget=4e3, phi=12, q=hcef.q,
                     backhaul_time=het.backhaul_time())
    rng = np.random.default_rng(0)
    rows = []
    for rnd in range(rounds):
        reports = het.sample_round(rnd)
        rho, theta = controller.controls(reports, budget)
        idx = rng.integers(0, corpus.shape[1], (R, hcef.tau * 2))
        batch = {"tokens": jnp.asarray(
            np.concatenate([corpus[d, idx[d]] for d in range(R)]))}
        keys = jax.random.split(jax.random.PRNGKey(100 + rnd), R)
        fn = step_gossip if (rnd + 1) % hcef.q == 0 else step_intra
        state, m = fn(state, batch, jnp.asarray(rho, jnp.float32),
                      jnp.asarray(theta, jnp.float32), keys)
        t = float(np.max(rho * hcef.tau * reports.mu + theta * reports.nu))
        e = float(np.sum(rho * hcef.tau * reports.alpha
                         + reports.p * theta * reports.nu))
        budget.time_spent_this += t
        budget.energy_spent_this += e
        budget.r += 1
        if (rnd + 1) % hcef.q == 0:
            budget.time_spent_prev += budget.time_spent_this
            budget.energy_spent_prev += budget.energy_spent_this
            budget.time_spent_this = budget.energy_spent_this = 0.0
            budget.r = 0
            budget.l += 1
        rows.append({"loss": float(m["loss"].mean()),
                     "rho_mean": float(np.mean(rho)),
                     "theta_mean": float(np.mean(theta)),
                     "time": budget.time_spent_prev + budget.time_spent_this,
                     "energy": (budget.energy_spent_prev
                                + budget.energy_spent_this)})
    return rows, state


def test_quickstart_rounds_match_reference(capsys):
    want, jstate = reference_quickstart(QS_ROUNDS)
    # the reference's initial weights: its init_state's, one replica
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), init_state().params)
    got, state = quickstart.run(QS_ROUNDS, device="cpu", params0=params0,
                                bits_fn=jax_bits(4, 4))
    out = capsys.readouterr().out
    assert out.startswith("round  loss    rho(mean)  theta(mean)")
    assert "reached consensus within clusters: True" in out
    assert [r["round"] for r in got] == list(range(QS_ROUNDS))
    for r, (g, w) in enumerate(zip(got, want)):
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (r, k, g[k], w[k])
    for f in ("params", "momentum", "ef"):
        want_f = {"/".join(str(k.key) for k in path): np.asarray(v)
                  for path, v in jax.tree_util.tree_flatten_with_path(
                      getattr(jstate, f))[0]}
        got_f = {k: v.numpy() for k, v in flatten(getattr(state, f)).items()}
        assert set(got_f) == set(want_f), f
        for k, w in want_f.items():
            np.testing.assert_allclose(got_f[k], w, err_msg=f"{f}/{k}",
                                       **STATE_TOL)


@pytest.mark.parametrize("name", ["resnet20_cifar10", "femnist_cnn"])
def test_demo_first_step_matches_reference(name):
    mod = __import__(f"repro.configs.{name}", fromlist=["VISION"])
    init_fn, loss_fn, _, _ = j_vision(mod.VISION)
    jparams = init_fn(jax.random.PRNGKey(0))
    ds = dict(paper_models_demo.MODELS)[name]
    X, Y = j_images(ds, 8, seed=0)
    if ds == "cifar":
        Y = Y % mod.VISION.num_classes
    batch = {"images": jnp.asarray(X), "labels": jnp.asarray(Y)}

    def step(p):
        nxt = jax.tree.map(lambda a, g: a - 0.05 * g, p,
                           jax.grad(loss_fn)(p, batch))
        return nxt, loss_fn(nxt, batch)
    jnext, jloss = _jit(step, FAST_COMPILE)(jparams)
    jloss = float(jloss)
    out = paper_models_demo.run(
        8, 1, device="cpu", verbose=False,
        params={name: params_from_jax(jax.tree.map(np.asarray, jparams),
                                      "cpu")})[name]
    assert out["count"] == sum(int(x.size) for x in jax.tree.leaves(jparams))
    assert out["count"] == {"resnet20_cifar10": 269_722,
                            "femnist_cnn": 6_603_710}[name]
    assert abs(out["losses"][0] - jloss) <= DEMO_LOSS_RTOL * abs(jloss)
    for k, w in jnext.items():
        np.testing.assert_allclose(out["params"][k].numpy(), np.asarray(w),
                                   err_msg=k, **DEMO_PARAM_TOL)


def test_demo_prints_both_counts(capsys):
    paper_models_demo.run(8, 1, device="cpu")
    out = capsys.readouterr().out
    assert "resnet20-cifar10: 269,722 params" in out
    assert "femnist-cnn: 6,603,710 params" in out


@pytest.mark.parametrize("arch", ["smollm_135m", "mamba2_1p3b"])
def test_serve_lm_greedy_tokens_match_reference(arch):
    jcfg, jm, jparams, cfg, _, params = models(arch, 0, scale=10.0)
    emitted = []

    class Spy:
        """The reference's model module, reporting every call's logits."""
        init_cache = staticmethod(jm.init_cache)

        @staticmethod
        def prefill(*a, **kw):
            logits, cache = jm.prefill(*a, **kw)
            jax.debug.callback(lambda lg: emitted.append(np.asarray(lg)),
                               logits)
            return logits, cache

        @staticmethod
        def decode_step(*a, **kw):
            logits, cache = jm.decode_step(*a, **kw)
            jax.debug.callback(lambda lg: emitted.append(np.asarray(lg)),
                               logits)
            return logits, cache

    # examples/serve_lm.py's engine and prompts, greedy
    jeng = JEngine(jcfg, jparams, max_len=64, batch_size=4,
                   serve=JServe(max_new_tokens=8, temperature=0.0),
                   paged=JPaged(page_size=8, max_slots=4))
    jeng.model = Spy
    prompts = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (3, 16)).astype(np.int32)
    theirs = np.asarray(jeng.generate(prompts))
    jax.effects_barrier()
    _, ours = serve_lm.run(arch, new_tokens=8, temperature=0.0,
                           device="cpu", params=params, verbose=False)
    lg = np.concatenate([e[:, -1] for e in emitted])
    top2 = np.sort(lg, axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > MARGIN).all()
    assert ours.shape == theirs.shape == (3, 8)
    assert len(np.unique(theirs)) > 8
    np.testing.assert_array_equal(ours, theirs)


def test_serve_lm_every_arch_and_the_continuous_refusal(capsys):
    from repro_torch.configs import ARCH_IDS
    for arch in ARCH_IDS:
        cfg, out = serve_lm.run(arch, n=2, new_tokens=2, device="cpu",
                                verbose=False)
        assert out.shape == (2, 2) and cfg.num_layers <= 3, arch
    cfg, outs = serve_lm.run("granite_moe_1b_a400m", n=3, new_tokens=3,
                             continuous=True, device="cpu")
    assert sorted(outs) == [0, 1, 2]
    assert all(1 <= len(o.tokens) <= 3 for o in outs.values())
    with pytest.raises(SystemExit) as e:
        serve_lm.main(["--arch", "mamba2_1p3b", "--continuous",
                       "--device", "cpu"])
    assert e.value.code == 2
    assert "continuous batching needs a KV-cache family" in \
        capsys.readouterr().err
