"""The port's experiment harness and checkpoints against the JAX package's,
on the CPU.

  * ``wire_format.kv_token_bytes``, the serving bench's workload and
    latency summaries, ``SCHEMES``, ``_DATASETS`` and ``cost_to_target``
    equal to the reference's;
  * ``experiments.common.make_sim`` / ``run_scheme`` for each of the five
    schemes (and HCEF on an Erdos-Renyi backhaul) against
    ``benchmarks.common``'s, 3 rounds at a reduced ``n_train`` and 8
    devices in 4 clusters from the reference's ``init_fn(PRNGKey(0))``
    parameters and its masked-step bits, within ``test_torch_fedsim.py``'s
    tolerances, the reference's FedSim programs compiled at XLA
    optimisation level 0; ``make_sim``'s defaults the reference's;
  * ``calibrate_budgets``' two budgets within 1e-4 relative;
  * ``latest_checkpoint`` against the reference's on a directory with torn
    temporary files; bf16 trees written by either package load bit for
    bit into the other; the train launcher's ``--ckpt-dir`` files carry
    the reference's key paths of the same state.

The reference's ``benchmarks.common.RESULTS`` and the port's
``experiments.common.RESULTS`` point at temporary directories.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import serving_bench as jserving  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.configs.base import FLTopology as JTopo  # noqa: E402
from repro.configs.resnet20_cifar10 import VisionConfig as JVC  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro.core import wire_format as jwire  # noqa: E402
from repro.models.vision import make_vision_model as j_model  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import driver as jdriver  # noqa: E402
from repro.serving.scheduler import RequestOutput as JOut  # noqa: E402
from repro_torch.core import wire_format as twire  # noqa: E402
from repro_torch.experiments import common  # noqa: E402
from repro_torch.experiments import serving_bench  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime import checkpoint as tckpt  # noqa: E402
from repro_torch.serving.scheduler import RequestOutput  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_fedsim import ACC_ATOL, HIST_RTOL, jax_bits  # noqa: E402
from test_torch_round import FAST_COMPILE, _jit  # noqa: E402

N_TRAIN, N_TEST = 1024, 256  # the harness's 16,384 and 1,024, reduced
ROUNDS = 3
# 8 devices in 4 clusters, through make_sim's own arguments (its 16 in 8
# are held by test_make_sim_defaults_are_the_reference_harness)
SIZE = dict(n_devices=8, n_clusters=4)
ARCH_BF16 = "phi3_medium_14b"  # its smoke config keeps bf16 momentum
# budgets under which HCEF's theta falls to theta_min and CEF-C compresses
BUDGETS = dict(time_budget=2e4, energy_budget=2e3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _results(tmp_path, monkeypatch):
    """Neither package writes into the repo's result directories."""
    monkeypatch.setattr(jcommon, "RESULTS", tmp_path / "ref")
    monkeypatch.setattr(common, "RESULTS", tmp_path / "port")


class FastJax:
    """``jax`` for a reference module whose programs are only compared by
    their outputs: ``jit`` compiles at XLA optimisation level 0
    (``test_torch_round.FAST_COMPILE``), one program a function."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        return _jit(fn, FAST_COMPILE)


@pytest.fixture
def small(monkeypatch):
    """Both harnesses at N_TRAIN / N_TEST images, the reference's FedSim
    programs compiled fast."""
    for mod in (jcommon, common):
        for ds in mod._DATASETS:
            monkeypatch.setitem(mod._DATASETS[ds], "n_train", N_TRAIN)
            monkeypatch.setitem(mod._DATASETS[ds], "n_test", N_TEST)
    monkeypatch.setattr(jdriver, "jax", FastJax())


def ref_params(dataset):
    """The reference's MLP parameters, ``init_fn(PRNGKey(0))``."""
    ds = jcommon._DATASETS[dataset]
    init_fn = j_model(JVC(name=f"mlp-{dataset}", kind="mlp",
                          image_size=ds["image_size"],
                          channels=ds["channels"],
                          num_classes=ds["num_classes"]))[0]
    return jax.tree.map(np.asarray, init_fn(jax.random.PRNGKey(0)))


def close_history(got, want):
    """test_torch_fedsim's history check, over the records both keep."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert set(g) == set(w), set(g) ^ set(w)
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (w["round"], k,
                                                          g[k], w[k])
        if "acc" in w:
            assert abs(g["acc"] - w["acc"]) <= ACC_ATOL


# ---------------------------------------------------------------------------
# exact copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_kv_token_bytes_matches_reference(kv_dtype):
    for kh in (1, 2, 3, 4, 8, 32):
        for dh in (16, 64, 80, 128, 256):
            for item in (1, 2, 4):
                got = twire.kv_token_bytes(kh, dh, kv_dtype=kv_dtype,
                                           dense_itemsize=item)
                want = jwire.kv_token_bytes(kh, dh, kv_dtype=kv_dtype,
                                            dense_itemsize=item)
                assert got == want and type(got) is type(want)
    with pytest.raises(ValueError, match="kv_dtype"):
        twire.kv_token_bytes(2, 64, kv_dtype="fp8")


@pytest.mark.parametrize("seed", [0, 7])
def test_make_workload_matches_reference(seed):
    kw = dict(n_requests=32, vocab=49152, prompt_lens=(4, 8, 16, 24),
              budgets=(4, 8, 16, 64), rate_hz=200.0, seed=seed)
    got = serving_bench.make_workload(**kw)
    want = jserving.make_workload(**kw)
    assert len(got) == len(want) == 32
    for g, w in zip(got, want):
        assert g.rid == w.rid and g.max_new_tokens == w.max_new_tokens
        assert g.arrival == w.arrival
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)


def test_latency_summary_matches_reference():
    """The same timestamps and token counts in both packages' outputs."""
    rng = np.random.default_rng(3)
    outs = {RequestOutput: {}, JOut: {}}
    for rid in range(9):
        n = int(rng.integers(1, 6))
        ta, tf = rng.uniform(0, 1), rng.uniform(1, 2)
        td = tf + rng.uniform(0, 1)
        for cls, d in outs.items():
            d[rid] = cls(rid=rid, prompt_len=4, tokens=list(range(n)),
                         t_arrival=ta, t_first_token=tf, t_done=td)
    got = serving_bench._lat_summary(outs[RequestOutput])
    want = jserving._lat_summary(outs[JOut])
    assert got == want
    for q in (0, 50, 99, 100):
        xs = list(rng.uniform(0, 5, 13))
        assert serving_bench._pct(xs, q) == jserving._pct(xs, q)
    assert serving_bench._pct([], 50) == jserving._pct([], 50) == 0.0


def test_schemes_and_datasets_match_reference():
    assert common.SCHEMES == jcommon.SCHEMES
    assert common._DATASETS == jcommon._DATASETS


def test_cost_to_target_matches_reference():
    hists = [
        [],
        [{"time": 1.0, "energy": 2.0}],
        [{"time": 1.0, "energy": 2.0, "acc": 0.3},
         {"time": 2.0, "energy": 3.0},
         {"time": 3.5, "energy": 4.5, "acc": 0.7},
         {"time": 5.0, "energy": 6.0, "acc": 0.9}],
        [{"time": 1.0, "energy": 2.0, "acc": 0.69999}],
        [{"time": 0.0, "energy": 0.0, "acc": 0.71}],
    ]
    for h in hists:
        for target in (0.0, 0.5, 0.7, 0.95):
            assert (common.cost_to_target(h, target)
                    == jcommon.cost_to_target(h, target))


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

CASES = [dict(scheme=s, dataset="femnist") for s in common.SCHEMES] + [
    dict(scheme="hcef", dataset="femnist", backhaul="erdos_renyi",
         p_edge=0.6)]


@pytest.mark.parametrize("case", CASES, ids=[
    "-".join(str(v) for v in c.values()) for c in CASES])
def test_run_scheme_matches_reference(case, small):
    """make_sim + FedSim.run: 3 rounds (the third evaluated), the
    reference's parameters and bits."""
    kw = dict(case, rounds=ROUNDS, eval_every=ROUNDS, **BUDGETS, **SIZE)
    scheme = kw.pop("scheme")
    want = jcommon.run_scheme(scheme, **kw)
    got = common.run_scheme(scheme, params0=ref_params(case["dataset"]),
                            bits_fn=jax_bits(5, SIZE["n_devices"]),
                            device="cpu", **kw)
    close_history(got, want)
    if scheme == "hcef":  # Q drops coordinates
        assert max(h["theta_mean"] for h in got) < 1.0


def test_make_sim_defaults_are_the_reference_harness(small):
    sim = common.make_sim("cef_f", device="cpu")
    ref = jcommon.make_sim("cef_f")
    assert sim.cfg == type(sim.cfg)(**{
        k: getattr(ref.cfg, k) for k in vars(sim.cfg)})
    assert (sim.cfg.n_devices, sim.cfg.n_clusters, sim.cfg.batch_size,
            sim.cfg.eta, sim.cfg.momentum) == (16, 8, 50, 0.02, 0.9)
    np.testing.assert_array_equal(sim.H_np, np.asarray(ref.H))
    assert sim.het.model_bits == ref.het.model_bits
    assert sim.budget.phi == ref.budget.phi == 200
    assert np.isinf(sim.budget.time_budget)
    assert sim.controller.rho_min == ref.controller.rho_min
    assert {k: tuple(v.shape[1:]) for k, v in sim.params.items()} == {
        k: tuple(v.shape[1:]) for k, v in ref.params.items()}


def test_calibrate_budgets_matches_reference(small):
    want = jcommon.calibrate_budgets("femnist", rounds=ROUNDS, **SIZE)
    got = common.calibrate_budgets("femnist", rounds=ROUNDS,
                                   params0=ref_params("femnist"),
                                   bits_fn=jax_bits(5, SIZE["n_devices"]),
                                   device="cpu", **SIZE)
    for g, w in zip(got[:2], want[:2]):
        assert abs(g - w) <= 1e-4 * abs(w), (g, w)
    close_history(got[2], want[2])


def test_save_json_writes_under_results(tmp_path):
    p = common.save_json("x", {"a": np.float32(1.5), "b": [1, 2]})
    q = jcommon.save_json("x", {"a": np.float32(1.5), "b": [1, 2]})
    assert p == tmp_path / "port" / "x.json"
    assert p.read_text() == q.read_text()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_latest_checkpoint_matches_reference(tmp_path):
    d = tmp_path / "ck"
    assert tckpt.latest_checkpoint(d) is jckpt.latest_checkpoint(d) is None
    d.mkdir()
    assert tckpt.latest_checkpoint(d) is None
    for name in ("ckpt_000001.npz", "ckpt_000003.npz", "ckpt_000002.npz",
                 ".ckpt_000009.npz.tmp.123", "ckpt_000007.tmp.npz",
                 "ckpt_000004.meta.json", "other_000008.npz"):
        (d / name).write_bytes(b"")
    got = tckpt.latest_checkpoint(d)
    assert got == jckpt.latest_checkpoint(d) == d / "ckpt_000003.npz"
    assert (tckpt.latest_checkpoint(d, prefix="other_")
            == jckpt.latest_checkpoint(d, prefix="other_"))


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_bf16_checkpoint_written_by_port_loads_in_reference(tmp_path):
    """The port's bf16 leaves are the reference's two-byte void layout:
    the reference's ``load_pytree`` returns them (into a ``V2`` template;
    its ``astype`` has no cast from ``V2`` to bfloat16) bit for bit."""
    every = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    tree = {"p": {"w": every.view(torch.bfloat16).reshape(256, 256),
                  "b": torch.randn(7)},
            "round_idx": torch.tensor(5, dtype=torch.int32)}
    tckpt.save_pytree(tmp_path / "c.npz", tree, {"round": 5})
    tmpl = {"p": {"w": np.zeros((256, 256), "V2"),
                  "b": np.zeros(7, np.float32)},
            "round_idx": np.zeros((), np.int32)}
    got, meta = jckpt.load_pytree(tmp_path / "c.npz", tmpl)
    assert meta == {"round": 5}
    np.testing.assert_array_equal(got["p"]["w"].view(np.uint16),
                                  _bits(tree["p"]["w"]))
    np.testing.assert_array_equal(got["p"]["b"], tree["p"]["b"].numpy())
    assert got["round_idx"] == 5
    # and the port reads its own file back bit for bit
    back, _ = tckpt.load_pytree(tmp_path / "c.npz", tree)
    assert back["p"]["w"].dtype == torch.bfloat16
    assert np.array_equal(_bits(back["p"]["w"]), _bits(tree["p"]["w"]))
    assert back["round_idx"].shape == () and int(back["round_idx"]) == 5


def test_bf16_checkpoint_written_by_reference_loads_in_port(tmp_path):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    bits = np.arange(1 << 16, dtype=np.uint16).reshape(256, 256)
    tree = {"p": {"w": jnp.asarray(bits.view(ml_dtypes.bfloat16)),
                  "b": jnp.arange(7, dtype=jnp.float32)},
            "round_idx": jnp.int32(4)}
    jckpt.save_pytree(tmp_path / "j.npz", tree, {"round": 4})
    tmpl = {"p": {"w": torch.zeros(256, 256, dtype=torch.bfloat16),
                  "b": torch.zeros(7)},
            "round_idx": torch.tensor(0, dtype=torch.int32)}
    got, meta = tckpt.load_pytree(tmp_path / "j.npz", tmpl)
    assert meta == {"round": 4}
    assert got["p"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["p"]["w"]), bits)
    np.testing.assert_array_equal(got["p"]["b"].numpy(), np.arange(7))
    # uint16 patterns load the same way
    np.savez(tmp_path / "u.npz", **{"p/w": bits, "p/b": np.arange(7.0),
                                    "round_idx": np.int32(4)})
    got, _ = tckpt.load_pytree(tmp_path / "u.npz", tmpl)
    np.testing.assert_array_equal(_bits(got["p"]["w"]), bits)


def test_train_ckpt_files_carry_the_reference_key_paths(tmp_path):
    """``--ckpt-dir``'s archive holds the arrays the reference's launcher
    writes for the same state (its ``fl._asdict()``), bf16 leaves (the
    smoke phi3's momentum) included, and loads back equal to the
    launcher's state."""
    out = train.main(["--device", "cpu", "--arch", ARCH_BF16, "--rounds",
                      "1", "--seq", "24", "--ckpt-dir", str(tmp_path)])
    jbundle = j_get_config(ARCH_BF16)
    jcfg = j_smoke(jbundle.model)
    jstate = jround.init_state(jcfg, jbundle.hcef, JTopo(2, 2),
                               jax.random.PRNGKey(0))
    jckpt.save_pytree(tmp_path / "ref.npz", jstate._asdict(), {"round": 0})
    with np.load(tmp_path / "ckpt_000000.npz") as got, \
            np.load(tmp_path / "ref.npz") as want:
        assert set(got.keys()) == set(want.keys())
        for k in want.keys():
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype.itemsize == want[k].dtype.itemsize, k
    fl = out["state"]
    tree = train.state_tree(fl)
    assert any(v.dtype == torch.bfloat16 for v in flatten(tree).values())
    back, meta = tckpt.load_pytree(tmp_path / "ckpt_000000.npz", tree)
    assert meta == {"round": 0}
    for k, v in flatten(tree).items():
        assert torch.equal(flatten(back)[k], v), k
