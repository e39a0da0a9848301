"""The port's experiment scripts against the JAX package's, on the CPU.

  * the figure scripts (Figs. 2-7, Table 2) run both packages' ``main``
    over a recording stub of ``run_scheme`` / ``calibrate_budgets`` that
    returns fixed histories: the calls (arguments and order), the printed
    CSV and the saved JSON are equal (the harness's numerics are held by
    ``test_torch_experiments.py``);
  * the overlap sweep's loss histories, 3 rounds from the reference's
    parameters, batches and keys, within ``test_torch_round.py``'s loss
    tolerance, the reference compiled at XLA optimisation level 0; its
    modeled times equal;
  * the cohort sweep's final losses (SGD and FedProx, a population of 48
    behind a cohort of 8) within ``test_torch_fedsim.py``'s tolerances;
  * the cohort bench's swaps verified, the serving bench's modes serving
    every request to its budget, the CFEL example's checkpoints, and
    ``run.py``'s sections in the reference's order.

The reference's ``benchmarks.common.RESULTS`` and the port's
``experiments.common.RESULTS`` point at temporary directories.
"""
import importlib
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import cohort_bench as jcohort  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from benchmarks import overlap_sweep as joverlap  # noqa: E402
from repro.core import round as jround  # noqa: E402
from repro_torch.experiments import cfel_cifar_train  # noqa: E402
from repro_torch.experiments import cohort_bench  # noqa: E402
from repro_torch.experiments import common  # noqa: E402
from repro_torch.experiments import overlap_sweep  # noqa: E402
from repro_torch.experiments import run as run_mod  # noqa: E402
from repro_torch.experiments import serving_bench  # noqa: E402
from repro_torch.runtime.checkpoint import latest_checkpoint  # noqa: E402
from test_torch_fedsim import ACC_ATOL  # noqa: E402
from test_torch_fedsim import HIST_RTOL as FEDSIM_RTOL  # noqa: E402
from test_torch_fedsim import jax_bits  # noqa: E402
from test_torch_experiments import FastJax  # noqa: E402
from test_torch_round import HIST_RTOL  # noqa: E402

FIGURES = ("fig2_3_convergence", "fig4_noniid", "fig5_topology",
           "fig67_periods")
OVERLAP_ROUNDS = 3  # rounds 2 gossips (q = 2)
COHORT_ROUNDS = 4


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


# ---------------------------------------------------------------------------
# the figure scripts
# ---------------------------------------------------------------------------

class Recorder:
    """``run_scheme`` and ``calibrate_budgets`` stand-ins: each call is
    recorded and answered with a fixed two-eval history of its own."""

    def __init__(self):
        self.calls = []

    def history(self):
        k = len(self.calls)
        return [{"round": 1, "time": 10.0 * k, "energy": 2.5 * k,
                 "acc": 0.3 + 0.01 * k},
                {"round": 2, "time": 20.0 * k + 1, "energy": 5.0 * k + 1,
                 "acc": 0.8 if k % 3 else 0.45}]

    def run_scheme(self, scheme, **kw):
        self.calls.append(("run_scheme", scheme, kw))
        return self.history()

    def calibrate_budgets(self, *args, **kw):
        self.calls.append(("calibrate_budgets", args, kw))
        hist = self.history()
        return 0.6 * hist[-1]["time"], 0.6 * hist[-1]["energy"], hist


@pytest.mark.parametrize("name", FIGURES)
def test_figure_script_makes_the_reference_calls(name, monkeypatch, capsys,
                                                 tmp_path):
    runs = {}
    for pkg in ("benchmarks", "repro_torch.experiments"):
        mod = importlib.import_module(f"{pkg}.{name}")
        rec = Recorder()
        monkeypatch.setattr(mod, "run_scheme", rec.run_scheme)
        monkeypatch.setattr(mod, "calibrate_budgets", rec.calibrate_budgets)
        mod.main(rounds=2)
        runs[pkg] = (rec.calls, capsys.readouterr().out)
    (ref_calls, ref_out), (calls, out) = runs.values()
    assert calls == ref_calls and len(calls) >= 6
    assert out == ref_out and out.count("\n") >= 6
    ref_files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ref_files and ref_files
    for f in ref_files:
        assert (json.loads((tmp_path / "port" / f).read_text())
                == json.loads((tmp_path / "ref" / f).read_text()))


# ---------------------------------------------------------------------------
# the overlap sweep
# ---------------------------------------------------------------------------

def test_overlap_sweep_losses_match_reference(monkeypatch):
    monkeypatch.setattr(joverlap, "jax", FastJax())
    jcfg = joverlap.smoke_model(joverlap.get_config("smollm_135m").model
                                ).replace(d_model=64, d_ff=128)
    jtopo = joverlap.FLTopology(clusters=2, devices_per_cluster=2)
    jhcef = joverlap.HCEFConfig(tau=2, q=2, eta=0.1, momentum=0.0)
    R = jtopo.num_devices
    params0 = jax.tree.map(lambda x: np.asarray(x[0]), jround.init_state(
        jcfg, jhcef, jtopo, jax.random.PRNGKey(0)).params)
    batches = [np.asarray(jax.random.randint(
        jax.random.PRNGKey(100 + rnd), (R * 2 * 2, 32), 0,
        jcfg.vocab_size)) for rnd in range(OVERLAP_ROUNDS)]

    def ref_bits(key, rho):  # split(PRNGKey(200 + rnd), R), as _run draws
        keys = jax.random.split(jax.random.PRNGKey(key), R)
        r = jnp.clip(jnp.asarray(rho, jnp.float32), 0.0, 1.0)
        draw = jax.vmap(lambda k, p: jax.random.bernoulli(k, p, (2,)))
        return np.asarray(draw(keys, r), np.float32)

    cfg, topo, hcef = overlap_sweep.sweep_setup()
    for s in (0, 1):
        want = joverlap._run(s, OVERLAP_ROUNDS, jcfg, jtopo, jhcef)
        got = overlap_sweep._run(s, OVERLAP_ROUNDS, cfg, topo, hcef,
                                 params0=params0, batches=batches,
                                 bits_fn=ref_bits, device="cpu")
        assert len(got) == OVERLAP_ROUNDS
        for g, w in zip(got, want):
            assert abs(g - w) <= HIST_RTOL["loss"] * abs(w), (s, got, want)


def test_overlap_sweep_modeled_times_match_reference(monkeypatch, capsys,
                                                     tmp_path):
    """main's JSON and line, the losses stubbed alike: the cost model's
    modeled walls and speedup are the reference's exactly."""
    fixed = lambda s, rounds, *a, **kw: [5.0 - 0.1 * s - 0.01 * r  # noqa
                                         for r in range(rounds)]
    monkeypatch.setattr(joverlap, "_run", fixed)
    monkeypatch.setattr(overlap_sweep, "_run", fixed)
    want = joverlap.main(10)
    ref_out = capsys.readouterr().out
    got = overlap_sweep.main(10)
    out = capsys.readouterr().out
    assert got == want and got["modeled_speedup"] > 1.0
    assert out.splitlines()[0] == ref_out.splitlines()[0]
    assert (json.loads((tmp_path / "port" / "overlap_sweep.json")
                       .read_text())
            == json.loads((tmp_path / "ref" / "overlap_sweep.json")
                          .read_text()))


# ---------------------------------------------------------------------------
# the cohort bench and sweep
# ---------------------------------------------------------------------------

def _ref_sweep_params():
    """The reference sweep's ``init_fn(PRNGKey(0))`` (FedSim's seed)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"w1": np.asarray(jax.random.normal(k1, (48, 32)) * 0.1),
            "b1": np.zeros(32, np.float32),
            "w2": np.asarray(jax.random.normal(k2, (32, 10)) * 0.1)}


def test_cohort_sweep_matches_reference():
    want = jcohort.sweep(rounds=COHORT_ROUNDS)
    sims = {}
    got = cohort_bench.sweep(rounds=COHORT_ROUNDS,
                             params0=_ref_sweep_params(),
                             bits_fn=jax_bits(4, 8), device="cpu",
                             verify_conservation=True,
                             on_sim=sims.__setitem__)
    assert set(got) == set(want) == {"sgd", "fedprox"}
    for obj in want:
        (gl, ga), (wl, wa) = got[obj], want[obj]
        assert abs(gl - wl) <= FEDSIM_RTOL["loss"] * abs(wl), (obj, gl, wl)
        assert abs(ga - wa) <= ACC_ATOL
        hist = sims[obj].history
        assert all(h["swap_check"]["equal"] for h in hist[1:])
        assert sims[obj].pop_store.population == 48


def test_cohort_bench_rows_verify_their_swaps():
    checks = []
    rows = cohort_bench.bench_rows(smoke=True, device="cpu", checks=checks)
    assert [r[0] for r in rows] == ["cohort_swap_resident",
                                    "cohort_swap_paged"]
    assert all(r[1] > 0 and r[2].endswith("_R64_d25000") for r in rows)
    assert len(checks) == 2 and all(c["equal"] for c in checks)


# ---------------------------------------------------------------------------
# the serving bench, the CFEL example, run.py
# ---------------------------------------------------------------------------

def test_serving_bench_serves_every_budget(capsys, tmp_path):
    rows, detail = serving_bench.main(["--device", "cpu", "--requests", "8",
                                       "--require", "0"])
    out = capsys.readouterr().out
    assert [r[0] for r in rows] == [
        "serving_static_smollm_135m", "serving_cont_smollm_135m",
        "serving_cont_int8kv_smollm_135m"]
    saved = json.loads((tmp_path / "port" / "serving_bench.json")
                       .read_text())
    assert saved == json.loads(json.dumps(detail))
    wl = saved["workload"]
    reqs = serving_bench.make_workload(
        n_requests=8, vocab=257, prompt_lens=tuple(wl["prompt_lens"]),
        budgets=tuple(wl["budgets"]), rate_hz=200.0, seed=0)
    assert wl["total_budget_tokens"] == sum(r.max_new_tokens for r in reqs)
    assert (wl["page_size"], wl["slots"], wl["smoke"]) == (8, 8, True)
    # the smoke smollm's head_dim 16: 4 bytes an entry against 1 and a
    # 4-byte scale a (token, head)
    assert saved["continuous_int8kv"]["kv_bytes_ratio"] == 16 * 4 / (
        16 + 4)
    assert "continuous vs static" in out and "OK" in out
    with pytest.raises(SystemExit):  # --require's verdict is an exit code
        serving_bench.main(["--device", "cpu", "--requests", "2",
                            "--require", "1e9"])


def test_cfel_example_checkpoints_restore(monkeypatch, tmp_path):
    """The example's checkpoints, the last restored into a fresh sim that
    continues a round bit for bit."""
    monkeypatch.setitem(common._DATASETS["cifar"], "n_train", 512)
    monkeypatch.setitem(common._DATASETS["cifar"], "n_test", 256)
    monkeypatch.setattr(cfel_cifar_train, "CKPT_EVERY", 1)
    sim = cfel_cifar_train.main(["--rounds", "2", "--device", "cpu",
                                 "--ckpt-dir", str(tmp_path / "ck")])
    last = latest_checkpoint(tmp_path / "ck")
    assert last == tmp_path / "ck" / "ckpt_000002.npz"
    fresh = cfel_cifar_train.make_cfel_sim("hcef", device="cpu")
    fresh.restore(last)
    assert fresh.round == sim.round == 2
    assert fresh.budget == sim.budget
    # the leaves in one order on both sides (Algorithm 2 sums over them)
    assert list(fresh.params) == list(sim.params) == sorted(sim.params)
    assert sim.run_round() == fresh.run_round()  # round 3, G2 included
    for f in ("params", "ef", "mom"):
        for k, v in getattr(sim, f).items():
            w = getattr(fresh, f)[k]
            assert torch.equal(w.view(torch.int32), v.view(torch.int32))


def test_run_sections_in_the_reference_order(monkeypatch, tmp_path):
    from repro_torch.experiments import (fig2_3_convergence, fig4_noniid,
                                         fig5_topology, fig67_periods,
                                         kernels_bench, roofline)
    seen = []
    monkeypatch.setattr(common, "DEVICE", None)  # run.main sets it
    monkeypatch.setattr(serving_bench, "bench_rows", lambda **kw: (
        seen.append(("serving_bench", kw))
        or ([("serving_row", 1.5, "x")], None)))
    monkeypatch.setattr(cohort_bench, "bench_rows", lambda **kw: (
        seen.append(("cohort_bench", kw)) or [("cohort_row", 2.0, "y")]))
    monkeypatch.setattr(overlap_sweep, "main",
                        lambda **kw: seen.append(("overlap_sweep", kw)))
    monkeypatch.setattr(cohort_bench, "sweep",
                        lambda **kw: seen.append(("cohort_sweep", kw)))
    for mod in (fig2_3_convergence, fig4_noniid, fig5_topology,
                fig67_periods):
        monkeypatch.setattr(mod, "main", lambda name=mod.__name__, **kw:
                            seen.append((name.rsplit(".", 1)[1], kw)))
    monkeypatch.setattr(kernels_bench, "main", lambda argv: seen.append(
        ("kernels_bench", argv)))
    monkeypatch.setattr(roofline, "main", lambda: seen.append(
        ("roofline", {})))
    run_mod.main(["--full", "--device", "cpu"])
    assert [s[0] for s in seen] == [
        "kernels_bench", "serving_bench", "cohort_bench", "overlap_sweep",
        "cohort_sweep", "fig2_3_convergence", "fig4_noniid",
        "fig5_topology", "fig67_periods", "roofline"]
    assert seen[0][1] == ["--device", "cpu"]
    assert seen[5][1] == {"rounds": 60}
    assert all(s[1] == {"rounds": 40} for s in seen[6:9])
    assert common.DEVICE == "cpu"
    assert json.loads((tmp_path / "port" / "run_rows.json").read_text()) == {
        "serving_row": {"us_per_call": 1.5, "derived": "x"},
        "cohort_row": {"us_per_call": 2.0, "derived": "y"}}
    seen.clear()
    run_mod.main(["--smoke", "--device", "cpu"])
    assert [s[0] for s in seen] == ["kernels_bench", "serving_bench",
                                    "cohort_bench", "overlap_sweep",
                                    "cohort_sweep"]
    assert seen[0][1] == ["--smoke", "--device", "cpu"]
    seen.clear()
    run_mod.main(["--device", "cpu"])
    assert [s[0] for s in seen][5:] == ["fig2_3_convergence", "roofline"]
    assert seen[5][1] == {"rounds": 40}
