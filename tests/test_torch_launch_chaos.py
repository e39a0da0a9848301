"""The port's entry points under degraded mode and cohorts, on the CPU at
smoke size: the train launcher's ``--chaos``, ``--population``,
``--store-root`` and ``--verify-conservation`` (every cohort swap keeps
the population's sums under ==, population == R is bit for bit the
storeless run, ``--wire-ef`` with a rotating cohort exits), the FedSim
launcher's ``--chaos`` / ``--population``, and the chaos and cohort
smokes, whose contracts must hold."""
import math

import numpy as np
import pytest
import torch

from repro_torch.launch import chaos_smoke, cohort_smoke, fedsim, train
from repro_torch.tree import flatten

SMOLLM = ["--device", "cpu", "--arch", "smollm_135m", "--seq", "40"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_under_chaos_with_cohorts_checks_every_swap(capsys):
    out = train.main(SMOLLM + ["--rounds", "3", "--chaos", "--population",
                               "8", "--verify-conservation"])
    text = capsys.readouterr().out
    hist = out["history"]
    assert len(hist) == 3
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert min(h["participation"] for h in hist) < 1.0
    lines = [ln for ln in text.splitlines() if ln.startswith("round")]
    assert len(lines) == 3 and all(" part=" in ln and " miss=" in ln
                                   for ln in lines)
    # the first swap fills empty slots; each later one is checked
    checks = [h["swap_check"] for h in hist if "swap_check" in h]
    assert len(checks) == 2 and "swap_check" not in hist[0]
    assert all(c["equal"] for c in checks)
    assert all(c["state_before"] != 0.0 for c in checks)
    assert text.count("cohort swap before round") == 2
    assert len(out["timings"]["cohort_swap"]) == 3
    assert all(len(h["cohort"]) == 4 and max(h["cohort"]) < 8
               for h in hist)
    # round 0 gathers first-timers only: nothing crosses
    assert out["swap_bytes"][0] == 0 and min(out["swap_bytes"][1:]) > 0
    # the temporary page directory is gone, and the store with it
    assert out["pop_store"] is None


def test_launcher_population_equal_to_r_is_the_storeless_run():
    argv = SMOLLM + ["--rounds", "2", "--chaos"]
    plain = train.main(argv)
    pop = train.main(argv + ["--population", "4"])
    assert ([h["loss"] for h in plain["history"]]
            == [h["loss"] for h in pop["history"]])
    for field in ("params", "ef", "momentum"):
        mine = flatten(getattr(pop["state"], field))
        for k, v in flatten(getattr(plain["state"], field)).items():
            assert torch.equal(v, mine[k]), (field, k)


def test_launcher_store_root_spills_pages_of_clients_that_took_part(
        tmp_path):
    # 4R = 16 clients stay resident: the six cohorts of 4 from 64 that
    # leave the slots in seven rounds spill
    out = train.main(SMOLLM + ["--rounds", "7", "--population", "64",
                               "--store-root", str(tmp_path)])
    store = out["pop_store"]
    assert store is not None and store.resident_count <= 16
    took_part = set(np.flatnonzero(store.rounds_participated > 0))
    pages = {int(p.name[7:15]) for p in tmp_path.glob("client_*.npy")}
    assert pages and pages <= took_part
    assert store.rounds_participated.sum() == 7 * 4
    # the returned store still reads its spilled clients
    assert math.isfinite(float(store.aggregate("")))
    back = store.gather(sorted(pages)[:2])
    assert all(bool(torch.isfinite(t).all())
               for t in flatten(back).values())


@pytest.mark.parametrize("flags,says", [
    (["--population", "8", "--sparse-gossip", "--wire-ef"],
     "incompatible with cohort"),
    (["--population", "2"], "smaller than the mesh cohort")])
def test_launcher_refuses_what_the_reference_refuses(flags, says, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(SMOLLM + ["--rounds", "1"] + flags)
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


def test_fedsim_launcher_runs_chaos_with_cohorts(capsys):
    fedsim.main(["--device", "cpu", "--model", "mlp", "--devices", "8",
                 "--clusters", "4", "--n-train", "1024", "--rounds", "2",
                 "--eval-every", "2", "--chaos", "--population", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("hcef round")]
    assert len(lines) == 2
    assert all(" part=" in ln and " new=" in ln for ln in lines)


def test_chaos_smoke_contracts_hold(capsys):
    assert chaos_smoke.main(["--device", "cpu", "--rounds", "4"]) == 0
    assert "all degraded-mode contracts hold" in capsys.readouterr().out


def test_cohort_smoke_contracts_hold(capsys):
    assert cohort_smoke.main(["--device", "cpu", "--population", "1000",
                              "--rounds", "2"]) == 0
    assert "all population-engine contracts hold" in capsys.readouterr().out
