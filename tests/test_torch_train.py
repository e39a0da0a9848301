"""The port's train launcher on the CPU: it runs the smoke mamba2, smollm
and qwen2-7b through the HCEF round step and prints finite losses;
``--ckpt-dir`` saves the round state every round; every option it does
not port exits and names the ROADMAP.md item that brings it; without a
card it refuses to run unless asked for the CPU."""
import math

import pytest
import torch

from repro_torch.core.round import client_template
from repro_torch.launch import train
from repro_torch.runtime.checkpoint import latest_checkpoint, load_pytree
from repro_torch.runtime.population import PopulationStore
from repro_torch.tree import flatten

SMOKE = ["--device", "cpu", "--arch", "mamba2_1p3b", "--rounds", "2",
         "--seq", "40"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launcher_runs_the_smoke_round_on_the_cpu(capsys):
    out = train.main(SMOKE)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    assert len(lines) == 2 and len(out["history"]) == 2
    assert out["cfg"].num_layers == 2 and out["cfg"].family == "ssm"
    assert out["n_params"] == 89_136
    for rec in out["history"]:
        assert math.isfinite(rec["loss"]) and 0 < rec["loss"] < 10
        assert 0 < rec["rho_mean"] <= 1 and 0 < rec["theta_mean"] <= 1
    assert out["history"][1]["time"] > out["history"][0]["time"] > 0
    assert set(out["timings"]) == {"device_round", "compress", "aggregate"}
    assert out["peak_mem_gb"] is None  # no device metric off the card


@pytest.mark.parametrize("flag", [["--mesh", "single"], ["--mesh", "multi"]])
def test_unported_options_exit_naming_the_roadmap(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(SMOKE + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err


@pytest.mark.parametrize("extra", [[], ["--population", "8"]])
def test_launcher_ckpt_dir_saves_every_round(extra, tmp_path):
    """``--ckpt-dir``: the round state after each round (and with a
    population the store's manifest), loading back equal to the state."""
    out = train.main(["--device", "cpu", "--arch", "smollm_135m", "--rounds",
                      "2", "--seq", "40", "--ckpt-dir", str(tmp_path)]
                     + extra)
    names = sorted(p.name for p in tmp_path.glob("*.npz"))
    want = ["ckpt_000000.npz", "ckpt_000001.npz"]
    if extra:
        want += ["ckpt_000000.pop.npz", "ckpt_000001.pop.npz"]
    assert names == sorted(want)
    assert [c["path"] for c in out["ckpts"]] == [
        str(tmp_path / n) for n in want[:2]]
    assert all(c["bytes"] > 0 and c["write_ms"] >= 0 for c in out["ckpts"])
    if not extra:
        # with a population the directory also holds the manifests, which
        # latest_checkpoint picks as the reference's does (ROADMAP.md §3)
        assert latest_checkpoint(tmp_path).name == "ckpt_000001.npz"
    tree = train.state_tree(out["state"])
    assert set(tree) == {"params", "momentum", "ef", "round_idx"}
    back, meta = load_pytree(tmp_path / "ckpt_000001.npz", tree)
    assert meta["round"] == 1
    assert int(back["round_idx"]) == 2
    for k, v in flatten(tree).items():
        assert torch.equal(flatten(back)[k], v), k
    if extra:
        assert meta["cohort_ids"] == [int(c) for c in out["cohort_ids"]]
        # the manifest's pinned pages outlive the run under DIR/pop_store
        store = out["pop_store"]
        fresh = PopulationStore(8, client_template(out["state"]),
                                root=tmp_path / "pop_store")
        fresh.restore(tmp_path / "ckpt_000001.pop.npz")
        ids = list(range(8))
        for k, v in flatten(store.gather(ids)).items():
            assert torch.equal(flatten(fresh.gather(ids))[k], v), k
        assert (fresh.rounds_participated == store.rounds_participated).all()


def test_launcher_refuses_profile_with_ckpt_dir(tmp_path, capsys):
    """The checkpoints' host writes would fall in the traced window."""
    with pytest.raises(SystemExit) as exc:
        train.main(SMOKE + ["--profile", "--ckpt-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert "--profile with --ckpt-dir" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("arch,n_params", [("smollm_135m", 106_816),
                                            ("qwen2_7b", 139_840)])
def test_launcher_trains_the_dense_smoke_models_on_the_cpu(arch, n_params,
                                                          capsys):
    """The dense archs, unported until the attention backward kernel
    came, run their smoke models two rounds through the round step."""
    out = train.main(["--device", "cpu", "--arch", arch, "--rounds", "2",
                      "--seq", "40"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    assert len(lines) == 2 and len(out["history"]) == 2
    assert out["cfg"].num_layers == 2 and out["cfg"].family == "dense"
    assert out["n_params"] == n_params
    for rec in out["history"]:
        assert math.isfinite(rec["loss"]) and 0 < rec["loss"] < 10
        assert 0 < rec["rho_mean"] <= 1 and 0 < rec["theta_mean"] <= 1
    assert out["history"][1]["time"] > out["history"][0]["time"] > 0
    assert set(out["timings"]) == {"device_round", "compress", "aggregate"}
    assert out["peak_mem_gb"] is None


def test_launcher_profile_traces_the_rounds_after_the_first(capsys):
    out = train.main(SMOKE + ["--profile"])
    text = capsys.readouterr().out
    assert len(out["history"]) == 2
    assert "profile: wall" in text and "busy share 0.000" in text


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(SMOKE[2:])


def test_serve_launcher_refuses_the_ssm_family(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--continuous", "--device", "cpu", "--arch",
                    "mamba2_1p3b"])
    assert "--continuous cannot serve" in capsys.readouterr().err
