"""The port's train launcher on the CPU: it runs the smoke mamba2 through
the HCEF round step and prints finite losses; every option it does not
port exits and names the ROADMAP.md item that brings it; without a card it
refuses to run unless asked for the CPU."""
import math

import pytest
import torch

from repro_torch.launch import train

SMOKE = ["--device", "cpu", "--arch", "mamba2_1p3b", "--rounds", "2",
         "--seq", "40"]


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


@pytest.mark.parametrize("flag", [
    ["--stale-quantile", "0.5"], ["--cohort-seed", "1"],
    ["--chaos-partition", "0.1"], ["--overlap"], ["--staleness", "0"], ["--population", "8"],
    ["--chaos"], ["--chaos-dropout", "0.1"], ["--ckpt-dir", "x"],
    ["--mesh", "single"], ["--mesh", "multi"],
    ["--arch", "smollm_135m"], ["--arch", "qwen2_7b"]])
def test_unported_options_exit_naming_the_roadmap(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(SMOKE + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported yet" in err and "ROADMAP.md" in err


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
    assert "ROADMAP.md" in capsys.readouterr().err
