"""The port's HCEF round step on the last two architectures against the JAX
package's, on the CPU, and the train launcher on both.

``tests/test_torch_round.py``'s history on the smoke internvl2-2b (f32, 2
layers, GQA 4/2 heads of 16, an untied head, ``vit_stub`` with 8 patch
positions) and the smoke seamless-m4t-large-v2 (f32, 2 decoder and 2
encoder layers, 4 heads of 16 over 4 KV heads, cross-attention), 2
rounds (the second gossips): the host topology (2 clusters x 2 devices),
tau = 4, the same budgets, the reference's ``init_state`` parameters, the
same token batches, the reference's masked-step bits, and the same
frontend inputs beside the tokens (``patch_embeds`` (n, 8, 64) and
``frames`` (n, 33, 64), N(0, 1) from a numpy generator seeded by the
round), which the reference's ``make_round_step`` splits as it splits the
tokens.  Loss, rho, theta, the g2 / sigma2 statistics, the simulated time
and energy and the final parameters, momentum and EF are compared, at
``test_torch_round.py``'s tolerances.  The reference's launcher feeds
tokens alone and cannot train these configs; the port's feeds N(0, 1)
stand-ins (``launch/train.frontend_stand_ins``).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from test_torch_round import (G2_RTOL, HIST_RTOL,  # noqa: E402
                              SIGMA2_RTOL, STATE_TOL, TAU, _history)

ROUNDS = 2
FAST_COMPILE = {"xla_backend_optimization_level": 0}
ARCHS = {"internvl2_2b": ("patch_embeds", 8),
         "seamless_m4t_large_v2": ("frames", 33)}
# f32 on the CPU.  Measured over the 2 rounds, both architectures: loss
# within 9.0e-8 relative, rho, theta, time and energy equal; g2 within
# 4.1e-7 and sigma2 within 1.8e-6 relative; parameters within 1.5e-8,
# momentum within 9.7e-8, EF within 1.5e-8.


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(arch):
    """The round's frontend inputs: ``extra`` of ``_history``."""
    key, positions = ARCHS[arch]

    def extra(rnd, n):
        rng = np.random.default_rng(100 + rnd)
        return {key: rng.standard_normal((n, positions, 64),
                                         dtype=np.float32)}
    return extra


@pytest.fixture(scope="module", params=sorted(ARCHS))
def histories(request, _one_thread):
    # XLA's backend optimisations off: the reference's round steps compile
    # faster, and only their outputs are compared
    arch = request.param
    return arch, (_history(port=False, arch=arch, rounds=ROUNDS,
                           compiler_options=FAST_COMPILE,
                           extra=_inputs(arch)),
                  _history(port=True, arch=arch, rounds=ROUNDS,
                           extra=_inputs(arch)))


def test_two_round_history_matches_reference(histories):
    _, ((want, _, _), (got, _, state)) = histories
    assert state.round_idx == ROUNDS
    steps = np.concatenate([h["steps"] for h in got])
    assert steps.min() < TAU and steps.max() > 0
    for r, (g, w) in enumerate(zip(got, want)):
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (r, k, g[k], w[k])
        np.testing.assert_array_equal(g["steps"], w["steps"])
        np.testing.assert_allclose(g["g2"], w["g2"], rtol=G2_RTOL)
        np.testing.assert_allclose(g["sigma2"], w["sigma2"],
                                   rtol=SIGMA2_RTOL)


@pytest.mark.parametrize("field", ["params", "momentum", "ef"])
def test_final_state_matches_reference(histories, field):
    arch, ((_, want, _), (_, got, _)) = histories
    assert set(got[field]) == set(want[field])
    if arch == "seamless_m4t_large_v2":
        assert {"enc_layers/wq", "enc_norm", "layers/wxk",
                "out_head"} <= set(want[field])
    for k, w in want[field].items():
        np.testing.assert_allclose(got[field][k], w, err_msg=k, **STATE_TOL)
    if field == "params":  # every device of a cluster holds its model
        for v in got[field].values():
            assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])


@pytest.mark.parametrize("arch,n_params", [("internvl2_2b", 139_584),
                                           ("seamless_m4t_large_v2",
                                            262_912)])
def test_launcher_trains_the_smoke_model_on_the_cpu(arch, n_params, capsys):
    """Four rounds (the fourth gossips, q = 4) through ``train.main`` with
    the stand-ins."""
    out = train.main(["--device", "cpu", "--arch", arch, "--rounds", "4",
                      "--seq", "16"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    assert len(lines) == 4 and len(out["history"]) == 4
    assert out["n_params"] == n_params
    assert [r["gossip"] for r in out["history"]] == [False] * 3 + [True]
    for rec in out["history"]:
        assert np.isfinite(rec["loss"]) and 0 < rec["loss"] < 10
        assert rec["time"] > 0


@pytest.mark.parametrize("arch,key,shape", [
    ("internvl2_2b", "patch_embeds", (4, 8, 64)),
    ("seamless_m4t_large_v2", "frames", (4, 33, 64))])
def test_stand_ins_draw_from_their_own_generator(arch, key, shape):
    """N(0, 1) patch embeddings or frames drawn anew each round from
    ``default_rng(seed)`` alone, so the launcher's token stream is
    untouched; nothing for a config without a frontend."""
    draw = train.frontend_stand_ins(smoke_model(get_config(arch).model), 4,
                                    33, seed=7)
    first, second = draw(), draw()
    rng = np.random.default_rng(7)
    for got in (first, second):
        assert set(got) == {key}
        assert got[key].shape == shape and got[key].dtype == torch.float32
        np.testing.assert_array_equal(
            got[key].numpy(), rng.standard_normal(shape, dtype=np.float32))
    smollm = smoke_model(get_config("smollm_135m").model)
    assert train.frontend_stand_ins(smollm, 4, 33, 0)() == {}


@pytest.mark.parametrize("arch", ["internvl2_2b", "seamless_m4t_large_v2"])
def test_serve_launcher_refuses_naming_item_4(arch, capsys):
    """Item 4 is done: --continuous refuses both (the paged path takes no
    stand-ins and has no cross-attention), the static path serves both
    (test_torch_generate.py)."""
    with pytest.raises(SystemExit):
        serve.main(["--continuous", "--device", "cpu", "--arch", arch])
    assert "--continuous cannot serve" in capsys.readouterr().err
