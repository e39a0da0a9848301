"""The port's HCEF round step on the hybrid family against the JAX
package's, on the CPU.

``tests/test_torch_round.py``'s history on the smoke recurrentgemma-9b
(f32, 3 layers: rglru, rglru, attn; 4 query heads of 16 over one KV head,
window 16 under 33-token sequences, lru_width 64), 2 rounds (the second
gossips): the host topology (2 clusters x 2 devices), tau = 4, the same
budgets, the reference's ``init_state`` parameters, the same token
batches and the reference's masked-step bits.  Loss, rho, theta, the g2 /
sigma2 statistics, the simulated time and energy and the final
parameters, momentum and EF are compared, at ``test_torch_round.py``'s
tolerances.  On the CPU the attention is the plain blockwise version and
the RG-LRU the log-depth scan, both under autograd.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_round import (G2_RTOL, HIST_RTOL,  # noqa: E402
                              SIGMA2_RTOL, STATE_TOL, TAU, _history)

ROUNDS = 2
FAST_COMPILE = {"xla_backend_optimization_level": 0}
# f32 on the CPU.  Measured over the 2 rounds: loss within 9.2e-8
# relative, rho, theta, time and energy equal; g2 within 3.3e-7 and sigma2
# within 1.5e-5 relative; parameters within 1.2e-7, momentum within
# 6.0e-8, EF within 1.5e-8.


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def histories(_one_thread):
    # XLA's backend optimisations off: the reference's two round steps
    # compile in about 15 s instead of 23 s
    return (_history(port=False, arch="recurrentgemma_9b", rounds=ROUNDS,
                     compiler_options=FAST_COMPILE),
            _history(port=True, arch="recurrentgemma_9b", rounds=ROUNDS))


def test_two_round_history_matches_reference(histories):
    (want, _, _), (got, _, state) = histories
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
    (_, want, _), (_, got, _) = histories
    assert set(got[field]) == set(want[field])
    assert {"emb", "rec_layers/log_lambda", "rec_layers/wa",
            "attn_layers/wq"} <= set(want[field])
    for k, w in want[field].items():
        np.testing.assert_allclose(got[field][k], w, err_msg=k, **STATE_TOL)
    if field == "params":  # every device of a cluster holds its model
        for v in got[field].values():
            assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])
