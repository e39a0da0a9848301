"""The port's HCEF round step on the dense LM against the JAX package's, on
the CPU.

``tests/test_torch_round.py``'s 4-round history, on the smoke smollm (f32,
2 layers, GQA 4/2 heads of 16, tied embeddings) instead of the smoke
mamba2: the host topology (2 clusters x 2 devices), tau = 4 and q = 2
(rounds 2 and 4 gossip), the same budgets, the reference's ``init_state``
parameters, the same token batches (33 tokens a sequence) and the
reference's masked-step bits.  Loss, rho, theta, the g2 / sigma2
statistics, the simulated time and energy and the final parameters,
momentum and EF are compared, at ``test_torch_round.py``'s tolerances.
On the CPU the attention is the plain blockwise version under autograd.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_round import (FAST_COMPILE, G2_RTOL,  # noqa: E402
                              HIST_RTOL, ROUNDS, SIGMA2_RTOL, STATE_TOL, TAU,
                              _history)

# f32 on the CPU.  Measured over the 4 rounds: loss within 9.4e-8
# relative, rho, theta, time and energy equal; g2 within 2.5e-6 and
# sigma2 within 1.6e-5 relative; parameters within 1.2e-6, momentum within
# 1.9e-5, EF within 2.6e-6.


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def histories():
    return (_history(port=False, arch="smollm_135m",
                     compiler_options=FAST_COMPILE),
            _history(port=True, arch="smollm_135m"))


def test_four_round_history_matches_reference(histories):
    (want, _, _), (got, _, state) = histories
    assert state.round_idx == ROUNDS
    # Q drops coordinates in some round; some steps masked and some not
    assert min(h["theta_mean"] for h in got) < 1.0
    steps = np.concatenate([h["steps"] for h in got])
    assert steps.min() < TAU and steps.max() > 0
    assert all(b["time"] > a["time"] and b["energy"] > a["energy"]
               for a, b in zip(got, got[1:]))
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
    assert {"emb", "layers/wq", "layers/wk", "layers/ln1"} <= set(want[field])
    for k, w in want[field].items():
        np.testing.assert_allclose(got[field][k], w, err_msg=k, **STATE_TOL)
    if field == "params":  # every device of a cluster holds its model
        for v in got[field].values():
            assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])
