"""The port's HCEF round step on the MoE LM and on bf16 momentum against
the JAX package's, on the CPU.

``tests/test_torch_round.py``'s history, two gossip rounds of it (q = 1:
one reference program to compile an arch), on the smoke granite-moe-1b-a400m (f32, 2 layers, 4 experts,
top 2: the router and the expert leaves go through Q and the gossip
like any other) and on the smoke phi3-medium-14b (dense, untied head,
momentum in bf16 through ``state_dtype``): the host topology (2 clusters
x 2 devices), tau = 4, the same budgets, the reference's ``init_state``
parameters, the same token batches and the reference's masked-step bits.
Loss, rho, theta, the g2 / sigma2 statistics, the simulated time and
energy and the final parameters, momentum and EF are compared, at
``test_torch_round.py``'s tolerances.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from test_torch_round import (G2_RTOL, HIST_RTOL,  # noqa: E402
                              SIGMA2_RTOL, STATE_TOL, TAU, _history)

ROUNDS, Q = 2, 1
# XLA on the CPU drops the bf16 rounding of the new momentum where the
# parameter update reads it (excess precision); off, the reference's
# update is its program's, bit for bit the port's (``optim/sgd.py``)
EXACT_BF16 = {"xla_allow_excess_precision": False}
ARCHS = ["granite_moe_1b_a400m", "phi3_medium_14b"]
# phi3's momentum is bf16: where XLA and ATen sum a gradient in another
# order, a momentum entry can round to the neighbouring bf16 value, which
# then moves the parameters and the next gradients.  Measured over the 2
# rounds: 255 of 558,336 momentum entries beyond STATE_TOL (one bf16
# step, at most 9.8e-4), 3 EF entries (top-k threshold flips, 3.5e-4),
# sigma2 within 2.5e-4 relative; parameters within 8.8e-5.  granite:
# parameters within 2.4e-7, sigma2 within 1.7e-6 relative.  Held: at most
# BF16_FLIP_SHARE of the momentum's entries beyond STATE_TOL, those
# within the bf16 tolerance of tests/test_kernels.py:12; the EF's at most
# FLIP_SHARE (tests/test_torch_round_chaos.py); sigma2 within
# BF16_SIGMA2_RTOL.  granite (f32 momentum) is held to STATE_TOL whole.
BF16_FLIP_SHARE = 1e-3
FLIP_SHARE = 1e-4
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
BF16_SIGMA2_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares (as
    tests/test_torch_launch_chaos.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def histories(request):
    return (request.param,
            _history(port=False, arch=request.param, rounds=ROUNDS, q=Q,
                     compiler_options=EXACT_BF16),
            _history(port=True, arch=request.param, rounds=ROUNDS, q=Q))


def test_two_round_history_matches_reference(histories):
    arch, (want, _, _), (got, _, state) = histories
    assert state.round_idx == ROUNDS
    assert min(h["theta_mean"] for h in got) < 1.0
    steps = np.concatenate([h["steps"] for h in got])
    assert steps.min() < TAU and steps.max() > 0
    sigma2_rtol = BF16_SIGMA2_RTOL if arch.startswith("phi3") else \
        SIGMA2_RTOL
    for r, (g, w) in enumerate(zip(got, want)):
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (r, k, g[k], w[k])
        np.testing.assert_array_equal(g["steps"], w["steps"])
        np.testing.assert_allclose(g["g2"], w["g2"], rtol=G2_RTOL)
        np.testing.assert_allclose(g["sigma2"], w["sigma2"],
                                   rtol=sigma2_rtol)


@pytest.mark.parametrize("field", ["params", "momentum", "ef"])
def test_final_state_matches_reference(histories, field):
    arch, (_, want, jstate), (_, got, state) = histories
    assert set(got[field]) == set(want[field])
    bf16 = arch.startswith("phi3")
    if not bf16:
        assert {"layers/router", "layers/we_gate", "layers/we_up",
                "layers/we_down"} <= set(want[field])
    if field == "momentum":  # phi3 keeps it in bf16, granite in f32
        dt = "bfloat16" if bf16 else "float32"
        assert {str(v.dtype) for v in jstate.momentum["layers"].values()} \
            == {dt}
        assert {str(v.dtype)[6:] for v in
                state.momentum["layers"].values()} == {dt}
    share = {"params": 0.0, "momentum": BF16_FLIP_SHARE,
             "ef": FLIP_SHARE}[field] if bf16 else 0.0
    off = size = 0
    for k, w in want[field].items():
        g, w = got[field][k].astype(np.float32), w.astype(np.float32)
        if bf16 and field == "momentum":
            np.testing.assert_allclose(g, w, err_msg=k, **BF16_TOL)
        off += int((~np.isclose(g, w, **STATE_TOL)).sum())
        size += w.size
    assert off <= share * size, (field, off, size)
    if field == "params":  # every device of a cluster holds its model
        for v in got[field].values():
            assert np.array_equal(v[0], v[1]) and np.array_equal(v[2], v[3])


def test_bf16_momentum_update_is_the_references_bit_for_bit():
    """A bf16 momentum buffer decays by bf16(0.9) = 0.8984375 with the f32
    gradient cast to bf16 first, each op rounded to bf16, as the
    reference's ``0.9 * m + g.astype(m.dtype)``; the f32 parameters then
    step by the rounded momentum (the reference compiled without excess
    precision)."""
    from repro.optim import sgd as jsgd
    from repro_torch.optim import sgd
    rng = np.random.default_rng(5)
    p, g, m = (rng.standard_normal(1 << 14).astype(np.float32)
               for _ in range(3))
    args = (jnp.asarray(p), jnp.asarray(g), jnp.asarray(m, jnp.bfloat16))
    step = jax.jit(lambda p, g, m: jsgd.sgd_update(
        {"a": p}, {"a": g}, {"a": m}, lr=0.1, momentum=0.9))
    jp, jm = step.lower(*args).compile(compiler_options=EXACT_BF16)(*args)
    tp, tm = torch.tensor(p), torch.tensor(m).bfloat16()
    sgd.sgd_update_([tp], [torch.tensor(g)], [tm], lr=0.1, momentum=0.9)
    assert np.array_equal(tm.float().numpy(),
                          np.asarray(jm["a"]).astype(np.float32))
    assert np.array_equal(tp.numpy(), np.asarray(jp["a"]))
    fp, fm = sgd.sgd_update({"a": torch.tensor(p)}, {"a": torch.tensor(g)},
                            {"a": torch.tensor(m).bfloat16()}, lr=0.1,
                            momentum=0.9)
    assert torch.equal(fm["a"], tm)
