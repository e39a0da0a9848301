"""Three rounds of the port's ResNet-20 FedSim against the JAX package's.

The pair of ``test_torch_fedsim_resnet.py`` (2 devices in 2 clusters,
batch 4, the ResNet-20 configuration's round and budgets) runs three HCEF
rounds on each side from the same parameters, data and masked-step bits:
Q drops coordinates (theta < 1), the second round gossips, and the last
evaluates.  Both run in f32, as the FedSim does.
"""
import pytest

pytest.importorskip("jax")

from test_torch_fedsim_resnet import N_TEST, make_pair  # noqa: E402

# At batch 4 a ReLU input within f32 rounding of 0 takes the other side of
# the kink in one framework (see the device-round test), and the
# controller turns the resulting few-1e-4 change in sigma^2 and G^2 into a
# few-1e-3 change in theta and rho.  Measured over the three rounds: loss
# 3.5e-3, rho 6.1e-2, theta 5.8e-3, time 2.0e-2, energy 1.6e-2, sigma^2
# 2.9e-2, G^2 1.6e-2 relative, the same accuracy.  The loss rises on both
# sides alike (3.65, 4.70, 8.05 in the reference).
HIST_RTOL = {"loss": 2e-2, "rho_mean": 2e-1, "theta_mean": 1e-1,
             "time": 1e-1, "energy": 1e-1, "sigma2": 1e-1, "G2": 1e-1}
ACC_ATOL = 2 / N_TEST  # two eval predictions


def test_resnet20_three_round_history_matches_reference():
    ref, port, _ = make_pair()
    want = ref.run(3, eval_every=3)
    got = port.run(3, eval_every=3)
    assert port.budget.l == 1  # one gossip round (q = 2)
    assert min(h["theta_mean"] for h in got) < 1.0  # Q drops coordinates
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["round"] == w["round"]
        assert set(g) == set(w), set(g) ^ set(w)
        for k, rtol in HIST_RTOL.items():
            assert abs(g[k] - w[k]) <= rtol * abs(w[k]), (w["round"], k,
                                                          g[k], w[k])
    assert abs(got[-1]["acc"] - want[-1]["acc"]) <= ACC_ATOL
    # the loss rises over the three rounds in the reference as in the port
    assert want[-1]["loss"] > want[0]["loss"]
    assert got[-1]["loss"] > got[0]["loss"]
