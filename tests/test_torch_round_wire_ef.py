"""The port's fused round step with the CHOCO wire error feedback against
the JAX package's, on the CPU: the run of tests/test_torch_round_sparse.py
(smoke mamba2 f32, 2 x 2, 4 rounds, q = 2, the int4 wire at per-cluster
levels (0.1, 0.6) in both gossip rounds; the fallback is covered there)
with ``wire_ef=True``; the estimates ``FLState.wire_ef`` are compared with
the state.  In a file of its own so that each file's reference compiles
stay under a minute."""
import pytest

pytest.importorskip("jax")

from test_torch_round_sparse import (_run, check_final_state,  # noqa: E402
                                     check_history)


@pytest.fixture(scope="module")
def runs():
    return _run(wire_ef=True, fallback=False)


def test_history_matches_reference(runs):
    check_history(*runs)


def test_final_state_matches_reference(runs):
    check_final_state(runs[0], wire_ef=True)
