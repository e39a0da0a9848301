"""The static serving path of the recurrent families against the JAX
package's, on the CPU: ``mamba2`` (the conv window and the f32 SSM
state; prefill through the chunked scan's plain version, decode through
``ref.ssd_decode_step``) and ``griffin`` (the RG-LRU blocks' conv windows
and LRU states, the local attention's rolling ring).

Smoke configs in f32 with the reference's weights carried over:
``init_cache``, ``prefill`` and 5 ``decode_step``s fed the same tokens,
logits and every cache leaf within ``test_torch_lm.py``'s TOL
(``test_torch_generate.static_parity``).  Griffin's window is 16: a
10-token prompt (S < W, zero-padded ring), a 14-token one whose decode
wraps the ring, and 40 tokens (S >= W, the last 16 rolled into slots pos
% W), at 3 layers (one rglru, rglru, attn group) and 5 (two trailing
rglru blocks).  Then the serve launcher without ``--continuous``.
"""
import pytest
import torch

pytest.importorskip("jax")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from test_torch_generate import TOL, static_parity  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("S", [5, 32, 37])
def test_mamba2_static_cache_matches_reference(S):
    """S 32 fills two scan chunks of 16, 37 pads the last, 5 fills less
    than one."""
    static_parity("mamba2_1p3b", S=S, max_len=S + 8)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(0)
    b, h, p, g, n = 2, 4, 8, 2, 16
    arrs = dict(state=rng.normal(size=(b, h, p, n)),
                x=rng.normal(size=(b, h, p)),
                dt=rng.uniform(0.1, 1.0, (b, h)), A=-rng.uniform(0.5, 2, h),
                B=rng.normal(size=(b, g, n)), C=rng.normal(size=(b, g, n)))
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    js, jy = jref.ssd_decode_step(*(jnp.asarray(v) for v in arrs.values()))
    s, y = ref.ssd_decode_step(*(torch.from_numpy(v)
                                 for v in arrs.values()))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert s.dtype == torch.float32 and y.dtype == torch.float32


@pytest.mark.parametrize("S,layers", [(10, 3), (14, 3), (40, 3), (40, 5)],
                         ids=["short", "wraps-in-decode", "rolled",
                              "rolled-5-layers"])
def test_griffin_static_cache_matches_reference(S, layers):
    static_parity("recurrentgemma_9b", S=S, max_len=64, num_layers=layers)


def test_griffin_ring_is_the_max_len_when_shorter():
    """A max_len under the window sizes the ring (reference
    griffin.py:197): 12 slots, a 10-token prompt decoding past them."""
    static_parity("recurrentgemma_9b", S=10, max_len=12)


@pytest.mark.parametrize("arch", ["mamba2_1p3b", "recurrentgemma_9b"])
def test_launcher_generates_on_cpu(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                "--new-tokens", "4", "--temperature", "0"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "generated 8 tokens" in out
