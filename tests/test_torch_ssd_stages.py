"""The SSD scan in the stages the bf16 kernels run, against the JAX package.

``ref.ssd_fwd_stages`` ((a) G = C B^T per group, (b) each chunk's own state
terms, (c) the pass over chunks, (d) y) and ``ref.ssd_bwd_stages`` (the
gradient of each chunk's final state, passed in reverse; dx, dB, dC and
dcs per chunk; ddt and dA by a reverse cumsum) are held to the reference's
``ssd_chunked_jnp``, its Pallas kernel in interpret mode and ``jax.vjp`` of
``ssd_chunked_jnp`` on ``tests/test_torch_ssd.py``'s grid.  The chunk
states are held to the reference's final state of each prefix of whole
chunks.  Last, the kernels' precision design, emulated on the CPU: the f32
operands that enter the tensor cores as a bf16 hi + lo pair
(``ref.bf16_pair``) keep y within f32's tolerance of the f64 evaluation on
mamba2's decays, where one bf16 rounding would not.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` phase 8).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_ssd import (  # noqa: E402
    DTYPES, GRAD_RTOL_OF_MAX, GRID, GRID_IDS, STATE_TOL, _inputs, _np32, _tol,
    _torch)

# mamba2's regime (dt = softplus(N(0, 1)), about 0.7, A = -1): a chunk of
# 128 steps reaches cs of about -90, so the decays span many octaves.  y
# from the pair emulation, f32 arithmetic otherwise, is held to f32's
# tolerance (F32 2e-5) of y's largest entry; measured at 2.9e-6 and 3.6e-6
# of it on these inputs, with one bf16 rounding at 1.7e-3 and 2.0e-3.
MODEL_SHAPES = [(1, 256, 4, 32, 2, 32, 128), (1, 512, 2, 64, 1, 128, 256)]
PAIR_RTOL_OF_MAX = 2e-5
SINGLE_OVER_PAIR = 20.0  # one rounding is at least this much worse


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_stages_compose_to_the_plain_version(case):
    """In f64 the stages give ssd_chunked's y and, chunk by chunk, the
    state it carries (its final state of each prefix)."""
    jargs, chunk = _inputs(case, jnp.float32, seed=5)
    targs = [t.double() for t in _torch(jargs)]
    y, states = ref.ssd_fwd_stages(*targs, chunk=chunk)
    y0, _ = ref.ssd_chunked(*targs, chunk=chunk)
    np.testing.assert_allclose(y.numpy(), y0.numpy(), rtol=1e-12,
                               atol=1e-12)
    for c in range(1, states.shape[2]):
        cut = [t[:, :c * chunk] if t.ndim > 1 else t for t in targs]
        np.testing.assert_allclose(
            states[:, :, c].numpy(),
            ref.ssd_chunked(*cut, chunk=chunk)[1].numpy(), rtol=1e-12,
            atol=1e-12)
    assert not states[:, :, 0].any()


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_stages_forward_matches_reference(case, dname):
    jargs, chunk = _inputs(case, DTYPES[dname])
    targs = _torch(jargs)
    tol = _tol(dname)
    y, states = ref.ssd_fwd_stages(*targs, chunk=chunk)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    b, s, h, p = targs[0].shape
    assert states.shape == (b, h, -(-s // chunk), p, targs[3].shape[3])
    chunked = jax.jit(jref.ssd_chunked_jnp, static_argnames="chunk")
    jy, _ = chunked(*jargs, chunk=chunk)
    np.testing.assert_allclose(_np32(y), _np32(jy), **tol)
    np.testing.assert_allclose(_np32(y), _np32(jops.ssd(
        *jargs, chunk=chunk, impl="pallas")), **tol)
    for c in range(1, states.shape[2]):  # the reference's prefix states
        cut = [a[:, :c * chunk] if a.ndim > 1 else a for a in jargs]
        _, jst = chunked(*cut, chunk=chunk)
        np.testing.assert_allclose(states[:, :, c].numpy(), np.asarray(jst),
                                   **STATE_TOL)


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_stages_backward_matches_reference(case):
    """(dx, ddt, dA, dB, dC) of sum(y * dy) from the stages, given the
    forward stages' chunk states, against jax.vjp of ssd_chunked_jnp,
    f32."""
    jargs, chunk = _inputs(case, jnp.float32, seed=1)
    dy = np.random.default_rng(2).normal(size=jargs[0].shape).astype(
        np.float32)
    fwd = lambda *a: jref.ssd_chunked_jnp(*a, chunk=chunk)[0]
    want = jax.jit(lambda a, c: jax.vjp(fwd, *a)[1](c))(jargs,
                                                        jnp.asarray(dy))
    targs = _torch(jargs)
    _, states = ref.ssd_fwd_stages(*targs, chunk=chunk)
    got = ref.ssd_bwd_stages(torch.from_numpy(dy), *targs, states,
                             chunk=chunk)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL_OF_MAX * scale,
                                   err_msg=name)


@pytest.mark.parametrize("case", MODEL_SHAPES, ids=["L128", "L256"])
def test_pair_rounding_keeps_y_at_f32_precision(case):
    """The forward with every f32 tensor-core operand (W = G o decay o dt,
    the start states, x times its decay) rounded as the kernels feed it,
    on bf16 x, B, C and mamba2's dt and A, against the same stages in
    f64."""
    b, s, h, p, g, n, chunk = case
    rng = np.random.default_rng(7)
    bf = lambda *shape: torch.from_numpy(rng.normal(size=shape)).to(
        torch.bfloat16).float()
    x, B, C = bf(b, s, h, p), bf(b, s, g, n), bf(b, s, g, n)
    dt = torch.nn.functional.softplus(
        torch.from_numpy(rng.normal(size=(b, s, h)))).float()
    A = -torch.ones(h)
    y64, _ = ref.ssd_fwd_stages(*[t.double() for t in (x, dt, A, B, C)],
                                chunk=chunk)
    scale = float(y64.abs().max())
    err = {}
    for name, op in (("pair", ref.bf16_pair),
                     ("single", lambda v: v.to(torch.bfloat16).float())):
        y, _ = ref.ssd_fwd_stages(x, dt, A, B, C, chunk=chunk, op=op)
        assert y.dtype == torch.float32
        err[name] = float((y.double() - y64).abs().max()) / scale
    assert err["pair"] <= PAIR_RTOL_OF_MAX, err
    assert err["single"] >= SINGLE_OVER_PAIR * err["pair"], err


def test_bf16_pair_keeps_sixteen_bits():
    v = torch.from_numpy(np.random.default_rng(3).normal(size=4096)).float()
    hi = v.to(torch.bfloat16).float()
    rel = ((ref.bf16_pair(v) - v).abs() / v.abs()).max()
    assert float(rel) <= 2.0 ** -16
    assert float(((hi - v).abs() / v.abs()).max()) > 2.0 ** -10
