"""The port's plain SSD scan against the JAX package's.

``ref.ssd_chunked`` (the plain version of the forward kernel) and
``ref.ssd_ref`` are held to the reference's ``ssd_chunked_jnp``,
``ssd_ref`` and its Pallas kernel (interpret mode, as
``tests/test_kernels.py`` runs it) on the reference's grid plus a length
that is not a multiple of the chunk; the plain backward (autograd through
``ssd_chunked``, what the backward kernel is held against on the card) is
held to ``jax.vjp`` of ``ssd_chunked_jnp``.  The CUDA kernels themselves
run only on the card (``chip_smoke.py`` phase 8).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.device import from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_plain  # noqa: E402

# tests/test_kernels.py:96 plus one padded length (33 = 2 chunks + 1)
GRID = [(1, 32, 2, 16, 1, 8, 8), (2, 64, 4, 16, 2, 16, 16),
        (1, 128, 8, 32, 8, 16, 32), (2, 33, 4, 16, 2, 8, 16)]
GRID_IDS = ["g1", "g2", "g8", "g2-padded"]
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(name):
    # the reference's _tol (tests/test_kernels.py:12)
    return (dict(atol=2e-2, rtol=2e-2) if name == "bf16"
            else dict(atol=2e-5, rtol=2e-5))


# The gradients (f32) are sums of up to s * n products; XLA and ATen sum in
# other orders.  Measured at <= 4.7e-7 of each gradient's largest entry on
# this grid (dA of the padded case); held to 5e-6 of it.
GRAD_RTOL_OF_MAX = 5e-6
STATE_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_kernels.py:108


def _inputs(case, dtype, seed=0):
    """numpy inputs drawn as tests/test_kernels.py draws them; x, B, C
    rounded to ``dtype`` by JAX, so both packages see the same values."""
    b, s, h, p, g, n, chunk = case
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(b, s, h, p)), dtype)
    dt = jnp.asarray(rng.uniform(0.001, 0.1, size=(b, s, h)), jnp.float32)
    A = -jnp.asarray(rng.uniform(0.5, 2.0, size=(h,)), jnp.float32)
    B = jnp.asarray(rng.normal(size=(b, s, g, n)), dtype)
    C = jnp.asarray(rng.normal(size=(b, s, g, n)), dtype)
    return [x, dt, A, B, C], chunk


def _torch(args):
    return [from_numpy(np.asarray(a), "cpu") for a in args]


def _np32(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, np.float32))


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("dname", sorted(DTYPES))
def test_plain_forward_matches_reference(case, dname):
    jargs, chunk = _inputs(case, DTYPES[dname])
    targs = _torch(jargs)
    tol = _tol(dname)
    y, st = ref.ssd_chunked(*targs, chunk=chunk)
    jy, jst = jax.jit(jref.ssd_chunked_jnp, static_argnames="chunk")(
        *jargs, chunk=chunk)
    assert y.dtype == targs[0].dtype and y.shape == targs[0].shape
    np.testing.assert_allclose(_np32(y), _np32(jy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **STATE_TOL)
    # the sequential oracles, and the Pallas kernel in interpret mode
    y_seq, st_seq = ref.ssd_ref(*targs)
    jy_seq, jst_seq = jax.jit(jref.ssd_ref)(*jargs)
    np.testing.assert_allclose(_np32(y_seq), _np32(jy_seq), **tol)
    np.testing.assert_allclose(st_seq.numpy(), np.asarray(jst_seq),
                               **STATE_TOL)
    jy_pl = jops.ssd(*jargs, chunk=chunk, impl="pallas")
    np.testing.assert_allclose(_np32(y), _np32(jy_pl), **tol)
    np.testing.assert_allclose(_np32(y), _np32(y_seq), **tol)


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_plain_gradient_matches_reference(case):
    """d/d(x, dt, A, B, C) of sum(y * dy): autograd through the port's
    ssd_chunked against jax.vjp of ssd_chunked_jnp, f32."""
    jargs, chunk = _inputs(case, jnp.float32, seed=1)
    dy = np.random.default_rng(2).normal(size=jargs[0].shape).astype(
        np.float32)
    fwd = lambda *a: jref.ssd_chunked_jnp(*a, chunk=chunk)[0]
    want = jax.jit(lambda a, c: jax.vjp(fwd, *a)[1](c))(jargs,
                                                        jnp.asarray(dy))
    targs = [t.requires_grad_() for t in _torch(jargs)]
    y = ssd_plain(*targs, chunk=chunk)
    got = torch.autograd.grad(y, targs, torch.from_numpy(dy))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL_OF_MAX * scale,
                                   err_msg=name)


@pytest.mark.parametrize("case", GRID, ids=GRID_IDS)
def test_plain_evaluates_f64_inputs_in_f64(case):
    """f64 inputs run the same sums in f64 (the oracle the backward
    kernel is held to on the card): y and the gradients come back in f64
    and agree with the f32 evaluation to f32's tolerances."""
    jargs, chunk = _inputs(case, jnp.float32, seed=3)
    dy = torch.from_numpy(np.random.default_rng(4).normal(
        size=jargs[0].shape))
    out = {}
    for dt in (torch.float32, torch.float64):
        targs = [t.to(dt).requires_grad_() for t in _torch(jargs)]
        y = ssd_plain(*targs, chunk=chunk)
        out[dt] = (y, torch.autograd.grad(y, targs, dy.to(dt)))
    y64, g64 = out[torch.float64]
    y32, g32 = out[torch.float32]
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y32.detach().numpy(), y64.detach().numpy(),
                               **_tol("f32"))
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), g32, g64):
        assert w.dtype == torch.float64, name
        scale = float(w.abs().max())
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_RTOL_OF_MAX * scale,
                                   err_msg=name)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    jargs, chunk = _inputs(GRID[1], jnp.float32)
    targs = _torch(jargs)
    assert torch.equal(ops.ssd(*targs, chunk=chunk),
                       ssd_plain(*targs, chunk=chunk))
    assert torch.equal(ops.ssd(*targs, chunk=chunk, impl="ref"),
                       ref.ssd_ref(*targs)[0])
    with pytest.raises(ValueError, match="CUDA kernel given a tensor on cpu"):
        ops.ssd(*targs, chunk=chunk, impl="kernel")
    with pytest.raises(ValueError, match="CUDA kernel"):
        ssd_cuda(*targs, chunk=chunk)
