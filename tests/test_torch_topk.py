"""The port's top-k compression Q against the JAX package's.

Same numpy inputs through both: the port's plain bisection (what its ops
route CPU tensors to, and what the CUDA kernel is held to on the card)
against the reference's jnp oracle and its Pallas kernel in interpret
mode, bit for bit; the exact-sort oracles; ``compress_delta`` on leaves
that are not block multiples; and the theta level grid.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.device import from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import topk_compress as tk  # noqa: E402

GRID = [(1, 2048, 256), (4, 4096, 512), (3, 1024, 1024)]  # test_kernels:144
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _bits(a):
    """Raw bits of a JAX array or tensor (int32 for f32, int16 for bf16),
    so that +0 and -0 and every rounding differ."""
    if isinstance(a, torch.Tensor):
        itype = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return a.contiguous().view(itype).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _inputs(x_np, theta_np, dtype, ef_kind, rng):
    """(jax kwargs, torch kwargs) of the same values; ef in {none, same,
    f32}."""
    jx = jnp.asarray(x_np, dtype)
    jth = jnp.asarray(theta_np, jnp.float32)
    jef = None
    if ef_kind != "none":
        ef_dtype = dtype if ef_kind == "same" else jnp.float32
        jef = jnp.asarray(0.3 * rng.normal(size=x_np.shape), ef_dtype)
    tx = from_numpy(np.asarray(jx), "cpu")
    tth = from_numpy(np.asarray(jth), "cpu")
    tef = None if jef is None else from_numpy(np.asarray(jef), "cpu")
    return (jx, jth, jef), (tx, tth, tef)


def _check_bitwise(got, want):
    for g, w in zip(got, want):
        assert _bits(g).shape == _bits(w).shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("ef_kind", ["none", "same", "f32"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R,L,block", GRID)
def test_plain_matches_jnp_oracle_and_pallas(R, L, block, dtype, ef_kind):
    rng = np.random.default_rng(R * L + block)
    x = rng.normal(size=(R, L)).astype(np.float32)
    theta = rng.uniform(0.05, 1.0, R).astype(np.float32)
    (jx, jth, jef), (tx, tth, tef) = _inputs(x, theta, DTYPES[dtype],
                                             ef_kind, rng)
    got = ops.topk_compress(tx, tth, block=block, ef=tef)
    assert got[0].dtype == tx.dtype
    assert got[1].dtype == (tx.dtype if tef is None else tef.dtype)
    _check_bitwise(got, jops.topk_compress(jx, jth, block=block, ef=jef,
                                           impl="jnp"))
    _check_bitwise(got, jops.topk_compress(jx, jth, block=block, ef=jef,
                                           impl="pallas"))


def _edge_rows(block):
    """Row 0: an all-zero block, then a block of tied magnitudes.  Row 1:
    few distinct magnitudes (ties at every threshold), then random."""
    rng = np.random.default_rng(7)
    x = np.zeros((2, 2 * block), np.float32)
    x[0, block:] = 1.5 * rng.choice([-1.0, 1.0], block)
    x[1, :block] = rng.choice([-2.0, -0.5, 0.5, 1.0, 2.0], block)
    x[1, block:] = rng.normal(size=block)
    return x


@pytest.mark.parametrize("theta", [1.0, 1e-4, 0.3],
                         ids=["theta1", "k1", "ties"])
@pytest.mark.parametrize("ef_kind", ["none", "f32"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_edge_cases_match(theta, ef_kind, dtype):
    block = 256
    x = _edge_rows(block)
    th = np.full(2, theta, np.float32)
    rng = np.random.default_rng(1)
    (jx, jth, jef), (tx, tth, tef) = _inputs(x, th, DTYPES[dtype], "none",
                                             rng)
    if ef_kind == "f32":  # an ef that keeps the zero block zero
        e = np.zeros_like(x)
        e[1] = 0.25 * rng.normal(size=x.shape[1])
        jef, tef = jnp.asarray(e), torch.from_numpy(e)
    got = ops.topk_compress(tx, tth, block=block, ef=tef)
    _check_bitwise(got, jops.topk_compress(jx, jth, block=block, ef=jef,
                                           impl="jnp"))
    _check_bitwise(got, jops.topk_compress(jx, jth, block=block, ef=jef,
                                           impl="pallas"))
    masked = got[0].float().reshape(2, 2, block)
    # the all-zero block keeps its maximum (a zero): nothing nonzero
    assert not masked[0, 0].any()
    if theta == 1e-4 and ef_kind == "none":
        # k = 1: the lower bisection bound keeps count(|x| > lo) > k, so the
        # random block keeps its largest magnitude and a few more
        row = masked[1, 1]
        assert row[tx[1, block:].float().abs().argmax()] != 0
        assert 2 <= int((row != 0).sum()) <= 4
    if theta == 1.0:
        # theta = 1 keeps everything: x + ef in x's type, zero residual
        total = tx.float() + (0 if tef is None else tef.float())
        assert torch.equal(got[0], total.to(tx.dtype))
        assert not got[1].any()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_exact_sort_oracle_matches(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 2048)).astype(np.float32)
    th = np.array([0.05, 0.5, 1.0], np.float32)
    (jx, jth, jef), (tx, tth, tef) = _inputs(x, th, DTYPES[dtype], "f32",
                                             rng)
    _check_bitwise(ops.topk_compress(tx, tth, block=512, ef=tef,
                                     impl="ref"),
                   jops.topk_compress(jx, jth, block=512, ef=jef,
                                      impl="ref"))


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(2, 256)
    th = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.topk_compress(x, th, block=256, impl="kernel")
    with pytest.raises(ValueError, match="CUDA kernel"):
        tk.topk_compress_cuda(x, th, block=256)
    with pytest.raises(ValueError):
        ops.topk_compress(x, th, block=256, impl="pallas")


SHAPES = {"a": (3, 50), "b": (300,), "c": (7,), "d": (16, 16)}


@pytest.mark.parametrize("error_feedback", [True, False])
def test_compress_delta_matches_reference(error_feedback):
    R = 4
    rng = np.random.default_rng(11)
    delta = {k: rng.normal(size=(R,) + s).astype(np.float32)
             for k, s in SHAPES.items()}
    ef = {k: 0.2 * rng.normal(size=(R,) + s).astype(np.float32)
          for k, s in SHAPES.items()}
    theta = rng.uniform(0.05, 1.0, R).astype(np.float32)
    jc, je = jcomp.compress_delta(
        {k: jnp.asarray(v) for k, v in delta.items()},
        {k: jnp.asarray(v) for k, v in ef.items()}, jnp.asarray(theta),
        block=256, error_feedback=error_feedback)
    td = {k: torch.from_numpy(v) for k, v in delta.items()}
    te = {k: torch.from_numpy(v) for k, v in ef.items()}
    total = {k: td[k] + te[k] if error_feedback else td[k].clone()
             for k in SHAPES}
    tc, tne = tcomp.compress_delta(td, te, torch.from_numpy(theta),
                                   block=256, error_feedback=error_feedback)
    for k in SHAPES:
        # written in place: the compressed delta over delta, the residual
        # over ef
        assert tc[k] is td[k] and tne[k] is te[k]
        np.testing.assert_array_equal(_bits(tc[k]), _bits(jc[k]))
        np.testing.assert_array_equal(_bits(tne[k]), _bits(je[k]))
        # Eq. 7's conservation, exact in f32
        assert torch.equal(tc[k] + tne[k], total[k])


def test_quantize_theta_and_cluster_levels_match_reference():
    levels = (0.05, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0)
    theta = np.array([0.05, 0.07, 0.1, 0.33, 0.61, 0.99, 1.0, 0.2 + 1e-12])
    q = tcomp.quantize_theta(theta, levels)
    assert q.dtype == np.float32
    np.testing.assert_array_equal(q, jcomp.quantize_theta(theta, levels))
    cluster_of = np.repeat(np.arange(4), 2)
    assert (tcomp.cluster_levels_from_theta(theta, levels, cluster_of)
            == jcomp.cluster_levels_from_theta(theta, levels, cluster_of))
    for mod in (tcomp, jcomp):
        with pytest.raises(ValueError, match="above the largest level"):
            mod.quantize_theta(np.array([0.5, 0.9]), (0.1, 0.8))
