"""The port's top-k compression Q against the JAX package's.

Same numpy inputs through both: the port's plain bisection (what its ops
route CPU tensors to, and what the CUDA kernel is held to on the card)
against the reference's jnp oracle and its Pallas kernel in interpret
mode, bit for bit; the exact-sort oracles; ``compress_delta`` on leaves
that are not block multiples; the grouped top-k (``ops.topk_compress_leaves``,
one kernel launch a type pair of a table of leaves on the card; on the
CPU the per-leaf plain version, padded as the reference pads) against the
reference's ``compress_delta`` on ResNet-20's real leaf shapes, most of
them ragged against the block; and the theta level grid.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.configs.vision import RESNET20_CIFAR10  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.device import from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import topk_compress as tk  # noqa: E402
from repro_torch.models.vision import make_vision_model  # noqa: E402

GRID = [(1, 2048, 256), (4, 4096, 512), (3, 1024, 1024)]  # test_kernels:144
DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


RESNET20_SHAPES = {
    k: tuple(v.shape) for k, v in make_vision_model(RESNET20_CIFAR10.vision)
    [0](torch.Generator().manual_seed(0)).items()}
F32_TOL = dict(atol=2e-5, rtol=2e-5)  # tests/test_kernels.py:12


def test_resnet20_leaves_are_mostly_ragged():
    ragged = [k for k, s in RESNET20_SHAPES.items()
              if int(np.prod(s)) % 256]
    assert len(RESNET20_SHAPES) == 59 and len(ragged) > 30


@pytest.mark.parametrize("error_feedback", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_leaves_match_reference_compress_delta(dtype, error_feedback):
    """ResNet-20's 59 leaves (and an all-zero ragged one) at R = 4, block
    256: the masked delta and the residual bit for bit the reference's
    ``compress_delta``, and in f32 the residual within 2e-5 of delta + ef
    - masked (exact, as Eq. 7 asks)."""
    R, block = 4, 256
    rng = np.random.default_rng(3 if error_feedback else 4)
    shapes = dict(RESNET20_SHAPES, zero=(7,))
    delta = {k: rng.normal(size=(R,) + s).astype(np.float32)
             for k, s in shapes.items()}
    ef = {k: 0.2 * rng.normal(size=(R,) + s).astype(np.float32)
          for k, s in shapes.items()}
    delta["zero"][:] = 0.0
    ef["zero"][:] = 0.0
    theta = rng.uniform(0.05, 1.0, R).astype(np.float32)
    jd = {k: jnp.asarray(v, DTYPES[dtype]) for k, v in delta.items()}
    je = {k: jnp.asarray(v, DTYPES[dtype]) for k, v in ef.items()}
    jc, jne = jcomp.compress_delta(jd, je, jnp.asarray(theta), block=block,
                                   error_feedback=error_feedback)
    xs = [from_numpy(np.asarray(jd[k]), "cpu").reshape(R, -1) for k in jd]
    efs = [from_numpy(np.asarray(je[k]), "cpu").reshape(R, -1) for k in jd]
    got = ops.topk_compress_leaves(xs, torch.from_numpy(theta), block=block,
                                   efs=efs if error_feedback else None)
    for k, x, e, (masked, resid) in zip(jd, xs, efs, got):
        assert masked.dtype == x.dtype and resid.dtype == x.dtype
        np.testing.assert_array_equal(_bits(masked),
                                      _bits(jc[k]).reshape(R, -1), k)
        np.testing.assert_array_equal(_bits(resid),
                                      _bits(jne[k]).reshape(R, -1), k)
        if dtype == "f32":
            total = x + e if error_feedback else x
            np.testing.assert_allclose(resid.numpy(),
                                       (total - masked).numpy(), **F32_TOL)


def test_leaves_mixed_table_in_place_matches_per_leaf_plain():
    """A table of f32 and bf16 leaves with f32 and own-type efs, written
    in place (masked over the leaf, residual over its ef), is the
    per-leaf plain version's result, bit for bit."""
    R = 3
    rng = np.random.default_rng(9)
    spec = [(1, torch.float32, torch.float32),
            (31, torch.bfloat16, torch.float32),
            (257, torch.bfloat16, torch.bfloat16),
            (512, torch.float32, torch.float32),
            (1000, torch.bfloat16, torch.float32)]
    mk = lambda L, dt, sc: torch.from_numpy(
        sc * rng.normal(size=(R, L)).astype(np.float32)).to(dt)
    xs = [mk(L, xd, 1.0) for L, xd, _ in spec]
    efs = [mk(L, ed, 0.3) for L, _, ed in spec]
    theta = torch.from_numpy(rng.uniform(0.05, 1.0, R).astype(np.float32))
    want = tk.topk_compress_leaves_plain(xs, theta, block=256, efs=efs)
    got = ops.topk_compress_leaves(xs, theta, block=256, efs=efs,
                                   outs=list(zip(xs, efs)))
    for (m, r), (wm, wr), x, e in zip(got, want, xs, efs):
        assert m is x and r is e
        _check_bitwise((m, r), (wm, wr))


def test_leaves_kernel_wrapper_refuses_cpu_tensors():
    tk.reset_launches()
    with pytest.raises(ValueError, match="CUDA kernel"):
        ops.topk_compress_leaves([torch.zeros(2, 300)], torch.ones(2),
                                 block=256, impl="kernel")
    assert tk.LAUNCHES["topk_compress"] == 0
    assert ops.topk_compress_leaves([], torch.ones(2)) == []


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
