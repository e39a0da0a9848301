"""The port's attention functions against the JAX package's.

Same numpy inputs through both: the port's plain versions (what its ops
route CPU tensors to) against the reference's Pallas kernels in interpret
mode and its jnp oracles.  The CUDA kernels themselves run only on the
card: ``chip_smoke.py`` holds them to these plain versions there.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_pallas, gather_kv_pages as j_gather)
from repro_torch.device import from_numpy  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# The reference's kernel tolerances (tests/test_kernels.py:12-14).
TOL = {jnp.float32: dict(atol=2e-5, rtol=2e-5),
       jnp.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and as a CPU tensor (bit-exact)."""
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32), dtype)
    return j, from_numpy(np.asarray(j), "cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


# (B, Sq, Skv, H, KH, Dh, causal, window, q_offset)
FLASH_CASES = [
    (1, 32, 32, 4, 4, 16, True, 0, 0),      # G = 1
    (2, 64, 64, 8, 4, 32, True, 0, 0),      # G = 2
    (1, 48, 48, 6, 2, 16, True, 0, 0),      # G = 3
    (2, 64, 64, 6, 2, 16, True, 16, 0),     # sliding window, G = 3
    (1, 32, 64, 4, 2, 16, True, 0, 32),     # query offset
    (2, 32, 64, 4, 2, 64, False, 0, 0),     # non-causal, Sq != Skv
    (1, 144, 144, 4, 2, 16, True, 0, 0),    # S a page multiple, not 128
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    map(str, c)))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_plain_matches_reference(case, dtype):
    B, Sq, Skv, H, KH, Dh, causal, window, q_offset = case
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, Sq, H, Dh), dtype)
    jk, tk = _pair(rng, (B, Skv, KH, Dh), dtype)
    jv, tv = _pair(rng, (B, Skv, KH, Dh), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = ops.flash_attention(tq, tk, tv, **kw)  # CPU tensors -> plain
    assert out.dtype == tq.dtype and out.shape == tq.shape
    np.testing.assert_allclose(_np(out), _np(jref.attention_ref(jq, jk, jv,
                                                                **kw)),
                               **TOL[dtype])
    np.testing.assert_allclose(
        _np(out), _np(jref.flash_attention_jnp(jq, jk, jv, **kw)),
        **TOL[dtype])
    if Sq % min(128, Sq) == 0 and Skv % min(128, Skv) == 0:
        pallas = flash_attention_pallas(jq, jk, jv, interpret=True, **kw)
        np.testing.assert_allclose(_np(out), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(
        _np(ops.flash_attention(tq, tk, tv, impl="ref", **kw)),
        _np(jref.attention_ref(jq, jk, jv, **kw)), **TOL[dtype])


def _paged_inputs(rng, B, P, ps, KH, G, Dh, dtype):
    H = KH * G
    NP = 1 + B * P
    jq, tq = _pair(rng, (B, 1, H, Dh), dtype)
    jk, tk = _pair(rng, (NP, ps, KH, Dh), dtype)
    jv, tv = _pair(rng, (NP, ps, KH, Dh), dtype)
    table = rng.permutation(np.arange(1, NP)).astype(np.int32).reshape(B, P)
    return (jq, jk, jv, jnp.asarray(table)), (tq, tk, tv,
                                             torch.from_numpy(table))


@pytest.mark.parametrize("KH,G", [(2, 2), (1, 7)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_plain_matches_reference(KH, G, dtype):
    # the grid of tests/test_serving.py:237-254 plus an empty (kv_len 0) row
    B, P, ps, Dh = 4, 4, 8, 16
    rng = np.random.default_rng(0)
    j_in, t_in = _paged_inputs(rng, B, P, ps, KH, G, Dh, dtype)
    kv_len = np.array([5, 17, 32, 0], np.int32)
    o, m, l = ops.paged_decode_attention(*t_in, torch.from_numpy(kv_len))
    assert o.dtype == t_in[0].dtype and m.shape == (B, 1, KH, G)
    f32 = dtype == jnp.float32
    tol_o = dict(atol=1e-5) if f32 else TOL[dtype]
    tol_m = dict(atol=1e-6) if f32 else TOL[dtype]
    tol_l = dict(rtol=1e-5) if f32 else TOL[dtype]
    for impl in ("jnp", "pallas"):
        jo, jm, jl = jops.paged_decode_attention(*j_in, jnp.asarray(kv_len),
                                                 impl=impl)
        np.testing.assert_allclose(_np(o), _np(jo), **tol_o)
        np.testing.assert_allclose(_np(m), _np(jm), **tol_m)
        np.testing.assert_allclose(_np(l), _np(jl), **tol_l)
    # the empty slot: exactly m = -1e30, l = 1e-20, out = 0
    assert bool((m[3] == -1e30).all()) and bool((l[3] == 1e-20).all())
    assert bool((o[3] == 0).all())


# (KH, G, pages per split): splits of span = pages per split * ps positions
SPLIT_CASES = [(1, 7, 1), (1, 7, 2), (2, 7, 3), (3, 1, 1), (2, 1, 2)]


@pytest.mark.parametrize("KH,G,pps", SPLIT_CASES,
                         ids=lambda c: str(c))
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_paged_decode_split_merge_matches_direct(KH, G, pps, dtype):
    """The split decode's plain versions (per-split partials, then the
    merge) against the direct form: lengths on page and split edges, one
    past and one short of them, splits wholly past kv_len, and kv_len 0
    (out 0, m -1e30 and l 1e-20 exactly)."""
    B, P, ps, Dh = 8, 6, 8, 16
    span = pps * ps
    rng = np.random.default_rng(5)
    j_in, (tq, tk, tv, tt) = _paged_inputs(rng, B, P, ps, KH, G, Dh, dtype)
    kv_len = np.array([0, ps, span, span + 1, 2 * span - 1, 3, P * ps,
                       P * ps - 1], np.int32)
    acc, m, l = tfa.paged_decode_split_plain(tq, tk, tv, tt,
                                             torch.from_numpy(kv_len),
                                             span=span)
    n_split = -(-P * ps // span)
    assert acc.shape == (B, KH, n_split, G, Dh)
    assert m.shape == l.shape == (B, KH, n_split, G)
    first = np.arange(n_split) * span  # each split's first position
    past = torch.from_numpy(first[None, :] >= kv_len[:, None])  # (B, NS)
    assert bool((m.permute(0, 2, 1, 3)[past] == -1e30).all())
    assert bool((l.permute(0, 2, 1, 3)[past] == 0).all())
    assert bool((acc.permute(0, 2, 1, 3, 4)[past] == 0).all())

    o, mm, ll = tfa.paged_decode_merge_plain(acc, m, l, tq.dtype)
    assert o.dtype == tq.dtype and o.shape == tq.shape
    k = ref.gather_kv_pages(tk, tt)
    v = ref.gather_kv_pages(tv, tt)
    ro, rm, rl = ref.decode_attention_direct(tq, k, v,
                                             kv_len=torch.from_numpy(kv_len),
                                             return_stats=True)
    jq, jk, jv, jt = j_in
    jo, jm, jl = jref.decode_attention_jnp(
        jq, j_gather(jk, jt), j_gather(jv, jt), kv_len=jnp.asarray(kv_len),
        return_stats=True)
    for got, want, jwant in ((o, ro, jo), (mm, rm, jm), (ll, rl, jl)):
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
        np.testing.assert_allclose(_np(got), _np(jwant), **TOL[dtype])
    assert bool((o[0] == 0).all()) and bool((mm[0] == -1e30).all())
    assert bool((ll[0] == 1e-20).all())


@pytest.mark.parametrize("B,KH,P,ps", [(8, 4, 35, 16), (8, 4, 256, 16),
                                        (8, 3, 35, 16), (1, 1, 4, 8),
                                        (64, 8, 3, 16), (2, 2, 1000, 16)])
def test_decode_split_covers_the_table(B, KH, P, ps):
    """The split plan comes from shapes alone: its splits cover the
    table's P * ps positions with no split wholly past them, and it aims
    at DECODE_CTAS_PER_SM CTAs a streaming multiprocessor."""
    cps, n_split = tfa.decode_split(B, KH, P, ps, sms=132)
    span = cps * tfa.DECODE_CHUNK
    assert n_split * span >= P * ps > (n_split - 1) * span
    want = -(-tfa.DECODE_CTAS_PER_SM * 132 // (B * KH))
    assert n_split <= want


def test_decode_attention_combine_matches_reference():
    rng = np.random.default_rng(1)
    B, H, KH, Dh, S = 3, 6, 2, 16, 24
    jq, tq = _pair(rng, (B, 1, H, Dh), jnp.float32)
    jk, tk = _pair(rng, (B, S, KH, Dh), jnp.float32)
    jv, tv = _pair(rng, (B, S, KH, Dh), jnp.float32)
    jkn, tkn = _pair(rng, (B, 1, KH, Dh), jnp.float32)
    jvn, tvn = _pair(rng, (B, 1, KH, Dh), jnp.float32)
    kv_len = np.array([0, 7, 24], np.int32)
    jo = jref.decode_attention_jnp(jq, jk, jv, kv_len=jnp.asarray(kv_len),
                                   return_stats=True)
    to = ref.decode_attention_direct(tq, tk, tv,
                                     kv_len=torch.from_numpy(kv_len),
                                     return_stats=True)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=1e-5)
    jc = jref.decode_attention_combine(jq, *jo, jkn, jvn)
    tc = ops.decode_attention_combine(tq, *to, tkn, tvn)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6, rtol=1e-5)


def test_gather_kv_pages_exact():
    rng = np.random.default_rng(2)
    (_, jk, _, jt), (_, tk, _, tt) = _paged_inputs(rng, 3, 4, 8, 2, 2, 16,
                                                   jnp.bfloat16)
    g = ref.gather_kv_pages(tk, tt)
    jg = j_gather(jk, jt)
    assert tuple(g.shape) == jg.shape == (3, 32, 2, 16)
    assert np.array_equal(g.view(torch.int16).numpy(),
                          np.asarray(jg).view(np.int16))


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(3)
    _, (tq, tk, tv, tt) = _paged_inputs(rng, 2, 2, 8, 2, 2, 16, jnp.float32)
    _, tqf = _pair(rng, (1, 16, 4, 16), jnp.float32)
    _, tkf = _pair(rng, (1, 16, 2, 16), jnp.float32)
    kv_len = torch.tensor([3, 9], dtype=torch.int32)
    tfa.reset_launches()
    ops.flash_attention(tqf, tkf, tkf)
    ops.paged_decode_attention(tq, tk, tv, tt, kv_len)
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_decode_attention": 0}


def test_kernel_impl_on_cpu_raises():
    rng = np.random.default_rng(4)
    _, (tq, tk, tv, tt) = _paged_inputs(rng, 2, 2, 8, 2, 2, 16, jnp.float32)
    _, tqf = _pair(rng, (1, 16, 4, 16), jnp.float32)
    _, tkf = _pair(rng, (1, 16, 2, 16), jnp.float32)
    kv_len = torch.tensor([3, 9], dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.flash_attention(tqf, tkf, tkf, impl="kernel")
    with pytest.raises(ValueError):
        ops.paged_decode_attention(tq, tk, tv, tt, kv_len, impl="kernel")
    with pytest.raises(ValueError):
        tfa.flash_attention_cuda(tqf, tkf, tkf)
    with pytest.raises(ValueError):
        tfa.paged_decode_attention_cuda(tq, tk, tv, tt, kv_len)
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_decode_attention": 0}
