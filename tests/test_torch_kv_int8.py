"""The paged pool's int8 and contiguous modes against the JAX package's,
on the CPU.

``ref.kv_quantize_int8`` bit for bit (``torch.round`` and
``jnp.round`` both round half to even), its inverse, and the int8 pool's
layout; the smoke smollm-135m's and granite-moe-1b-a400m's
``prefill_paged`` and 5 ``decode_step_paged`` through a permuted page
table with ragged lengths into an int8 pool, against the reference's:
logits and scales within ``test_torch_lm.py``'s TOL, the int8 values
equal; the ``contiguous`` gather bit for bit the gather (a view of the
pool) and the contiguous decode bit for bit the gathered one over an
identity table; ``prefill_paged`` of the ViT stub with its patch
embeddings, as the reference's function takes them; the paths the paged
pool refuses; the serve launcher's ``--continuous --kv-dtype int8``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import \
    gather_kv_pages as j_gather  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import kv_dequantize_int8 as j_deq  # noqa: E402
from repro.models.common import kv_quantize_int8 as j_quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ref import (kv_dequantize_int8,  # noqa: E402
                                     kv_quantize_int8)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, PagedConfig  # noqa: E402
from test_torch_generate import TOL, models  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kv_rows(seed):
    """(64, 4, 16) f32 head_dim blocks: normal rows, an all-zero row, and
    rows whose entries land on x / max * 127 = k + 0.5 exactly."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 4, 16)).astype(np.float32)
    x[3, 1] = 0.0
    halves = (np.arange(16) - 8 + 0.5).astype(np.float32)
    x[5, 2] = halves / 127.0 * 2.0
    x[5, 2, 0] = 2.0  # the block's max: the others quantize to k + 0.5
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_reference_bit_for_bit(dtype):
    x = torch.from_numpy(_kv_rows(0)).to(dtype)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    q, scale = kv_quantize_int8(x)
    jq, jscale = j_quant(jx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert (q[3, 1] == 0).all()
    for out_dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
        got = kv_dequantize_int8(q, scale, out_dtype)
        want = np.asarray(j_deq(jq, jscale, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_int8_pool_layout_matches_reference():
    jcfg, _, _, cfg, _, _ = models("smollm_135m")
    pool = lm.init_paged_cache(cfg, 9, 8, kv_dtype="int8", device="cpu")
    jpool = jlm.init_paged_cache(jcfg, 9, 8, kv_dtype="int8")
    assert set(pool) == set(jpool)
    for k, v in pool.items():
        assert tuple(v.shape) == jpool[k].shape
        assert str(v.dtype)[6:] == str(jpool[k].dtype)
    dense = lm.init_paged_cache(cfg, 9, 8, device="cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size()  # noqa: E731
                           for t in c.values())
    assert nbytes(dense) / nbytes(pool) >= 3.0  # f32 over int8 + scales
    with pytest.raises(ValueError, match="kv_dtype"):
        lm.init_paged_cache(cfg, 9, 8, kv_dtype="fp8", device="cpu")


def _paged_run(arch, kv_dtype, *, contiguous=False, identity=False,
               reference=True, steps=5):
    """prefill_paged and ``steps`` decode_step_paged of the smoke
    ``arch`` on the port (and the reference), the reference's greedy
    tokens fed to both.  Returns (port logits, port pool, reference
    logits, reference pool)."""
    jcfg, _, jparams, cfg, _, params = models(arch)
    rng = np.random.default_rng(0)
    B, S, ps, P = 3, 32, 8, 6
    NP = 1 + B * P
    if identity:
        table = np.arange(1, NP, dtype=np.int32).reshape(B, P)
    else:
        table = rng.permutation(np.arange(1, NP)).astype(np.int32)
        table = table.reshape(B, P)
    plen = np.array([5, 17, 32], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pool = lm.init_paged_cache(cfg, NP, ps, kv_dtype=kv_dtype, device="cpu")
    logits, pool = lm.prefill_paged(
        cfg, params, {"tokens": torch.from_numpy(toks).long()}, pool,
        torch.from_numpy(table), torch.from_numpy(plen))
    ours = [logits]
    theirs = []
    if reference:
        jpool = jlm.init_paged_cache(jcfg, NP, ps, kv_dtype=kv_dtype)
        jlogits, jpool = jax.jit(
            lambda p, b, c, t, n: jlm.prefill_paged(jcfg, p, b, c, t, n))(
            jparams, {"tokens": toks}, jpool, table, plen)
        j_decode = jax.jit(lambda p, c, tk, t, n: jlm.decode_step_paged(
            jcfg, p, c, tk, t, n, contiguous=contiguous))
        theirs.append(jlogits)
    kv_len = plen.copy()
    for _ in range(steps):
        src = theirs[-1] if reference else ours[-1].numpy()
        tok = np.asarray(np.argmax(np.asarray(src)[:, -1], -1), np.int32)
        logits, pool = lm.decode_step_paged(
            cfg, params, pool, torch.from_numpy(tok[:, None]).long(),
            torch.from_numpy(table), torch.from_numpy(kv_len),
            contiguous=contiguous)
        ours.append(logits)
        if reference:
            jlogits, jpool = j_decode(jparams, jpool, tok[:, None], table,
                                      kv_len)
            theirs.append(jlogits)
        kv_len = kv_len + 1
    return ours, pool, theirs, (jpool if reference else None)


@pytest.mark.parametrize("arch", ["smollm_135m", "granite_moe_1b_a400m"])
def test_int8_paged_prefill_and_decode_match_reference(arch):
    ours, pool, theirs, jpool = _paged_run(arch, "int8")
    for step, (a, b) in enumerate(zip(ours, theirs)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"call {step}")
    for name in ("k", "v"):
        assert pool[name].dtype == torch.int8
        np.testing.assert_array_equal(pool[name].numpy(),
                                      np.asarray(jpool[name]))
        np.testing.assert_allclose(pool[name + "_scale"].numpy(),
                                   np.asarray(jpool[name + "_scale"]), **TOL)


def test_contiguous_gather_is_the_gather_bit_for_bit():
    rng = np.random.default_rng(1)
    B, P, ps, KH, Dh = 3, 4, 8, 2, 16
    pages = rng.normal(size=(1 + B * P, ps, KH, Dh)).astype(np.float32)
    table = np.arange(1, 1 + B * P, dtype=np.int32).reshape(B, P)
    tp, tt = torch.from_numpy(pages), torch.from_numpy(table)
    got = ref.gather_kv_pages(tp, tt, contiguous=True)
    assert torch.equal(got, ref.gather_kv_pages(tp, tt))
    assert got.data_ptr() == tp[1].data_ptr()  # a view: no data moves
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_gather(pages, table, contiguous=True)))
    q = torch.from_numpy(rng.normal(size=(B, 1, 2 * KH, Dh)).astype(
        np.float32))
    kv_len = torch.tensor([5, 17, 32], dtype=torch.int32)
    for a, b in zip(ops.paged_decode_attention(q, tp, tp, tt, kv_len,
                                               contiguous=True),
                    ops.paged_decode_attention(q, tp, tp, tt, kv_len)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_decode_attention(q, tp, tp, tt, kv_len, contiguous=True,
                                   impl="kernel")


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["dense", "int8"])
def test_contiguous_decode_is_the_gathered_decode_bit_for_bit(kv_dtype):
    """Over an identity table, the contiguous decode gives the gathered
    decode's logits and pool, bit for bit, in both pool types."""
    gathered, gpool, _, _ = _paged_run("smollm_135m", kv_dtype,
                                       identity=True, reference=False)
    dense_fb, cpool, _, _ = _paged_run("smollm_135m", kv_dtype,
                                       identity=True, contiguous=True,
                                       reference=False)
    for step, (a, b) in enumerate(zip(gathered, dense_fb)):
        assert torch.equal(a, b), f"call {step}"
    for name in gpool:
        assert torch.equal(gpool[name], cpool[name]), name


def test_prefill_paged_takes_the_patch_embeddings():
    jcfg, _, jparams, cfg, _, params = models("internvl2_2b")
    rng = np.random.default_rng(2)
    B, S, ps = 2, 16, 8
    table = np.array([[1, 2], [3, 4]], np.int32)
    plen = np.array([11, 16], np.int32)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "patch_embeds": rng.normal(
                 0, 1, (B, cfg.frontend_tokens, cfg.d_model)).astype(
                 np.float32)}
    jlogits, jpool = jlm.prefill_paged(jcfg, jparams, batch,
                                       jlm.init_paged_cache(jcfg, 5, ps),
                                       table, plen)
    logits, pool = lm.prefill_paged(
        cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()},
        lm.init_paged_cache(cfg, 5, ps, device="cpu"),
        torch.from_numpy(table), torch.from_numpy(plen))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(pool[name].numpy(),
                                   np.asarray(jpool[name]), **TOL)


def test_paged_path_refuses_what_it_does_not_compute():
    """The paged functions refuse an encoder (the reference's have no
    cross-attention); ``Engine.serve`` refuses a frontend (the
    reference's serve feeds tokens alone)."""
    _, _, _, cfg, _, params = models("seamless_m4t_large_v2")
    pool = lm.init_paged_cache(cfg, 3, 4, device="cpu")
    table = torch.ones((1, 2), dtype=torch.int32)
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="no cross-attention"):
        lm.prefill_paged(cfg, params, {"tokens": tokens}, pool, table,
                         torch.tensor([4], dtype=torch.int32))
    with pytest.raises(ValueError, match="no cross-attention"):
        lm.decode_step_paged(cfg, params, pool, tokens[:, :1], table,
                             torch.tensor([4], dtype=torch.int32))
    _, _, _, cfg, _, params = models("internvl2_2b")
    eng = Engine(cfg, params, device="cpu",
                 paged=PagedConfig(page_size=8, max_slots=2))
    with pytest.raises(ValueError, match="tokens alone"):
        eng.serve(serve.poisson_requests(1, 1e3, 8, 2, cfg.vocab_size))


def test_serve_refuses_the_contiguous_layout():
    """``PagedConfig.contiguous`` would read slot b's pages as [1 + b P,
    1 + (b + 1) P) while the page manager hands out pages in free-list
    order, so ``Engine.serve`` refuses it rather than attend the wrong
    K/V; the dense-type serve of the same engine config runs."""
    _, _, _, cfg, _, params = models("smollm_135m")
    reqs = serve.poisson_requests(3, 1e3, 8, 2, cfg.vocab_size)
    eng = Engine(cfg, params, device="cpu",
                 paged=PagedConfig(page_size=8, max_slots=2,
                                   contiguous=True))
    with pytest.raises(ValueError, match="free-list order"):
        eng.serve(reqs)
    eng.paged = PagedConfig(page_size=8, max_slots=2)
    assert sorted(eng.serve(reqs)) == [0, 1, 2]


def test_launcher_serves_an_int8_pool(capsys):
    serve.main(["--continuous", "--device", "cpu", "--arch", "qwen2_7b",
                "--kv-dtype", "int8", "--requests", "3", "--rate", "1000"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "kv_dtype=int8" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--kv-dtype", "int8"])
    assert "--continuous only" in capsys.readouterr().err
