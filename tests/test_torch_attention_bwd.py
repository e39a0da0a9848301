"""The attention backward's plain version against the JAX package's
gradients, on the CPU.

The reference has no attention backward of its own: ``jax.grad`` through
its Pallas kernel fails, so its training path differentiates the jnp
route.  The same numpy inputs go through ``jax.vjp`` of
``ref.attention_ref`` and of ``ref.flash_attention_jnp`` and through the
port's ``ref.flash_attention_bwd_plain`` (fed the port's forward and its
row log-sum-exp), which is what ``chip_smoke.py`` holds the CUDA backward
kernels to on the card.  The grid: G 1, 2 and 3, causal and not, window 0
and 16, S 17, 65 and 130, head dims 16 and 64, f32.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

# Each gradient within this share of its largest entry: the reference's f32
# kernel tolerance (tests/test_kernels.py:12).  Measured over the grid:
# the plain backward within 1.1e-6 of jax.vjp of either route, the LSE
# within 9.6e-7 absolute.
TOL_OF_MAX = 2e-5
LSE_TOL = dict(atol=2e-5, rtol=2e-5)

KH = 2
MASKS = list(itertools.product((True, False), (0, 16)))  # (causal, window)
GRID = list(itertools.product((1, 2, 3), (17, 65, 130), (16, 64), MASKS))


def _inputs(seed, B, S, G, Dh):
    rng = np.random.default_rng(seed)
    H = KH * G
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KH, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KH, Dh)).astype(np.float32)
    g = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    return q, k, v, g


def _jax_lse(q, k, causal, window):
    """logsumexp of the reference's masked, scaled scores (attention_ref's
    arithmetic), as (B, H, S)."""
    B, S, H, Dh = q.shape
    G = H // KH
    s = jnp.einsum("bqkgd,bjkd->bqkgj", q.reshape(B, S, KH, G, Dh) *
                   Dh ** -0.5, k)
    pos = jnp.arange(S)
    mask = jnp.ones((S, S), bool)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    s = jnp.where(mask[None, :, None, None, :], s, jref.NEG_INF)
    return jax.nn.logsumexp(s, axis=-1).reshape(B, S, H).transpose(0, 2, 1)


@functools.lru_cache(maxsize=None)
def _reference(G, S, Dh):
    """Inputs of one shape and, for every mask, the reference's LSE and
    its gradients through both routes: one jit a shape (the XLA compiles
    are most of this file's time)."""
    inputs = _inputs(S + G + Dh, 2, S, G, Dh)

    def every_mask(q, k, v, g):
        res = {}
        for causal, window in MASKS:
            grads = []
            for fn in (jref.attention_ref, jref.flash_attention_jnp):
                _, vjp = jax.vjp(functools.partial(
                    fn, causal=causal, window=window), q, k, v)
                grads.append(vjp(g))
            res[(causal, window)] = (_jax_lse(q, k, causal, window), grads)
        return res
    out = jax.jit(every_mask)(*map(jnp.asarray, inputs))
    return inputs, jax.tree.map(np.asarray, out)


def _close_of_max(got, want, what):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        assert scale > 0, (what, name)
        np.testing.assert_allclose(a, w, rtol=0, atol=TOL_OF_MAX * scale,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("G,S,Dh,mask", GRID, ids=lambda c: str(c))
def test_plain_backward_matches_jax_vjp(G, S, Dh, mask):
    causal, window = mask
    inputs, ref_out = _reference(G, S, Dh)
    want_lse, want = ref_out[mask]
    tq, tk, tv, tg = map(torch.from_numpy, inputs)
    out, lse = ref.flash_attention_blockwise(tq, tk, tv, causal=causal,
                                             window=window, return_lse=True,
                                             block_kv=32)
    assert tuple(lse.shape) == (2, KH * G, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want_lse, **LSE_TOL)
    got = [t.numpy() for t in ref.flash_attention_bwd_plain(
        tq, tk, tv, out, lse, tg, causal=causal, window=window)]
    for name, w in zip(("attention_ref", "flash_attention_jnp"), want):
        _close_of_max(got, w, name)


@pytest.mark.parametrize("G,causal,window", [(1, True, 0), (3, True, 16),
                                             (2, False, 0), (3, False, 16)])
def test_plain_backward_matches_autograd_of_the_blockwise_forward(
        G, causal, window):
    """The step-by-step backward against torch autograd through the plain
    blockwise forward (what the CPU route of ``ops.flash_attention``
    differentiates), on ragged KV blocks."""
    q, k, v, g = _inputs(7, 2, 70, G, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    out2, lse = ref.flash_attention_blockwise(
        tq.detach(), tk.detach(), tv.detach(), causal=causal, window=window,
        return_lse=True)
    assert torch.equal(out.detach(), out2)
    got = ref.flash_attention_bwd_plain(tq.detach(), tk.detach(),
                                        tv.detach(), out2, lse,
                                        torch.from_numpy(g), causal=causal,
                                        window=window)
    _close_of_max([t.numpy() for t in got], [t.numpy() for t in want],
                  "autograd")


def test_bf16_plain_backward_returns_the_input_types():
    q, k, v, g = _inputs(3, 1, 33, 2, 16)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    out, lse = ref.flash_attention_blockwise(tq, tk, tv, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = ref.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.bfloat16,) * 3
    f32 = ref.flash_attention_bwd_plain(tq.float(), tk.float(), tv.float(),
                                        out.float(), lse, tg.float())
    for a, b in zip((dq, dk, dv), f32):  # the same f32 math, then rounded
        assert torch.equal(a, b.bfloat16())


def test_cpu_training_forward_takes_the_plain_version():
    """On the CPU the training forward is the plain blockwise version under
    autograd: no kernel is launched either way, and the backward kernel's
    wrapper refuses CPU tensors."""
    q, k, v, g = _inputs(4, 1, 20, 2, 16)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tfa.reset_launches()
    out = ops.flash_attention(tq, tk, tv)
    torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert tfa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0,
                            "paged_decode_attention": 0}
    out, lse = ref.flash_attention_blockwise(tq.detach(), tk.detach(),
                                             tv.detach(), return_lse=True)
    args = (tq.detach(), tk.detach(), tv.detach(), out, lse,
            torch.from_numpy(g))
    with pytest.raises(ValueError, match="CUDA kernel given a tensor"):
        tfa.flash_attention_bwd_cuda(*args)
    with pytest.raises(ValueError, match="CUDA kernel given a tensor"):
        tfa.flash_attention_cuda(*args[:3], return_lse=True)
    with pytest.raises(ValueError, match="kernel"):
        ops.flash_attention(tq, tk, tv, impl="kernel")
    assert tfa.LAUNCHES["flash_attention_bwd"] == 0
