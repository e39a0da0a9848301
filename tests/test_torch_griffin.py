"""The port's hybrid family (``models/griffin.py``, ``ops.rglru``) against
the JAX package's, on the CPU.

The RG-LRU: ``ops.rglru`` (the port's log-depth scan) and its sequential
oracle against the reference's ``rglru_scan_jnp`` and ``rglru_ref``, with
and without h0, its gradient against ``jax.vjp``, and ``rglru_gates`` in
f32 and bf16.  The model: the smoke recurrentgemma-9b (f32, 4 heads of 16
over one KV head, window 16, lru_width 64) at 3 layers (one rglru, rglru,
attn group) and 5 (two trailing rglru blocks), S 40 > the window, from
the reference's parameters carried over by ``convert.params_from_jax``:
logits, loss and every leaf's gradient against its ``forward``,
``loss_fn`` and ``jax.grad``.  On the CPU the attention is the plain
blockwise version under autograd; ``chip_smoke.py`` holds the card's
kernels to it (phases 2, 14, 27 and 28).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.device import from_numpy  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import griffin  # noqa: E402
from repro_torch.models.common import stack_list  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "recurrentgemma_9b"
# f32 on the CPU; the scans combine in other trees (Hillis-Steele here,
# XLA's odd-even associative scan there), and XLA and ATen order the
# matmul sums differently.  Measured: the scan within 4.8e-7 of either
# reference route, its gradient within 1.0e-7 of each input's largest
# entry, the f32 gates within 3.9e-6; logits within 4.8e-7, losses within
# 8.6e-8 relative, gradients within 7.6e-7 of each leaf's largest entry.
SCAN_TOL = dict(atol=2e-5, rtol=2e-5)
LOGIT_TOL = dict(atol=5e-6, rtol=1e-5)
LOSS_RTOL = 1e-6
GRAD_TOL_OF_MAX = 2e-5
# bf16 gates: the reference's promotions give the same types; XLA and
# ATen round a bf16 matmul's sums at other places, so a gate may differ
# by a bf16 rounding.  Measured: within 0.92% relative
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs(seed, b=2, s=37, w=24):
    rng = np.random.default_rng(seed)
    log_a = -rng.uniform(0.0, 2.0, (b, s, w)).astype(np.float32)
    gx = rng.normal(size=(b, s, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return log_a, gx, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_matches_both_reference_routes(with_h0):
    log_a, gx, h0 = _scan_inputs(0)
    kw = dict(h0=h0) if with_h0 else {}
    tkw = dict(h0=torch.from_numpy(h0)) if with_h0 else {}
    jkw = dict(h0=jnp.asarray(h0)) if with_h0 else {}
    ta, tg = torch.from_numpy(log_a), torch.from_numpy(gx)
    hs, h_last = ops.rglru(ta, tg, **tkw)
    ohs, oh_last = ops.rglru(ta, tg, impl="ref", **tkw)
    assert hs.dtype == torch.float32 and h_last.shape == (2, 24)
    assert kw.keys() == tkw.keys()
    for fn in (jref.rglru_scan_jnp, jref.rglru_ref):
        jhs, jh = jax.jit(functools.partial(fn, **jkw))(
            jnp.asarray(log_a), jnp.asarray(gx))
        for got in ((hs, h_last), (ohs, oh_last)):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(jhs),
                                       **SCAN_TOL)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(jh),
                                       **SCAN_TOL)


def test_rglru_gradient_matches_jax_vjp():
    log_a, gx, h0 = _scan_inputs(1)
    rng = np.random.default_rng(2)
    dhs = rng.normal(size=gx.shape).astype(np.float32)
    dh = rng.normal(size=h0.shape).astype(np.float32)
    def vjp(a, g, h, cot):
        fn = lambda a, g, h: jref.rglru_scan_jnp(a, g, h0=h)  # noqa: E731
        return jax.vjp(fn, a, g, h)[1](cot)
    want = jax.jit(vjp)(*map(jnp.asarray, (log_a, gx, h0)),
                        (jnp.asarray(dhs), jnp.asarray(dh)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (log_a, gx, h0)]
    hs, h_last = ops.rglru(ins[0], ins[1], h0=ins[2])
    got = torch.autograd.grad((hs, h_last), ins, (torch.from_numpy(dhs),
                                                  torch.from_numpy(dh)))
    for name, a, w in zip(("log_a", "gated_x", "h0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=GRAD_TOL_OF_MAX * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_rglru_gates_match_reference(dtype):
    rng = np.random.default_rng(3)
    w = 32
    x = jnp.asarray(rng.normal(size=(2, 9, w)), dtype)
    wa, wx = (jnp.asarray(0.2 * rng.normal(size=(w, w)), dtype)
              for _ in range(2))
    # log_lambda over softplus's range: jax's is logaddexp(x, 0) at every
    # x, where torch's own softplus turns linear above 20
    log_lambda = jnp.asarray(np.linspace(-30.0, 30.0, w), jnp.float32)
    want = jref.rglru_gates(x, wa, wx, log_lambda)
    got = ref.rglru_gates(*(from_numpy(np.asarray(t), "cpu")
                            for t in (x, wa, wx, log_lambda)))
    tol = BF16_TOL if dtype == jnp.bfloat16 else SCAN_TOL
    for g, wv in zip(got, want):
        assert g.dtype == torch.float32 and wv.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), **tol)


@functools.lru_cache(maxsize=None)
def _jax_params(layers, seed):
    jcfg = j_smoke(j_get_config(ARCH).model).replace(num_layers=layers)
    return jcfg, jax.jit(jgriffin.init, static_argnums=0)(
        jcfg, jax.random.PRNGKey(seed))


def _setup(layers, seed, B=2, S=40):
    jcfg, jparams = _jax_params(layers, seed)
    cfg = smoke_model(get_config(ARCH).model).replace(num_layers=layers)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def test_smoke_config_and_init_match_reference():
    jcfg, cfg, jparams, params, _ = _setup(5, 0)
    assert cfg.window == 16 and cfg.lru_width == 64
    assert cfg.num_kv_heads == 1 and cfg.block_pattern == jcfg.block_pattern
    assert griffin._layout(cfg) == jgriffin._layout(jcfg)
    ours = flatten(griffin.init(cfg, seed=0, device="cpu"))
    theirs = {"/".join(str(k.key) for k in path): (tuple(v.shape),
                                                     str(v.dtype))
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jparams)[0]}
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in
            ours.items()} == theirs
    assert bool((ours["rec_layers/log_lambda"] == 4.0).all())
    assert get_model(cfg) is griffin
    # params_from_jax carries the nested stacks over bit for bit
    carried = flatten(params)
    for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        k = "/".join(str(p.key) for p in path)
        assert np.array_equal(carried[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("layers", [3, 5])
def test_forward_and_loss_match_reference(layers, monkeypatch):
    jcfg, cfg, jparams, params, tokens = _setup(layers, 0)
    batch = {"tokens": torch.from_numpy(tokens)}
    logits = griffin.forward(cfg, params, batch)
    jlogits = jax.jit(lambda p, t: jgriffin.forward(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    assert logits.shape == (2, 40, cfg.vocab_padded)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    loss = float(griffin.loss_fn(cfg, params, batch))
    jloss = float(jax.jit(lambda p, t: jgriffin.loss_fn(
        jcfg, p, {"tokens": t}))(jparams, jnp.asarray(tokens)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)
    monkeypatch.setattr(griffin, "LOSS_CHUNK", 16)  # 39 positions in 3
    chunked = float(griffin.loss_fn(cfg, params, batch))
    assert abs(chunked - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("layers", [3, 5])
def test_gradients_match_reference(layers, monkeypatch):
    # the loss in chunks of 16 positions (39 here: 16, 16, 7), each
    # recomputed in the backward, as at full width in chunks of 1024
    monkeypatch.setattr(griffin, "LOSS_CHUNK", 16)
    jcfg, cfg, jparams, params, tokens = _setup(layers, 0)
    jg = jax.jit(jax.grad(lambda p, t: jgriffin.loss_fn(
        jcfg, p, {"tokens": t})))(jparams, jnp.asarray(tokens))
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    # remat on: the per-block checkpoints recompute the same forward
    loss = griffin.loss_fn(cfg.replace(remat=True), params,
                           {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(grads) == set(jflat)
    for k, w in jflat.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL_OF_MAX * scale, err_msg=k)


def test_stacks_as_lists_give_the_stacked_result():
    """The round step hands ``loss_fn`` each stack as a list of per-layer
    dicts (views of the stacked leaves): the same loss, bit for bit."""
    _, cfg, _, params, tokens = _setup(5, 2)
    batch = {"tokens": torch.from_numpy(tokens)}
    as_lists = dict(params, rec_layers=stack_list(params["rec_layers"]),
                    attn_layers=stack_list(params["attn_layers"]))
    assert len(as_lists["rec_layers"]) == 4
    assert torch.equal(griffin.loss_fn(cfg, params, batch),
                       griffin.loss_fn(cfg, as_lists, batch))


def test_serving_entry_points_raise_naming_the_roadmap():
    """The serving entry points are ported (item 4 done; held to the
    reference in test_torch_serve_recurrent.py): a ring of min(window,
    max_len) slots, and a prefill and a decode step that advance ``pos``;
    the RG-LRU still has no kernel."""
    cfg = smoke_model(get_config(ARCH).model)
    params = griffin.init(cfg, seed=0, device="cpu")
    assert griffin.init_cache(cfg, 1, 8, device="cpu")["k"].shape[2] == 8
    cache = griffin.init_cache(cfg, 1, 64, device="cpu")
    assert cache["k"].shape[2] == cfg.window
    logits, cache = griffin.prefill(
        cfg, params, {"tokens": torch.zeros((1, 5), dtype=torch.int64)},
        cache)
    logits, cache = griffin.decode_step(
        cfg, params, cache, torch.zeros((1, 1), dtype=torch.int64))
    assert cache["pos"] == 6 and logits.shape == (1, 1, cfg.vocab_padded)
    with pytest.raises(ValueError, match="no kernel"):
        ops.rglru(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3), impl="kernel")


def test_launcher_trains_the_smoke_griffin_on_the_cpu(capsys):
    out = train.main(["--device", "cpu", "--arch", ARCH, "--rounds", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("round")]
    assert len(lines) == 1 and len(out["history"]) == 1
    assert out["cfg"].family == "hybrid" and out["cfg"].num_layers == 3
    assert out["n_params"] == 158_912
    rec = out["history"][0]
    assert np.isfinite(rec["loss"]) and 0 < rec["loss"] < 10
    assert rec["time"] > 0 and out["peak_mem_gb"] is None


def test_serve_launcher_refuses_the_hybrid_family(capsys):
    """--continuous refuses it (no paged KV cache); the static path
    serves it (test_torch_serve_recurrent.py)."""
    with pytest.raises(SystemExit):
        serve.main(["--continuous", "--device", "cpu", "--arch", ARCH])
    assert "--continuous cannot serve" in capsys.readouterr().err
