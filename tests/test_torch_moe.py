"""The port's MoE FFN (``models/lm.py:_moe_ffn``) against the JAX package's,
on the CPU.

The reference's layer-0 weights of the smoke granite-moe-1b-a400m (4
experts, top 2) and arctic-480b (4 experts, top 2, the dense residual),
f32, and the same inputs go through both ``_moe_ffn``s, forward and
``jax.vjp`` / torch autograd, every gradient compared.  A router that
sends every token to two experts overflows their capacity: the tokens of
every expert slot, dropped assignments as empty slots, must be the
reference's bit for bit.  The paged prefill routes its pad positions too;
they take capacity after every real token.  The launchers run the smoke
granite on the CPU.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.engine import Engine, PagedConfig  # noqa: E402

# f32 on the CPU (tests/test_kernels.py:12).  Measured: outputs within
# 1.9e-9, gradients within 2.6e-7 of each leaf's largest entry.
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL_OF_MAX = 2e-5
MOE_LEAVES = {"router", "we_gate", "we_up", "we_down"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares (as
    tests/test_torch_launch_chaos.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Tap:
    """A policy for the reference's ``constrain`` hooks that keeps each
    activation it is shown (the dispatched tokens at "moe_dispatch") and
    routes in one block, as the port does."""

    def __init__(self):
        self.seen = {}

    def seq_blocks(self):
        return 1

    def act(self, x, kind):
        self.seen[kind] = x
        return x


def _layer(arch, seed=0, **kw):
    """(jcfg, cfg, layer-0 weights as numpy) of ``arch``'s smoke model."""
    jcfg = j_smoke(j_get_config(arch).model).replace(**kw)
    cfg = smoke_model(get_config(arch).model).replace(**kw)
    jp = jlm.init(jcfg, jax.random.PRNGKey(seed))
    w = {k: np.array(v[0]) for k, v in jp["layers"].items()}
    return jcfg, cfg, w


def _both(jcfg, cfg, w, x, dy):
    """Output, gradients (x and every weight) and dispatched tokens
    (B, E, cap, D) of the reference's ``_moe_ffn`` under ``jax.jit``, and
    output and gradients of the port's."""
    def ref(x, w, dy):
        tap = Tap()
        y, vjp, X = jax.vjp(lambda x, w: (
            jlm._moe_ffn(jcfg, x, w, tap), tap.seen["moe_dispatch"][:, 0]),
            x, w, has_aux=True)
        return y, vjp(dy), X
    jy, (jdx, jdw), jX = jax.jit(ref)(jnp.asarray(x),
                                      jax.tree.map(jnp.asarray, w),
                                      jnp.asarray(dy))
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y = lm._moe_ffn(cfg, tx, tw)
    y.backward(torch.from_numpy(dy))
    want = {"x": np.asarray(jdx), **{k: np.asarray(v) for k, v in
                                     jdw.items()}}
    got = {"x": tx.grad, **{k: t.grad for k, t in tw.items()}}
    return (y.detach().numpy(), np.asarray(jy)), got, want, np.asarray(jX)


def _check_grads(got, want, leaves):
    for k in leaves:
        scale = float(np.abs(want[k]).max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=GRAD_TOL_OF_MAX * scale, err_msg=k)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "arctic_480b"])
def test_moe_ffn_and_gradients_match_reference(arch):
    jcfg, cfg, w = _layer(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    (y, jy), got, want, _ = _both(jcfg, cfg, w, x, dy)
    assert y.shape == x.shape
    np.testing.assert_allclose(y, jy, **OUT_TOL)
    leaves = {"x"} | MOE_LEAVES
    if cfg.moe_dense_ff:
        leaves |= {"w_gate", "w_up", "w_down"}
    assert set(w) >= leaves - {"x"}
    _check_grads(got, want, leaves)


def test_capacity_overflow_keeps_the_references_slots():
    """8 experts, top 2, S 64: cap = max(8, 2 * ceil(128 / 8)) = 32 slots
    an expert.  Experts 0 and 1 lead every token's router logits, tied
    (equal columns), so each takes all 64 tokens and drops its last 32
    assignments.  The dispatched tokens (B, E, cap, D), empty slots zero,
    are the reference's bit for bit, so are the kept set and the slots;
    the output and gradients agree within the tolerances."""
    jcfg, cfg, w = _layer("granite_moe_1b_a400m", num_experts=8)
    E, D, S = 8, cfg.d_model, 64
    rng = np.random.default_rng(2)
    x = (np.abs(rng.standard_normal((2, S, D))) + 0.5).astype(np.float32)
    w["router"] = (0.01 * rng.standard_normal((D, E))).astype(np.float32)
    w["router"][:, 0] = w["router"][:, 1] = 0.1
    dy = rng.standard_normal(x.shape).astype(np.float32)

    (y, jy), got, want, jX = _both(jcfg, cfg, w, x, dy)
    r = lm._moe_route(cfg, torch.from_numpy(x), torch.from_numpy(w["router"]))
    assert r.cap == 32
    ok = r.ok.view(2, S, 2)
    assert ok[:, :32].all() and not ok[:, 32:].any()  # token order wins
    X = lm._moe_dispatch(cfg, torch.from_numpy(x), r)
    X = X.view(E, 2, r.cap, D).transpose(0, 1)
    assert np.array_equal(X.numpy(), jX)
    assert (jX[:, 2:] == 0).all() and (jX[:, :2] != 0).all()
    np.testing.assert_allclose(y, jy, **OUT_TOL)
    _check_grads(got, want, {"x"} | MOE_LEAVES)


def test_remat_recompute_routes_the_same_way():
    """Under ``cfg.remat`` each layer's forward runs again in the
    backward: routing draws nothing, so the gradients are those without
    remat, bit for bit."""
    cfg = smoke_model(get_config("granite_moe_1b_a400m").model)
    params = lm.init(cfg, seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)))
    grads = []
    for remat in (False, True):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in params["layers"].items()}
        loss = lm.loss_fn(cfg.replace(remat=remat),
                          dict(params, layers=leaves), {"tokens": tokens})
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_prefill_pads_take_capacity_after_the_real_tokens(monkeypatch):
    """A one-row prefill of 24 copies of one token padded to 32 (the
    engine's B = 1 prefill), 8 experts, top 2, so cap = 16: the real
    tokens all route alike and overflow their experts.  With pad tokens 0
    or random, every real token keeps its slot and the logits at the last
    real position are the same bits; both agree with the reference's
    prefill."""
    jcfg, cfg, _ = _layer("granite_moe_1b_a400m", num_experts=8)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(4))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    S, plen, ps = 32, 24, 8
    table = np.arange(1, 1 + S // ps, dtype=np.int32)[None]
    routes = []
    route = lm._moe_route
    monkeypatch.setattr(lm, "_moe_route",
                        lambda *a: routes.append(route(*a)) or routes[-1])
    out = []
    for pad in (np.zeros(S - plen), np.arange(S - plen) * 7 + 11):
        toks = np.concatenate([np.full(plen, 5), pad]).astype(np.int32)[None]
        jlogits, _ = jlm.prefill_paged(
            jcfg, jparams, {"tokens": jnp.asarray(toks)},
            jlm.init_paged_cache(jcfg, 1 + S // ps, ps), jnp.asarray(table),
            jnp.asarray([plen], jnp.int32))
        logits, _ = lm.prefill_paged(
            cfg, params, {"tokens": torch.from_numpy(toks).long()},
            lm.init_paged_cache(cfg, 1 + S // ps, ps, device="cpu"),
            torch.from_numpy(table), torch.tensor([plen], dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=1e-4, rtol=1e-4)
        out.append(logits)
    assert torch.equal(out[0], out[1])
    assert len(routes) == 2 * cfg.num_layers
    for zero_pad, random_pad in zip(routes[:2], routes[2:]):
        real_ok = zero_pad.ok.view(S, 2)[:plen]
        assert torch.equal(real_ok, random_pad.ok.view(S, 2)[:plen])
        assert not real_ok.all()  # real tokens overflowed ...
        assert real_ok[:16].all()  # ... and the first cap of them stayed


def test_engine_refuses_families_without_a_paged_cache():
    cfg = smoke_model(get_config("mamba2_1p3b").model)
    from repro_torch.models import mamba2
    eng = Engine(cfg, mamba2.init(cfg, seed=0, device="cpu"), device="cpu",
                 paged=PagedConfig(page_size=8, max_slots=2))
    with pytest.raises(ValueError, match="KV-cache family"):
        eng.serve(launch_serve.poisson_requests(1, 1e3, 8, 2, 64))


def test_launchers_run_the_smoke_granite_on_the_cpu(capsys):
    out = train.main(["--device", "cpu", "--arch", "granite_moe_1b_a400m",
                      "--rounds", "2", "--seq", "40"])
    assert out["cfg"].family == "moe" and out["cfg"].num_experts == 4
    assert len(out["history"]) == 2
    assert all(0 < h["loss"] < 10 for h in out["history"])
    launch_serve.main(["--continuous", "--device", "cpu", "--arch",
                       "granite_moe_1b_a400m", "--requests", "3", "--rate",
                       "1000"])
    assert "continuous: 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "arctic_480b"])
def test_one_token_rows_take_the_routed_function(arch):
    """The decode step's rows (S = 1) route each token alone through the
    dispatch: cap = 8 keeps all of a token's K distinct experts, and the
    output is the reference's at 8 rows of one token."""
    jcfg, cfg, w = _layer(arch)
    x = np.random.default_rng(6).standard_normal(
        (8, 1, cfg.d_model)).astype(np.float32)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    r = lm._moe_route(cfg, torch.from_numpy(x), tw["router"])
    assert r.cap == 8 and bool(r.ok.all())
    assert int(r.valid.sum()) == 8 * cfg.experts_per_token
    jy = jax.jit(lambda x, w: jlm._moe_ffn(jcfg, x, w, None))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, w))
    np.testing.assert_allclose(lm._moe_ffn(cfg, torch.from_numpy(x),
                                           tw).numpy(), np.asarray(jy),
                               **OUT_TOL)
