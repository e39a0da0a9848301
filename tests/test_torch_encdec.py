"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package's, on the CPU.

The smoke seamless-m4t-large-v2 (f32, 2 decoder and 2 encoder layers, 4
heads of 16 over 4 KV heads, cross-attention, an untied head), the
reference's weights carried over by ``convert.params_from_jax``, and the
same tokens and frame embeddings (numpy, seeded): both stacks leaf for
leaf, the encoder alone, the cross-attention alone (output and the
gradients of its inputs under ``jax.vjp``), ``forward``, ``loss_fn`` and
every gradient, the encoder's and the frames' included, against
``jax.grad`` of the reference's loss (its jnp attention route), with
``remat`` off and on.  The encoder output feeds every decoder layer's
cross-attention, so its gradient is a sum over the layers: the frames'
gradient holds that sum.
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
from repro_torch.core.round import _per_layer  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import stack_list  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "seamless_m4t_large_v2"
# f32 on the CPU, as tests/test_torch_lm_train.py: XLA and ATen order the
# matmul and softmax sums differently.  Measured (remat off and on):
# logits within 1.8e-7, losses within 8.6e-8 relative, gradients within
# 5.7e-7 of each leaf's largest entry.
TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_RTOL = 2e-5
GRAD_TOL_OF_MAX = 2e-5
B, S = 2, 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(remat=False, seed=0):
    jcfg = j_smoke(j_get_config(ARCH).model).replace(remat=remat)
    cfg = smoke_model(get_config(ARCH).model).replace(remat=remat)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "frames": rng.normal(0, 1, (B, S, cfg.d_model)).astype(
                 np.float32)}
    return jcfg, cfg, jparams, params, batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_of_max(got, want, err_msg=""):
    scale = float(np.abs(want).max())
    assert scale > 0, err_msg
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_TOL_OF_MAX * scale, err_msg=err_msg)


def test_both_stacks_carry_over_leaf_for_leaf():
    _, cfg, jparams, params, _ = _setup()
    want, got = _flat(jparams), flatten(params)
    assert set(got) == set(want)
    assert {k.split("/")[0] for k in got} == {
        "emb", "enc_layers", "enc_norm", "final_norm", "layers", "out_head"}
    assert {"layers/wxq", "layers/wxk", "layers/wxv", "layers/wxo",
            "layers/lnx"} <= set(got)
    assert not any(k.startswith("enc_layers/wx") for k in got)
    for k, w in want.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert got["enc_layers/wq"].shape[0] == cfg.enc_layers == 2


def test_encoder_alone_matches_reference():
    jcfg, cfg, jparams, params, batch = _setup(seed=1)
    mem = lm._encode(cfg, params, torch.from_numpy(batch["frames"]))
    jmem = jax.jit(lambda p, f: jlm._encode(jcfg, p, f, None))(
        jparams, jnp.asarray(batch["frames"]))
    assert mem.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), **TOL)


def test_cross_attention_alone_matches_reference():
    """One decoder layer's cross-attention of x over the encoder output:
    the output, and the gradients of x and of the encoder output (through
    the layer's own K and V projections) under ``jax.vjp``."""
    jcfg, cfg, jparams, params, batch = _setup(seed=2)
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, 12, cfg.d_model)).astype(np.float32)
    mem = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    ct = rng.normal(0, 1, (B, 12, cfg.d_model)).astype(np.float32)
    jw = jax.tree.map(lambda a: a[0], jparams["layers"])
    w = {k: v[0] for k, v in params["layers"].items()}

    def jfn(x, mem):
        KH, Dh = jcfg.num_kv_heads, jcfg.head_dim
        xk = (mem @ jw["wxk"]).reshape(B, -1, KH, Dh)
        xv = (mem @ jw["wxv"]).reshape(B, -1, KH, Dh)
        return jlm._cross_attention(jcfg, x, jw, None, (xk, xv))

    jout, vjp = jax.vjp(jax.jit(jfn), jnp.asarray(x), jnp.asarray(mem))
    jdx, jdmem = vjp(jnp.asarray(ct))
    tx, tmem = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    out = lm._cross_attention(cfg, tx, w, lm._cross_kv(cfg, tmem, w))
    dx, dmem = torch.autograd.grad(out, (tx, tmem), torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    _close_of_max(dx.numpy(), np.asarray(jdx), "dx")
    _close_of_max(dmem.numpy(), np.asarray(jdmem), "dmem")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_and_loss_match_reference(remat):
    jcfg, cfg, jparams, params, batch = _setup(remat)
    logits = lm.forward(cfg, params, _torch(batch))
    jlogits = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(jparams,
                                                           _jax(batch))
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    loss = float(lm.loss_fn(cfg, params, _torch(batch)))
    jloss = float(jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b))(
        jparams, _jax(batch)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_every_gradient_matches_reference(remat):
    """Every leaf's gradient, the encoder's included, and the frames'
    gradient: the sum over the decoder layers' cross-attentions, through
    the encoder."""
    jcfg, cfg, jparams, params, batch = _setup(remat, seed=4)
    jg, jgf = jax.jit(jax.grad(
        lambda p, f, t: jlm.loss_fn(jcfg, p, {"tokens": t, "frames": f}),
        argnums=(0, 1)))(jparams, jnp.asarray(batch["frames"]),
                         jnp.asarray(batch["tokens"]))
    leaves = flatten(params)
    tb = _torch(batch)
    tb["frames"].requires_grad_()
    for v in leaves.values():
        v.requires_grad_()
    loss = lm.loss_fn(cfg, params, tb)
    *grads, dframes = torch.autograd.grad(
        loss, list(leaves.values()) + [tb["frames"]])
    grads = dict(zip(leaves, grads))
    want = _flat(jg)
    assert set(grads) == set(want)
    assert any(k.startswith("enc_layers/") for k in want)
    for k, w in want.items():
        _close_of_max(grads[k].numpy(), w, k)
    _close_of_max(dframes.numpy(), np.asarray(jgf), "frames")


def test_round_step_takes_the_encoder_stack_per_layer():
    """The round step's ``_per_layer`` takes ``enc_layers`` as it takes
    ``layers``: each layer's slice of every leaf, rebuilt into lists of
    per-layer dicts that give the stacked loss bit for bit."""
    _, cfg, _, params, batch = _setup(seed=5)
    leaves, rebuild = _per_layer(params)
    n_top = 4  # emb, enc_norm, final_norm, out_head
    n_dec = len(params["layers"]) * cfg.num_layers
    n_enc = len(params["enc_layers"]) * cfg.enc_layers
    assert len(leaves) == n_top + n_dec + n_enc
    tree = rebuild(leaves)
    assert len(tree["enc_layers"]) == cfg.enc_layers
    for got, want in zip(tree["enc_layers"], stack_list(params["enc_layers"])):
        assert got.keys() == want.keys()
        assert all(got[k] is not None and torch.equal(got[k], want[k])
                   for k in got)
    assert torch.equal(lm.loss_fn(cfg, tree, _torch(batch)),
                       lm.loss_fn(cfg, params, _torch(batch)))
