"""The port's ViT-stub frontend (internvl2-2b) against the JAX package's, on
the CPU.

The smoke internvl2-2b (f32, 2 layers, GQA 4/2 heads of 16, an untied head,
``vit_stub`` with 8 patch positions), the reference's weights carried over
by ``convert.params_from_jax``, and the same tokens and patch embeddings
(numpy, seeded): init names, shapes and parameter counts, ``forward`` and
the masked ``loss_fn``, every gradient against ``jax.grad`` of the
reference's loss (its jnp attention route, the one the reference takes on
the CPU), with ``remat`` off and on; and the guard that keeps a config the
port does not compute from running as a plain decoder.
"""
import math

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
from repro_torch.models import lm  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

ARCH = "internvl2_2b"
# f32 on the CPU, as tests/test_torch_lm_train.py: XLA and ATen order the
# matmul and softmax sums differently.  Measured (remat off and on):
# logits within 1.8e-7, losses within 1.7e-7 relative, gradients within
# 5.0e-7 of each leaf's largest entry.
LOGIT_TOL = dict(atol=2e-5, rtol=2e-5)
LOSS_RTOL = 2e-5
GRAD_TOL_OF_MAX = 2e-5
B, S = 2, 24  # 8 patch positions, then 16 token positions


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
             "patch_embeds": rng.normal(
                 0, 1, (B, cfg.frontend_tokens, cfg.d_model)).astype(
                     np.float32)}
    return jcfg, cfg, jparams, params, batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_config_names_the_vit_stub():
    cfg = smoke_model(get_config(ARCH).model)
    assert cfg.family == "dense" and cfg.frontend == "vit_stub"
    assert cfg.frontend_tokens == 8 and not cfg.tie_embeddings


@pytest.mark.parametrize("arch", ["internvl2_2b", "seamless_m4t_large_v2"])
def test_init_names_shapes_and_counts_match_reference(arch):
    """The smoke init leaf for leaf, and the full config's parameter count
    from its shapes against the reference's ``init`` under
    ``jax.eval_shape`` (nothing allocated)."""
    jcfg, cfg = j_smoke(j_get_config(arch).model), \
        smoke_model(get_config(arch).model)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    ours = flatten(lm.init(cfg, seed=0, device="cpu"))
    theirs = {"/".join(str(k.key) for k in path): (tuple(v.shape),
                                                   str(v.dtype))
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jparams)[0]}
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in ours.items()} \
        == theirs
    assert lm.param_count(lm.init(cfg, seed=0, device="cpu")) == \
        jlm.param_count(jparams)
    full, jfull = get_config(arch).model, j_get_config(arch).model
    shapes = jax.eval_shape(lambda: jlm.init(jfull, jax.random.PRNGKey(0)))
    n = sum(math.prod(s.shape) for s in jax.tree.leaves(shapes))
    stacks = [(lm._layer_shapes(full, cross=full.cross_attention),
               full.num_layers)]
    if full.enc_layers:
        stacks.append((lm._layer_shapes(lm._enc_cfg(full)), full.enc_layers))
    ours = sum(L * sum(math.prod(s) for s in shp.values())
               for shp, L in stacks)
    ours += full.vocab_padded * full.d_model * (1 + (not full.tie_embeddings))
    ours += full.d_model * (1 + bool(full.enc_layers))  # the final norms
    assert ours == n == {"internvl2_2b": 1_889_634_304,
                         "seamless_m4t_large_v2": 2_034_886_656}[arch]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_forward_and_masked_loss_match_reference(remat):
    jcfg, cfg, jparams, params, batch = _setup(remat)
    logits = lm.forward(cfg, params, _torch(batch))
    jlogits = jax.jit(lambda p, b: jlm.forward(jcfg, p, b))(jparams,
                                                           _jax(batch))
    assert logits.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    loss = float(lm.loss_fn(cfg, params, _torch(batch)))
    jloss = float(jax.jit(lambda p, b: jlm.loss_fn(jcfg, p, b))(
        jparams, _jax(batch)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)


def test_patch_embeds_replace_the_first_positions():
    """The first P positions are the patch embeddings: the tokens there do
    not matter, the patch embeddings do, and the loss counts only the
    labels at positions >= P."""
    _, cfg, _, params, batch = _setup(seed=3)
    P = cfg.frontend_tokens
    other = dict(batch, tokens=batch["tokens"].copy())
    other["tokens"][:, :P] = (other["tokens"][:, :P] + 1) % cfg.vocab_size
    with torch.no_grad():
        lg = lm.forward(cfg, params, _torch(batch))
        assert torch.equal(lg, lm.forward(cfg, params, _torch(other)))
        moved = dict(batch, patch_embeds=batch["patch_embeds"] * 2)
        assert not torch.equal(lg, lm.forward(cfg, params, _torch(moved)))
        labels = torch.from_numpy(batch["tokens"][:, 1:]).long()
        ce = torch.nn.functional.cross_entropy(
            lg[:, P:-1].reshape(-1, lg.shape[-1]).float(),
            labels[:, P:].reshape(-1))
        torch.testing.assert_close(lm.loss_fn(cfg, params, _torch(batch)),
                                   ce, rtol=1e-6, atol=0)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_gradients_match_reference(remat):
    jcfg, cfg, jparams, params, batch = _setup(remat, seed=1)
    jg = jax.jit(jax.grad(lambda p, b: jlm.loss_fn(jcfg, p, b)))(
        jparams, _jax(batch))
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    loss = lm.loss_fn(cfg, params, _torch(batch))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v
             in jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(grads) == set(jflat)
    for k, w in jflat.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL_OF_MAX * scale, err_msg=k)


def test_guard_refuses_what_the_port_does_not_compute():
    """An unknown frontend raises naming item 6, before any output; a
    ViT-stub config never runs as a plain decoder without its patch
    embeddings, in the paged prefill neither (it takes them, as the
    reference's ``prefill_paged`` does)."""
    _, cfg, _, params, batch = _setup()
    tokens = {"tokens": torch.from_numpy(batch["tokens"])}
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md, modules to port, item 6"):
        lm.forward(cfg.replace(frontend="video_stub"), params, tokens)
    with pytest.raises(KeyError, match="patch_embeds"):
        lm.loss_fn(cfg, params, tokens)
    cache = lm.init_paged_cache(cfg, 8, 8, device="cpu")
    table = torch.arange(1, 4, dtype=torch.int32)[None].expand(B, 3)
    with pytest.raises(KeyError, match="patch_embeds"):
        lm.prefill_paged(cfg, params, tokens, cache, table,
                         torch.full((B,), S, dtype=torch.int32))
    logits, _ = lm.prefill_paged(cfg, params, _torch(batch), cache, table,
                                 torch.full((B,), S, dtype=torch.int32))
    assert logits.shape == (B, 1, cfg.vocab_padded)
