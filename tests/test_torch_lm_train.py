"""The port's dense LM training path against the JAX package's, on the CPU.

The reference's parameters (its ``init``, carried over bit for bit by
``convert.params_from_jax``) and the same tokens go through both
``forward`` and ``loss_fn`` and through ``jax.grad`` / torch autograd of
the loss, every leaf compared: the smoke smollm, the smoke qwen2-7b (QKV
bias) and the MoE smoke granite-moe-1b-a400m and arctic-480b (its dense
residual), f32, with ``remat`` off and on.  On the CPU the attention is
the plain blockwise version under autograd; ``chip_smoke.py`` holds the
card's kernels, forward and backward, to it.
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
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import layer_list  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

# f32 on the CPU; XLA and ATen order the matmul and softmax sums
# differently.  Measured over the variants below: logits within 1.1e-6,
# losses within 1.8e-7 relative, gradients within 2.3e-6 of each leaf's
# largest entry.
LOGIT_TOL = dict(atol=5e-6, rtol=1e-5)
LOSS_RTOL = 1e-6
GRAD_TOL_OF_MAX = 2e-5

VARIANTS = {"smollm": ("smollm_135m", {}),
            "smollm-remat": ("smollm_135m", dict(remat=True)),
            "qwen2": ("qwen2_7b", {}),
            "qwen2-remat-3layers": ("qwen2_7b", dict(remat=True,
                                                     num_layers=3)),
            "granite": ("granite_moe_1b_a400m", {}),
            "granite-remat": ("granite_moe_1b_a400m", dict(remat=True)),
            "arctic": ("arctic_480b", {})}


def _setup(variant, seed=0, B=2, S=40):
    arch, kw = VARIANTS[variant]
    jcfg = j_smoke(j_get_config(arch).model).replace(**kw)
    cfg = smoke_model(get_config(arch).model).replace(**kw)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    jcfg, cfg, jparams, params, tokens = _setup(variant)
    batch = {"tokens": torch.from_numpy(tokens)}
    logits = lm.forward(cfg, params, batch)
    jlogits = jax.jit(lambda p, t: jlm.forward(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    assert logits.shape == (2, 40, cfg.vocab_padded)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    loss = float(lm.loss_fn(cfg, params, batch))
    jloss = float(jax.jit(lambda p, t: jlm.loss_fn(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gradients_match_reference(variant):
    jcfg, cfg, jparams, params, tokens = _setup(variant, seed=1)
    jg = jax.jit(jax.grad(lambda p, t: jlm.loss_fn(jcfg, p, {"tokens": t})))(
        jparams, jnp.asarray(tokens))
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    loss = lm.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(grads) == set(jflat)
    if cfg.qkv_bias:
        assert {"layers/bq", "layers/bk", "layers/bv"} <= set(grads)
    for k, w in jflat.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL_OF_MAX * scale, err_msg=k)


def test_layers_as_a_list_give_the_stacked_result():
    """The round step hands ``loss_fn`` its layers as a list of per-layer
    dicts (views of the stacked leaves): the same loss, bit for bit."""
    _, cfg, _, params, tokens = _setup("smollm-remat", seed=2)
    batch = {"tokens": torch.from_numpy(tokens)}
    as_list = dict(params, layers=layer_list(params))
    assert len(as_list["layers"]) == cfg.num_layers
    assert torch.equal(lm.loss_fn(cfg, params, batch),
                       lm.loss_fn(cfg, as_list, batch))


def test_other_families_raise_naming_the_roadmap():
    cfg = smoke_model(get_config("smollm_135m").model).replace(
        family="hybrid")
    params = lm.init(smoke_model(get_config("smollm_135m").model), seed=0,
                     device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm.forward(cfg, params, {"tokens": torch.zeros((1, 4), dtype=int)})
