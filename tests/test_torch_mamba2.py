"""The port's Mamba2 against the JAX package's, on the CPU.

The reference's parameters (its ``init``, carried over bit for bit by
``convert.params_from_jax``) and the same tokens go through both
``forward`` and ``loss_fn``, and through their gradients, on the smoke
config (f32; ``ssm_groups`` 1) and on variants with 2 groups (a head/group
repeat fault would show only there) and with ``remat`` on; the conversion
is checked at the configuration's types (bf16 and f32 leaves).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

# f32 on the CPU; XLA and ATen order the matmul and scan sums differently.
# Measured over the variants below: logits <= 4.9e-7 apart, losses <=
# 1.7e-7 relative, gradients <= 1.9e-6 of each leaf's largest entry.
LOGIT_TOL = dict(atol=5e-6, rtol=1e-5)
LOSS_RTOL = 1e-6
GRAD_TOL_OF_MAX = 1e-5

VARIANTS = {"smoke": {}, "groups2": dict(ssm_groups=2),
            "groups2-remat-3layers": dict(ssm_groups=2, remat=True,
                                          num_layers=3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """(reference cfg, port cfg): smoke_model of mamba2_1p3b with kw."""
    return (j_smoke(j_get_config("mamba2_1p3b").model).replace(**kw),
            smoke_model(get_config("mamba2_1p3b").model).replace(**kw))


def _setup(kw, seed=0, B=2, S=40):
    jcfg, cfg = _cfgs(**kw)
    jparams = jm.init(jcfg, jax.random.PRNGKey(seed))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def test_params_from_jax_carries_the_stacked_layers_bit_for_bit():
    """At the configuration's dtypes (bf16 weights, f32 dt_bias, A_log and
    D_skip) on a narrow copy of it: every leaf, the ``layers`` dict
    included, arrives with the reference's type, shape and bits."""
    jcfg = j_smoke(j_get_config("mamba2_1p3b").model).replace(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = jax.tree.map(np.asarray, jm.init(jcfg, jax.random.PRNGKey(3)))
    params = params_from_jax(jparams, "cpu")
    jflat = {"/".join(str(k.key) for k in path): v for path, v in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = flatten(params)
    assert set(flat) == set(jflat) and len(flat) == 11
    for k, v in jflat.items():
        t = flat[k]
        assert tuple(t.shape) == v.shape, k
        want = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            v.dtype.name]
        assert t.dtype == want, k
        bits = np.int16 if want == torch.bfloat16 else np.int32
        raw = t.view(torch.int16 if want == torch.bfloat16 else torch.int32)
        np.testing.assert_array_equal(raw.numpy(), v.view(bits), err_msg=k)
    assert {k for k in flat if flat[k].dtype == torch.float32} == {
        "layers/A_log", "layers/D_skip", "layers/dt_bias"}


def test_port_init_has_the_reference_shapes_types_and_constants():
    jcfg, cfg, jparams, _, _ = _setup({})
    ours = flatten(mamba2.init(cfg, torch.Generator().manual_seed(0),
                               device="cpu"))
    ref = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
           jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert tuple(ours[k].shape) == v.shape, k
        if k.split("/")[-1] in ("ln", "conv_b", "dt_bias", "A_log",
                                "D_skip", "norm_w") or k == "final_norm":
            np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
        else:  # seeded normals at the reference's scale
            assert abs(float(ours[k].std()) - float(v.std())) < \
                0.1 * float(v.std()), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_loss_match_reference(variant):
    jcfg, cfg, jparams, params, tokens = _setup(VARIANTS[variant])
    batch = {"tokens": torch.from_numpy(tokens)}
    logits = mamba2.forward(cfg, params, batch)
    jlogits = jax.jit(lambda p, t: jm.forward(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    assert logits.shape == (2, 40, cfg.vocab_padded)
    # padded vocab columns are -1e30 in both
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **LOGIT_TOL)
    loss = float(mamba2.loss_fn(cfg, params, batch))
    jloss = float(jax.jit(lambda p, t: jm.loss_fn(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens)))
    assert abs(loss - jloss) <= LOSS_RTOL * abs(jloss)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_gradients_match_reference(variant):
    jcfg, cfg, jparams, params, tokens = _setup(VARIANTS[variant], seed=1)
    jg = jax.jit(jax.grad(lambda p, t: jm.loss_fn(jcfg, p, {"tokens": t})))(
        jparams, jnp.asarray(tokens))
    leaves = flatten(params)
    for v in leaves.values():
        v.requires_grad_()
    loss = mamba2.loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens)})
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    assert set(grads) == set(jflat)
    for k, w in jflat.items():
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=0,
                                   atol=GRAD_TOL_OF_MAX * scale, err_msg=k)
