"""The port's decoder LM serving path against the JAX package's.

``smoke_model`` of smollm-135m (tied embeddings), qwen2-7b (QKV bias,
untied head), and the MoE granite-moe-1b-a400m and arctic-480b (its
dense residual), f32, with the reference's weights carried over by
``params_from_jax``: ``prefill_paged`` logits and written pages, then
decode steps through a permuted page table with ragged lengths and one
empty slot, fed the same tokens on both sides.  The MoE prefill routes
the padded positions too; they take capacity after the real tokens of
each expert.  phi3-medium-14b (untied GQA) and codeqwen1.5-7b (MHA with
QKV bias) run through the same dense code as qwen2-7b: their parameter
names and shapes are checked, not their serving path again.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import lm, mamba2  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402
from repro_torch.serving.scheduler import Request  # noqa: E402

# Sums run in a different order in torch and in XLA on the CPU (matmul
# blocking, einsum contraction order), so f32 results agree to a few ulps
# per op, compounded over 2 layers and the head: 1e-4 absolute/relative.
TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["smollm_135m", "qwen2_7b", "granite_moe_1b_a400m", "arctic_480b"]
INIT_ARCHS = ARCHS + ["phi3_medium_14b", "codeqwen1p5_7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jcfg = j_smoke(j_get_config(arch).model)
    cfg = smoke_model(get_config(arch).model)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_config_copy_matches_reference(arch, smoke):
    jcfg, cfg = j_get_config(arch).model, get_config(arch).model
    if smoke:
        jcfg, cfg = j_smoke(jcfg), smoke_model(cfg)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.vocab_padded == jcfg.vocab_padded


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_init_names_and_shapes_match_reference(arch):
    jcfg, jparams, cfg, _ = _models(arch)
    ours = lm.init(cfg, seed=0, device="cpu")
    theirs = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    mine = {k: ({n: (tuple(w.shape), str(w.dtype)[6:]) for n, w in v.items()}
                if isinstance(v, dict) else (tuple(v.shape),
                                             str(v.dtype)[6:]))
            for k, v in ours.items()}
    assert mine == theirs
    assert lm.param_count(ours) == jlm.param_count(jparams)


def test_registry_names_the_roadmap_item():
    assert get_model(smoke_model(get_config("qwen2_7b").model)) is lm
    assert get_model(smoke_model(get_config("mamba2_1p3b").model)) is mamba2
    assert get_model(smoke_model(get_config("granite_moe_1b_a400m").model)) \
        is lm
    # every family trains and is served (item 4 done): the engine takes a
    # config with a frontend or an encoder; its continuous path does not
    for arch in ("internvl2_2b", "seamless_m4t_large_v2"):
        cfg = smoke_model(get_config(arch).model)
        assert get_model(cfg) is lm
        eng = Engine(cfg, lm.init(cfg, seed=0, device="cpu"), device="cpu")
        with pytest.raises(ValueError, match="tokens alone|KV-cache family"):
            eng.serve([Request(rid=0, prompt=np.zeros(4, np.int32),
                               max_new_tokens=2)])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(0)
    B, S, ps, P = 3, 32, 8, 6
    NP = 1 + (B + 1) * P
    table = rng.permutation(np.arange(1, NP)).astype(np.int32)[:B * P]
    table = table.reshape(B, P)
    plen = np.array([5, 17, 32], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)

    jcache = jlm.init_paged_cache(jcfg, NP, ps)
    jlogits, jcache = jlm.prefill_paged(jcfg, jparams, {"tokens": toks},
                                        jcache, jnp.asarray(table),
                                        jnp.asarray(plen))
    cache = lm.init_paged_cache(cfg, NP, ps, device="cpu")
    logits, cache = lm.prefill_paged(
        cfg, params, {"tokens": torch.from_numpy(toks).long()}, cache,
        torch.from_numpy(table), torch.from_numpy(plen))
    assert logits.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)

    # decode: the three requests plus an empty slot (kv_len 0, null row)
    dtable = np.concatenate([table, np.zeros((1, P), np.int32)])
    kv_len = np.concatenate([plen, [0]]).astype(np.int32)
    tok = np.concatenate([np.asarray(jnp.argmax(jlogits[:, -1], -1)), [0]])
    for step in range(5):
        jlogits, jcache = jlm.decode_step_paged(
            jcfg, jparams, jcache, jnp.asarray(tok[:, None], jnp.int32),
            jnp.asarray(dtable), jnp.asarray(kv_len))
        logits, cache = lm.decode_step_paged(
            cfg, params, cache, torch.from_numpy(tok[:, None]).long(),
            torch.from_numpy(dtable), torch.from_numpy(kv_len))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   err_msg=f"step {step}", **TOL)
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int64)
        kv_len[:B] += 1
    # every page a live request owns agrees (page 0 takes the empty slot's
    # writes in an unspecified order and is never read unmasked)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, 1:].numpy(),
                                   np.asarray(jcache[name])[:, 1:], **TOL)
