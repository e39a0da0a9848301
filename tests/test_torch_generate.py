"""The port's static serving path (``init_cache``, ``prefill``,
``decode_step``, ``Engine.generate``) against the JAX package's, on the
CPU.

Smoke configs in f32 with the reference's weights carried over by
``convert.params_from_jax``: the dense smollm-135m, the MoE
granite-moe-1b-a400m, the ViT stub of internvl2-2b (seeded N(0, 1)
patch embeddings in the first 8 positions) and the encoder-decoder
seamless-m4t-large-v2 (seeded N(0, 1) frames; the cross-attention cache
``xk`` / ``xv``).  Each runs ``init_cache``, ``prefill`` and 5
``decode_step``s against the reference's, fed the same tokens: logits and
caches within ``test_torch_lm.py``'s TOL.  ``Engine.generate`` gives the
reference engine's greedy tokens for every family, mamba2 and griffin
included, with the weights scaled by 10 (so that greedy decoding does not
repeat one token) and every emitting row's top-2 margin checked, as
``test_torch_serving.py:_serve_parity`` does.  Then the reference's
static-engine scenarios (tests/test_serving.py:TestEngineStatic) on the
port alone, and the serve launcher without ``--continuous``.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_model as j_smoke  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.serving.engine import Engine as JEngine  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro_torch.configs import get_config, smoke_model  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402

# test_torch_lm.py's: f32 sums in other orders in torch and in XLA
TOL = dict(atol=1e-4, rtol=1e-4)
LM_ARCHS = ["smollm_135m", "granite_moe_1b_a400m", "internvl2_2b",
            "seamless_m4t_large_v2"]
ALL_ARCHS = LM_ARCHS + ["mamba2_1p3b", "recurrentgemma_9b"]
# greedy tokens are compared only where the reference's top two logits
# are further apart than the two sides' logits can differ
MARGIN = 1e-3
# leaves the weight scaling leaves alone: norms, and mamba2's and
# griffin's per-channel constants
UNSCALED = ("ln", "norm", "A_log", "dt_bias", "D_skip", "log_lambda",
            "conv_b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(arch, seed=0, scale=1.0, num_layers=None):
    """(jcfg, jmodel, jparams, cfg, model, params): the reference's smoke
    config and weights (times ``scale`` but for ``UNSCALED`` leaves) and
    the port's, carried over."""
    jcfg = j_smoke(j_get_config(arch).model)
    cfg = smoke_model(get_config(arch).model)
    if num_layers:
        jcfg = jcfg.replace(num_layers=num_layers)
        cfg = cfg.replace(num_layers=num_layers)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init(jcfg, jax.random.PRNGKey(seed))
    if scale != 1.0:
        jparams = jax.tree_util.tree_map_with_path(
            lambda path, a: a if any(u in str(path) for u in UNSCALED)
            else a * scale, jparams)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jmodel, jparams, cfg, get_model(cfg), params


def stand_ins(cfg, B, S, rng):
    """Seeded frontend inputs beside the tokens: patch embeddings for the
    ViT stub, frames of the prompt's length for the encoder."""
    extra = {}
    if cfg.frontend == "vit_stub":
        extra["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.enc_layers:
        extra["frames"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(
            np.float32)
    return extra


def assert_cache_close(cache, jcache):
    assert set(cache) == set(jcache)
    assert cache["pos"] == int(jcache["pos"])
    for name in cache:
        if name != "pos":
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL,
                                       err_msg=name)


def static_parity(arch, *, B=2, S=12, max_len=24, steps=5, seed=0,
                  num_layers=None):
    """init_cache, prefill and ``steps`` decode_steps on both sides, the
    same greedy tokens fed to both: logits and caches within TOL after
    every call.  Returns the port's logits."""
    jcfg, jm, jparams, cfg, m, params = models(arch, seed, num_layers=
                                               num_layers)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = dict(tokens=toks, **stand_ins(cfg, B, S, rng))
    enc = S if cfg.enc_layers else 0
    jcache = jm.init_cache(jcfg, B, max_len, enc_len=enc)
    cache = m.init_cache(cfg, B, max_len, enc_len=enc, device="cpu")
    assert_cache_close(cache, jcache)
    j_prefill = jax.jit(functools.partial(jm.prefill, jcfg))
    j_decode = jax.jit(functools.partial(jm.decode_step, jcfg))
    jlogits, jcache = j_prefill(jparams, {k: jnp.asarray(v) for k, v in
                                          batch.items()}, jcache)
    logits, cache = m.prefill(cfg, params, {k: torch.from_numpy(v)
                                            for k, v in batch.items()},
                              cache)
    out = [logits]
    for step in range(steps + 1):
        assert logits.shape == (B, 1, cfg.vocab_padded)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"call {step}")
        assert_cache_close(cache, jcache)
        if step == steps:
            return out
        tok = np.asarray(jnp.argmax(jlogits[:, -1], -1)).astype(np.int32)
        jlogits, jcache = j_decode(jparams, jcache,
                                   jnp.asarray(tok[:, None]))
        logits, cache = m.decode_step(cfg, params, cache,
                                      torch.from_numpy(tok[:, None]))
        out.append(logits)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_static_cache_matches_reference(arch):
    static_parity(arch)


def generate_parity(arch, *, B=3, S=12, new=6, batch=2, seed=3):
    """Engine.generate of both engines on the same prompts (and
    stand-ins), B over two chunks of ``batch``: the same greedy tokens,
    every emitting row of the reference well clear of a tie."""
    jcfg, jm, jparams, cfg, m, params = models(arch, seed, scale=10.0)
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = stand_ins(cfg, B, S, rng) or None
    emitted = []

    class Spy:
        """The reference's model module, reporting the logits of every
        call its jitted prefill and decode make."""
        init_cache = staticmethod(jm.init_cache)

        @staticmethod
        def prefill(*a, **kw):
            logits, cache = jm.prefill(*a, **kw)
            jax.debug.callback(lambda lg: emitted.append(np.asarray(lg)),
                               logits)
            return logits, cache

        @staticmethod
        def decode_step(*a, **kw):
            logits, cache = jm.decode_step(*a, **kw)
            jax.debug.callback(lambda lg: emitted.append(np.asarray(lg)),
                               logits)
            return logits, cache

    jeng = JEngine(jcfg, jparams, max_len=S + new, batch_size=batch,
                   serve=JServe(max_new_tokens=new))
    jeng.model = Spy
    theirs = jeng.generate(prompts, extra_inputs=extra)
    jax.effects_barrier()
    ours = Engine(cfg, params, device="cpu", max_len=S + new,
                  batch_size=batch,
                  serve=ServeConfig(max_new_tokens=new)).generate(
        prompts, extra_inputs=extra)
    lg = np.concatenate([e[:, -1] for e in emitted])
    top2 = np.sort(lg, axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    assert (margins > MARGIN).all(), f"near-tie: margins {np.sort(margins)}"
    assert ours.shape == theirs.shape == (B, new)
    assert len(np.unique(theirs)) > new  # not one repeated token
    np.testing.assert_array_equal(ours, np.asarray(theirs))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_generate_matches_reference_greedy(arch):
    generate_parity(arch)


# ---------------------------------------------------------------------------
# the reference's static-engine scenarios (tests/test_serving.py:
# TestEngineStatic) on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smol():
    cfg = smoke_model(get_config("smollm_135m").model)
    return cfg, lm.init(cfg, seed=0, device="cpu")


def _engine(cfg, params, *, batch=4, max_new=8, temperature=0.0, eos=-1,
            seed=0):
    return Engine(cfg, params, device="cpu", max_len=32, batch_size=batch,
                  serve=ServeConfig(max_new_tokens=max_new,
                                    temperature=temperature, eos_id=eos,
                                    seed=seed))


def test_partial_and_oversized_batches(smol):
    cfg, params = smol
    eng = _engine(cfg, params, batch=4, max_new=6)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    full = eng.generate(prompts)
    assert full.shape == (4, 6)
    part = eng.generate(prompts[:3])          # padded with copies
    assert part.shape == (3, 6)
    assert np.array_equal(part, full[:3])     # padding rows don't leak
    big = eng.generate(np.concatenate([prompts, prompts])[:7])  # chunked
    assert big.shape == (7, 6)
    assert np.array_equal(big[:4], full)
    with pytest.raises(ValueError, match="batch_size"):
        Engine(cfg, params, device="cpu").generate(prompts)


def test_greedy_deterministic_temperature_seeded(smol):
    cfg, params = smol
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    g = _engine(cfg, params, batch=2, max_new=6)
    assert np.array_equal(g.generate(prompts), g.generate(prompts))
    t1 = _engine(cfg, params, batch=2, max_new=6, temperature=0.7)
    t2 = _engine(cfg, params, batch=2, max_new=6, temperature=0.7)
    assert np.array_equal(t1.generate(prompts), t2.generate(prompts))
    assert not np.array_equal(g.generate(prompts), t1.generate(prompts))
    t3 = _engine(cfg, params, batch=2, max_new=6, temperature=0.7, seed=1)
    assert not np.array_equal(t1.generate(prompts), t3.generate(prompts))


def test_eos_early_exit_emits_pad(smol):
    cfg, params = smol
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    free = _engine(cfg, params, batch=2, max_new=8).generate(prompts)
    eos = int(free[0, 2])  # token row 0 greedily emits at step 2
    out = _engine(cfg, params, batch=2, max_new=8, eos=eos).generate(
        prompts)
    for r in range(2):
        hits = np.nonzero(free[r] == eos)[0]
        stop = int(hits[0]) if hits.size else None
        if stop is None:
            assert np.array_equal(out[r], free[r])
        else:  # tokens up to and incl. EOS, pad_id afterwards
            assert np.array_equal(out[r][:stop + 1], free[r][:stop + 1])
            assert (out[r][stop + 1:] == 0).all()
    # a batch done early is padded out to the contract
    both = _engine(cfg, params, batch=1, max_new=8,
                   eos=int(free[0, 0])).generate(prompts[:1])
    assert both.shape == (1, 8) and (both[0, 1:] == 0).all()


def test_static_cache_refuses_overflow(smol):
    cfg, params = smol
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="over a cache"):
        lm.prefill(cfg, params, {"tokens": torch.zeros((1, 5),
                                                       dtype=torch.int64)},
                   cache)
    lm.prefill(cfg, params, {"tokens": torch.zeros((1, 4),
                                                   dtype=torch.int64)},
               cache)
    with pytest.raises(ValueError, match="past a cache"):
        lm.decode_step(cfg, params, cache, torch.zeros((1, 1),
                                                       dtype=torch.int64))


@pytest.mark.parametrize("arch", ["qwen2_7b", "internvl2_2b",
                                  "seamless_m4t_large_v2"])
def test_launcher_generates_on_cpu(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--batch", "3",
                "--new-tokens", "5"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "generated 15 tokens" in out
    assert "on cpu" in out


def test_launcher_refuses_a_prompt_shorter_than_the_patches(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "internvl2_2b",
                    "--prompt-len", "4"])
    assert "patch positions" in capsys.readouterr().err
