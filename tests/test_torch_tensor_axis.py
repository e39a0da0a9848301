"""The tensor ("model") axis on the CPU: the storage split, the dense LM
computed over it, and what it does not run yet.

- The split dim of every stacked leaf (``dist.policies.leaf_split``)
  against the reference's ``Policy._leaf_spec(shape, stacked=True)``
  (policies.py:64-86) for every leaf of every ``ARCH_IDS`` config at full
  size, on model axes of 2, 3, 4 and 16 ranks: shapes only (the
  reference's ``jax.eval_shape`` of its init, the port's init on
  ``meta``), exactly.
- One dense ``_block``'s forward and every gradient (of its input and of
  each weight piece) under the tensor context on a 2-rank gloo world
  against the port's unsplit block, in f32 within 2e-5
  (tests/test_kernels.py:12): the smoke smollm (4 heads over 2 KV heads,
  the heads split) and a 3-head / 1-KV-head variant (the attention whole
  on every rank); and ``loss_fn`` (the vocab-parallel embedding, logits
  and cross entropy over the padded vocab, 257 of 512 columns) with every
  gradient, under ``cfg.remat``, within the same tolerance; the
  recompute issues no collective of its own (the psums' outputs are kept:
  as many transport calls as without remat); the axis's gather and
  scatter and their gradients.
- What a model axis does not run raises naming ROADMAP.md item 5.3: MoE,
  in the round step and in the launcher.
"""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import RankMesh, run_world
from repro_torch.dist.tensor import piece

# the ranks import this module: nothing of JAX at its top
TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_SIZES = (2, 3, 4, 16)
B, S = 2, 8
VARIANTS = {"heads split": {}, "attention whole": dict(num_heads=3,
                                                       num_kv_heads=1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfg(variant, **kw):
    from repro_torch.configs import get_config, smoke_model
    cfg = smoke_model(get_config("smollm_135m").model)
    return cfg.replace(**VARIANTS[variant], **kw)


def inputs(cfg, seed):
    """Weights (``lm.init``), the block's input and its output's probe,
    and a token batch, all from ``seed``."""
    from repro_torch.models import lm
    gen = torch.Generator().manual_seed(seed)
    params = lm.init(cfg, gen, device="cpu")
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    probe = torch.randn((B, S, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    return params, x, probe, tokens


def block_grads(cfg, w, x, probe, tp=None):
    """_block's output and the gradients of <output, probe> with respect
    to its input and to each weight (flat name -> tensor)."""
    from repro_torch.models import lm
    w = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
    x = x.clone().requires_grad_()
    tables = lm._rope_tables(cfg, torch.arange(S))
    y = lm._block(cfg, x, w, tables, tp=tp)
    grads = torch.autograd.grad((y * probe).sum(), [x] + list(w.values()))
    return (y.detach(), grads[0],
            {k: g for k, g in zip(w, grads[1:])})


def loss_grads(cfg, params, tokens, tp=None):
    from repro_torch.models import lm
    from repro_torch.tree import flatten, unflatten
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in flatten(params).items()}
    loss = lm.loss_fn(cfg, unflatten(flat), {"tokens": tokens}, tp=tp)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


def pieces(cfg, flat, ax, layer=False):
    """This rank's compute pieces of a flat dict of whole leaves
    (``lm.tensor_dims``; ``layer``: one layer's slices)."""
    from repro_torch.models import lm
    dims = lm.tensor_dims(cfg, ax.size)
    out = {}
    for k, v in flat.items():
        d = dims["layers/" + k] if layer else dims[k]
        if d is not None and layer:
            d -= 1
        out[k] = v if d is None else ax.piece(v, d).contiguous()
    return out


def tensor_rank(mesh):
    """Each variant's block and loss on this rank of the model axis."""
    from repro_torch.dist.tensor import tensor_axis
    from repro_torch.tree import flatten, unflatten
    ax = tensor_axis(mesh)
    out = {}
    for variant in VARIANTS:
        cfg = smoke_cfg(variant)
        params, x, probe, tokens = inputs(cfg, 3)
        w = {k: v[0] for k, v in params["layers"].items()}
        out[variant, "block"] = block_grads(cfg, pieces(cfg, w, ax, True),
                                            x, probe, ax)
        calls = []
        for remat in (False, True):
            cfg = smoke_cfg(variant, remat=remat)
            mesh.reset_stats()
            out[variant, "loss"] = loss_grads(
                cfg, unflatten(pieces(cfg, flatten(params), ax)), tokens, ax)
            calls.append(mesh.stats["calls"])
        out[variant, "calls"] = calls
    x = inputs(smoke_cfg("heads split"), 4)[1].requires_grad_()
    y = ax.gather(ax.scatter(x, 2) * (ax.index + 1.0), 2)
    out["gather"] = (y.detach(), torch.autograd.grad((y * y).sum(), x)[0])
    return ax.index, out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(tensor_rank, 2, shape=(1, 2), device="cpu",
                     timeout_s=240, root=tmp_path_factory.mktemp("world"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_block_matches_unsplit(world, variant):
    from repro_torch.models import lm
    cfg = smoke_cfg(variant)
    params, x, probe, _ = inputs(cfg, 3)
    w = {k: v[0] for k, v in params["layers"].items()}
    y, dx, dw = block_grads(cfg, w, x, probe)
    dims = lm.tensor_dims(cfg, 2)
    split = [k for k in w if dims["layers/" + k] is not None]
    heads = {"wq", "wk", "wv", "wo"} & set(split)
    assert bool(heads) == (variant == "heads split")
    assert {"w_gate", "w_up", "w_down"} <= set(split)
    for index, out in world:
        gy, gdx, gdw = out[variant, "block"]
        np.testing.assert_allclose(gy, y, **TOL)
        np.testing.assert_allclose(gdx, dx, **TOL)
        for k, g in dw.items():
            d = dims["layers/" + k]
            np.testing.assert_allclose(
                gdw[k], piece(g, None if d is None else d - 1, 2, index),
                err_msg=k, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_vocab_parallel_loss_matches_unsplit(world, variant):
    from repro_torch.models import lm
    cfg = smoke_cfg(variant, remat=True)
    assert cfg.vocab_padded == 512 and cfg.vocab_size == 257
    params, _, _, tokens = inputs(cfg, 3)
    loss, grads = loss_grads(cfg, params, tokens)
    dims = lm.tensor_dims(cfg, 2)
    assert dims["emb"] == 0  # rank 1's columns 256-511: all but one padding
    for index, out in world:
        gl, gg = out[variant, "loss"]
        np.testing.assert_allclose(gl, loss, **TOL)
        for k, g in grads.items():
            np.testing.assert_allclose(gg[k], piece(g, dims[k], 2, index),
                                       err_msg=k, **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_recompute_issues_no_collective(world, variant):
    for _, out in world:
        no_remat, remat = out[variant, "calls"]
        assert remat == no_remat > 0


def test_gather_and_scatter(world):
    """gather(scatter(x) * (rank + 1)): the pieces scaled by their rank's
    factor, whole on every rank; its gradient all-gathered back."""
    x = inputs(smoke_cfg("heads split"), 4)[1]
    scale = torch.cat([torch.full((x.shape[2] // 2,), float(i + 1))
                       for i in range(2)])
    for _, out in world:
        y, dx = out["gather"]
        np.testing.assert_allclose(y, x * scale, **TOL)
        np.testing.assert_allclose(dx, 2 * x * scale * scale, **TOL)


def _leaf_names(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaf_names(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                    reason="the reference needs jax")
@pytest.mark.parametrize("n", MODEL_SIZES)
def test_split_dims_match_reference(n):
    """Every leaf of every config, stacked over R = 16 replicas."""
    import types

    import jax

    from repro.configs import get_config as j_get_config
    from repro.dist.policies import Policy as JPolicy
    from repro.models.registry import get_model as j_get_model
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.configs.base import FLTopology
    from repro_torch.dist.policies import make_train_policy
    from repro_torch.models.registry import get_model
    R = 16
    jpol = JPolicy(mesh=types.SimpleNamespace(shape={"data": 1, "model": n}),
                   replica_axes=("data",), tensor_axes=("model",))
    pol = make_train_policy(RankMesh((1, n), ("data", "model"), world=n),
                            FLTopology(8, 2), dp_axes=("data",))
    assert pol.model == n
    checked = 0
    for arch in ARCH_IDS:
        jcfg = j_get_config(arch).model
        jshapes = _leaf_names(jax.eval_shape(
            lambda: j_get_model(jcfg).init(jcfg, jax.random.PRNGKey(0))))
        cfg = get_config(arch).model
        shapes = _leaf_names(get_model(cfg).init(cfg, device="meta"))
        assert shapes == jshapes, arch
        dims = pol.storage_dims({k: (R,) + s for k, s in shapes.items()})
        for k, s in shapes.items():
            spec = jpol._leaf_spec((R,) + s, stacked=True)
            want = [i for i, a in enumerate(spec)
                    if a in ("model", ("model",))]
            assert dims[k] == (want[0] if want else None), (arch, k, spec)
            checked += 1
    assert checked > 100


def _model_policy(n=2):
    from repro_torch.configs.base import FLTopology
    from repro_torch.dist.policies import make_train_policy
    mesh = RankMesh((1, n), ("data", "model"), world=n)  # no group needed
    return make_train_policy(mesh, FLTopology(2, 2), dp_axes=("data",))


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m"])
def test_other_families_raise_naming_item_5(arch):
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.core.round import make_round_step
    cfg = smoke_model(get_config(arch).model)
    with pytest.raises(NotImplementedError, match="item 5.3") as exc:
        make_round_step(cfg, HCEFConfig(), FLTopology(2, 2),
                        _model_policy())
    assert "not ported yet" in str(exc.value)


@pytest.mark.parametrize("flags", [["--arch", "granite_moe_1b_a400m"]])
def test_launcher_exits_naming_item_5(flags, capsys):
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--arch", "smollm_135m", "--mesh", "single",
            "--model-axis", "2", "--rounds", "1"] + flags
    with pytest.raises(SystemExit) as exc:
        train.main(argv)
    assert exc.value.code == 2
    assert "item 5.3" in capsys.readouterr().err
