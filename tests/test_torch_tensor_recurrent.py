"""mamba2 and griffin on the tensor ("model") axis, on the CPU: their
blocks and losses computed over a 2-rank gloo world against the port's
unsplit ones and the reference's, and the axis's pieces they rest on.

- Blocks: one ``mamba2._block`` of the smoke mamba2 (8 heads over one
  group: the heads split, B and C whole on both ranks) and of a variant
  with 2 groups (the groups split too), and one ``griffin._rec_block``
  and ``_attn_block`` of the smoke griffin (the recurrent width and the
  MLP split; 4 heads over 1 KV head: the attention whole on each rank),
  each block's output and the gradients of <output, probe> (its input's,
  each weight piece's) against the unsplit block's, f32, within 2e-5
  (tests/test_kernels.py:12).
- Losses: ``loss_fn`` of each (the vocab-parallel embedding, head and
  cross entropy over the padded vocab, 257 of 512 columns; griffin's
  softcap and its loss in chunks of 8 positions) with every gradient,
  under ``cfg.remat``, against the unsplit loss within 2e-5 and against
  the reference's ``loss_fn`` and ``jax.grad`` on the same weights
  within 2e-5 (the gradients of each leaf's largest); the recompute
  issues no collective (as many transport calls as with no checkpoint
  at all).
- The axis's pieces: ``gather_rs``'s gradient is the reduce-scatter of
  the whole's (every rank's split computation reads all of it), not the
  rank's slice; a ``Segmented`` leaf to its compute piece and back, from
  storage split on the same dim, another dim or none, bit for bit, the
  whole segments taken from rank 0; the round step's gradient norm over
  the axis (``round._tensor_norm2``) with B and C's whole segments
  counted once, against the unsplit norm.
"""
import importlib.util

import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world

# the ranks import this module: nothing of JAX at its top
pytestmark = pytest.mark.skipif(importlib.util.find_spec("jax") is None,
                                reason="the reference needs jax")
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 32
LOSS_CHUNK = 8  # griffin's loss in 4 chunks of the 31 positions
VARIANTS = {"mamba2": ("mamba2_1p3b", {}),
            "mamba2 groups split": ("mamba2_1p3b", dict(ssm_groups=2)),
            "griffin": ("recurrentgemma_9b", {})}
# a segmented leaf (4, 6, 24): [8 | 8 | 3 | 3 | 2] on dim 2, the 3s whole
SEG_SHAPE = (4, 6, 24)
SEG_SIZES = (8, 8, 3, 3, 2)
SEG_WHOLE = (False, False, True, True, False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(variant, **kw):
    from repro_torch.configs import get_config, smoke_model
    arch, extra = VARIANTS[variant]
    return smoke_model(get_config(arch).model).replace(**extra, **kw)


def block_kinds(variant):
    """(kind, stack) of the blocks held: mamba2's one, griffin's two."""
    if variant == "griffin":
        return (("rglru", "rec_layers"), ("attn", "attn_layers"))
    return (("ssm", "layers"),)


def run_block(cfg, kind, w, x, probe, tp=None):
    """A block's output and the gradients of <output, probe> with respect
    to its input and to each weight (name -> tensor)."""
    from repro_torch.models import griffin, lm, mamba2
    w = {k: v.detach().clone().requires_grad_() for k, v in w.items()}
    x = x.clone().requires_grad_()
    if kind == "ssm":
        y = mamba2._block(cfg, x, w, tp)
    else:
        fn = griffin._rec_block if kind == "rglru" else griffin._attn_block
        y = fn(cfg, x, w, lm._rope_tables(cfg, torch.arange(S)), tp)
    grads = torch.autograd.grad((y * probe).sum(), [x] + list(w.values()))
    return y.detach(), grads[0], dict(zip(w, grads[1:]))


def run_loss(cfg, flat, tokens, tp=None):
    from repro_torch.models.registry import get_model
    from repro_torch.tree import unflatten
    flat = {k: v.detach().clone().requires_grad_() for k, v in flat.items()}
    loss = get_model(cfg).loss_fn(cfg, unflatten(flat), {"tokens": tokens},
                                  tp=tp)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()))))


def compute_piece(cfg, k, v, n, i, layer=False):
    """Rank i's compute piece of leaf ``k`` (``layer``: one layer's
    slice of a stacked leaf)."""
    from repro_torch.dist.tensor import piece, shift
    from repro_torch.models.registry import get_model
    spec = get_model(cfg).tensor_dims(cfg, n)[k]
    return piece(v, shift(spec, -1) if layer else spec, n, i).contiguous()


def inputs(params_np, variant, seed):
    """The variant's weights (the reference's, as tensors), a block input
    and probe, and a token batch."""
    from repro_torch.convert import params_from_jax
    cfg = port_cfg(variant)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    probe = torch.randn((B, S, cfg.d_model), generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    return params_from_jax(params_np[variant], "cpu"), x, probe, tokens


class _NoRecompute:
    """``torch.utils.checkpoint.checkpoint`` as a plain call: no forward
    runs again, so the transport calls it leaves are the baseline."""

    def __call__(self, fn, *args, **kwargs):
        return fn(*args)


def recurrent_rank(mesh, params_np):
    """Each variant's blocks and loss on this rank of the model axis, and
    the axis's pieces."""
    from repro_torch.core.round import _tensor_norm2
    from repro_torch.dist.tensor import tensor_axis
    from repro_torch.models import griffin, mamba2
    from repro_torch.models.registry import get_model
    from repro_torch.tree import flatten
    ax = tensor_axis(mesh)
    n, me = ax.size, ax.index
    griffin.LOSS_CHUNK = LOSS_CHUNK
    out = {}
    for variant in VARIANTS:
        cfg = port_cfg(variant)
        params, x, probe, tokens = inputs(params_np, variant, 3)
        for kind, stack in block_kinds(variant):
            w = {k: compute_piece(cfg, f"{stack}/{k}", v[0], n, me, True)
                 for k, v in params[stack].items()}
            out[variant, kind] = run_block(cfg, kind, w, x, probe, ax)
        flat = {k: compute_piece(cfg, k, v, n, me)
                for k, v in flatten(params).items()}
        model = get_model(cfg)
        real = model.checkpoint
        model.checkpoint = _NoRecompute()
        mesh.reset_stats()
        run_loss(cfg.replace(remat=True), flat, tokens, ax)
        baseline = mesh.stats["calls"]
        model.checkpoint = real
        mesh.reset_stats()
        loss, grads = run_loss(cfg.replace(remat=True), flat, tokens, ax)
        out[variant, "calls"] = (baseline, mesh.stats["calls"])
        out[variant, "loss"] = (loss, grads)
        if variant == "mamba2":
            dims = model.tensor_dims(cfg, n)
            out["norm2"] = float(_tensor_norm2(
                list(grads.values()), [dims[k] for k in grads], ax))
    # gather_rs: a split computation reading all of the gathered tensor,
    # each rank with its own weights
    _, x, probe, _ = inputs(params_np, "mamba2", 4)
    xi = ax.piece(x, 2).clone().requires_grad_()
    y = ax.gather_rs(xi * (me + 1.0), 2)
    out["gather_rs"] = torch.autograd.grad((y * probe * (me + 1.0)).sum(),
                                           xi)[0]
    out["segmented"] = segmented_round_trip(ax)
    del mamba2
    return me, out


def segmented_leaf():
    from repro_torch.dist.tensor import Segmented
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(SEG_SHAPE, generator=gen).to(torch.bfloat16)
    return x, Segmented(2, SEG_SIZES, SEG_WHOLE)


def segmented_round_trip(ax):
    """For each storage split (None, dims 0-2): (the compute piece
    ``to_compute`` made, the storage piece ``to_storage`` made back from
    it after rank 1 changed its whole segments)."""
    from repro_torch.dist.tensor import piece, segments, to_compute, \
        to_storage
    x, spec = segmented_leaf()
    out = {}
    for s in (None, 0, 1, 2):
        mine = piece(x, s, ax.size, ax.index).clone()
        comp = to_compute(mine, s, spec, ax)
        got = comp.clone()
        if ax.index == 1:
            for v, whole in segments(comp, spec, ax.size):
                if whole:
                    v.add_(100.0)
        back = torch.full_like(mine, float("nan"))
        to_storage(comp, s, spec, ax, back)
        out[s] = (got, back)
    return out


def _reference(variant):
    """The reference's weights (numpy), and its loss and ``jax.grad`` on
    each variant's token batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.models.registry import get_model as j_get_model
    arch, extra = VARIANTS[variant]
    jcfg = j_smoke(j_get_config(arch).model).replace(**extra)
    jm = j_get_model(jcfg)
    params = jax.jit(jm.init, static_argnums=0)(jcfg, jax.random.PRNGKey(1))
    return jcfg, jm, jax.tree.map(np.asarray, params), jnp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's weights, loss and gradients of each variant; the
    world's results."""
    import jax
    want, params_np = {}, {}
    for variant in VARIANTS:
        jcfg, jm, params, jnp = _reference(variant)
        params_np[variant] = params
        tokens = inputs({variant: params}, variant, 3)[3].numpy()
        loss, grads = jax.jit(jax.value_and_grad(lambda p, t: jm.loss_fn(
            jcfg, p, {"tokens": t})))(params, jnp.asarray(tokens))
        want[variant] = (float(loss), {
            "/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]})
    world = run_world(recurrent_rank, 2, params_np, shape=(1, 2),
                      device="cpu", timeout_s=240,
                      root=tmp_path_factory.mktemp("world"))
    return want, params_np, world


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_blocks_match_unsplit(runs, variant):
    from repro_torch.models.registry import get_model
    _, params_np, world = runs
    cfg = port_cfg(variant)
    dims = get_model(cfg).tensor_dims(cfg, 2)
    params, x, probe, _ = inputs(params_np, variant, 3)
    for kind, stack in block_kinds(variant):
        w = {k: v[0] for k, v in params[stack].items()}
        y, dx, dw = run_block(cfg, kind, w, x, probe)
        split = {k for k in w if dims[f"{stack}/{k}"] is not None}
        assert split, (variant, kind)
        for index, out in world:
            gy, gdx, gdw = out[variant, kind]
            np.testing.assert_allclose(gy, y, **TOL)
            np.testing.assert_allclose(gdx, dx, **TOL)
            for k, g in dw.items():
                np.testing.assert_allclose(
                    gdw[k], compute_piece(cfg, f"{stack}/{k}", g, 2, index,
                                          True),
                    err_msg=f"{kind} {k}", **TOL)


def test_split_choices():
    """The smoke mamba2 splits its heads but not its one group; the
    groups variant both; griffin its width, its MLP and its vocab, not
    its one KV head."""
    from repro_torch.dist.tensor import Segmented
    from repro_torch.models import griffin, mamba2
    one = mamba2.tensor_dims(port_cfg("mamba2"), 2)
    two = mamba2.tensor_dims(port_cfg("mamba2 groups split"), 2)
    assert isinstance(one["layers/w_in"], Segmented)
    assert one["layers/w_in"].whole == (False, False, True, True, False)
    assert two["layers/w_in"].whole == (False,) * 5
    assert one["layers/w_out"] == 1 and one["layers/ln"] is None
    assert one["emb"] == 0 and one["final_norm"] is None
    g = griffin.tensor_dims(port_cfg("griffin"), 2)
    assert g["rec_layers/wa"] == 2 and g["rec_layers/w_out"] == 1
    assert g["attn_layers/wq"] is None and g["attn_layers/w_down"] == 1
    # n not dividing the heads: the blocks whole on every rank
    assert all(v is None for k, v in mamba2.tensor_dims(
        port_cfg("mamba2"), 3).items() if k.startswith("layers/"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_matches_unsplit_and_reference(runs, variant):
    want, params_np, world = runs
    jloss, jgrads = want[variant]
    cfg = port_cfg(variant, remat=True)
    assert cfg.vocab_padded == 512 and cfg.vocab_size == 257
    params, _, _, tokens = inputs(params_np, variant, 3)
    from repro_torch.models import griffin
    from repro_torch.tree import flatten
    chunk = griffin.LOSS_CHUNK
    griffin.LOSS_CHUNK = LOSS_CHUNK
    try:
        loss, grads = run_loss(cfg, flatten(params), tokens)
    finally:
        griffin.LOSS_CHUNK = chunk
    assert abs(float(loss) - jloss) < TOL["atol"]
    for index, out in world:
        gl, gg = out[variant, "loss"]
        assert abs(float(gl) - float(loss)) < TOL["atol"]
        assert abs(float(gl) - jloss) < TOL["atol"]
        for k, g in grads.items():
            mine = compute_piece(cfg, k, g, 2, index)
            np.testing.assert_allclose(gg[k], mine, err_msg=k, **TOL)
            ref = compute_piece(cfg, k, torch.from_numpy(jgrads[k]), 2,
                                index)
            scale = float(np.abs(jgrads[k]).max())
            np.testing.assert_allclose(gg[k], ref, rtol=0,
                                       atol=TOL["atol"] * max(scale, 1.0),
                                       err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_recompute_issues_no_collective(runs, variant):
    for _, out in runs[2]:
        baseline, remat = out[variant, "calls"]
        assert remat == baseline > 0


def test_gather_rs_backward_is_a_reduce_scatter(runs):
    """y = gather_rs(x_i (i + 1)) read by each rank i with its own weight
    probe (i + 1): d/dx_i of the sum over ranks is (i + 1) times the sum
    of the ranks' weights on i's columns, on every rank."""
    _, params_np, world = runs
    _, x, probe, _ = inputs(params_np, "mamba2", 4)
    total = probe * (1.0 + 2.0)
    for index, out in world:
        want = (index + 1.0) * total[..., index * 32:(index + 1) * 32]
        np.testing.assert_allclose(out["gather_rs"], want, **TOL)


@pytest.mark.parametrize("storage", [None, 0, 1, 2])
def test_segmented_round_trip_bit_for_bit(runs, storage):
    from repro_torch.dist.tensor import piece
    x, spec = segmented_leaf()
    for index, out in runs[2]:
        comp, back = out["segmented"][storage]
        assert torch.equal(comp, piece(x, spec, 2, index))
        assert comp.shape[2] == 8 // 2 * 2 + 3 + 3 + 1
        assert torch.equal(back, piece(x, storage, 2, index))


def test_gradient_norm_counts_whole_segments_once(runs):
    from repro_torch.core.round import _global_norm2
    want, params_np, world = runs
    cfg = port_cfg("mamba2", remat=True)
    params, _, _, tokens = inputs(params_np, "mamba2", 3)
    from repro_torch.tree import flatten
    _, grads = run_loss(cfg, flatten(params), tokens)
    full = float(_global_norm2(list(grads.values())))
    for _, out in world:
        assert abs(out["norm2"] - full) <= 2e-5 * full
