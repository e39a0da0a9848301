"""internvl2-2b's ViT stub and seamless-m4t-large-v2's encoder-decoder on
the tensor ("model") axis, on the CPU: their blocks, encoder,
cross-attention and losses computed over a 2-rank gloo world against the
port's unsplit ones, and the split dims of every leaf.

- ``lm.tensor_dims`` against ``lm.init``'s leaves for both configs at
  full width, on model axes of 2, 3, 4 and 16 ranks: one entry a leaf,
  a split dim only where n divides it, the heads (the decoder's, the
  encoder's and the cross-attention's) where n divides H and KH, the FFN
  hidden where it divides F, the vocab where it divides the padded vocab,
  the norms whole.
- The smoke configs (f32; internvl2-2b 4 heads over 2 KV heads of 16,
  8 patch positions; seamless-m4t-large-v2 4 over 4, 2 encoder and 2
  decoder layers, 9 decoder positions over 12 frames), each rank with its
  compute pieces, against the unsplit port within 2e-5
  (tests/test_kernels.py:12): internvl's decoder block; seamless's
  encoder (``lm._encode``: its output and the gradients of <output,
  probe> for the frames and every encoder leaf), one cross-attention
  alone and a decoder block with it (the gradients of its input, of the
  encoder output and of each weight piece); and ``loss_fn`` under
  ``cfg.remat`` (internvl's with the patch positions' labels masked,
  seamless's with the encoder) with the gradient of every leaf, the
  encoder's included: each layer's cross K and V read only the rank's
  heads of the encoder output, so its gradient is whole only after the
  sum over the axis that ``forward``'s ``tp.copy`` of it gives.
And the round step's check that the model ranks of a data rank were
given the same chaos masks raises on both ranks where they were not.
One world of 2 ranks runs every case; torch on one thread.
"""
import numpy as np
import pytest
import torch

from repro_torch.dist.mesh import run_world

# the ranks import this module: nothing of JAX at its top
TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ("internvl2_2b", "seamless_m4t_large_v2")
MODEL_SIZES = (2, 3, 4, 16)
B, S, S_ENC = 2, 9, 12
CROSS = ("wxk", "wxo", "wxq", "wxv")  # a cross-attention's weights


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_cfg(arch, **kw):
    from repro_torch.configs import get_config, smoke_model
    return smoke_model(get_config(arch).model).replace(**kw)


def inputs(arch, seed):
    """The smoke model's weights (``lm.init``), a block input, the
    encoder output's stand-in and probes, and a batch, all from ``seed``."""
    from repro_torch.models import lm
    cfg = smoke_cfg(arch)
    gen = torch.Generator().manual_seed(seed)
    params = lm.init(cfg, gen, device="cpu")
    D = cfg.d_model
    x = torch.randn((B, S, D), generator=gen)
    mem = torch.randn((B, S_ENC, D), generator=gen)
    probe = torch.randn((B, S, D), generator=gen)
    mem_probe = torch.randn((B, S_ENC, D), generator=gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.frontend == "vit_stub":
        batch["patch_embeds"] = torch.randn(
            (B, cfg.frontend_tokens, D), generator=gen)
    if cfg.enc_layers:
        batch["frames"] = torch.randn((B, S_ENC, D), generator=gen)
    return params, x, mem, probe, mem_probe, batch


def compute_piece(cfg, k, v, n, i, layer=False):
    """Rank i's compute piece of leaf ``k`` (``layer``: one layer's slice
    of a stacked leaf)."""
    from repro_torch.dist.tensor import piece, shift
    from repro_torch.models import lm
    spec = lm.tensor_dims(cfg, n)[k]
    return piece(v, shift(spec, -1) if layer else spec, n, i).contiguous()


def _leaves(w):
    return {k: v.detach().clone().requires_grad_() for k, v in w.items()}


def run_block(cfg, w, x, probe, mem=None, mem_probe=None, tp=None):
    """A decoder block's output (with ``mem``, its cross-attention over
    it, after ``tp.copy`` as ``forward`` does) and the gradients of
    <output, probe> for its input, ``mem`` and each weight."""
    from repro_torch.models import lm
    w = _leaves(w)
    x = x.clone().requires_grad_()
    ins = [x]
    m = None
    if mem is not None:
        m = mem.clone().requires_grad_()
        ins.append(m)
        if tp is not None:
            m = tp.copy(m)
    y = lm._block(cfg, x, w, lm._rope_tables(cfg, torch.arange(S)), m,
                  tp=tp)
    grads = torch.autograd.grad((y * probe).sum(), ins + list(w.values()))
    return y.detach(), grads[:len(ins)], dict(zip(w, grads[len(ins):]))


def run_cross(cfg, w, x, mem, probe, tp=None):
    """One cross-attention alone (``_cross_kv`` of ``mem``, then
    ``_cross_attention`` of x) and the gradients of <output, probe>."""
    from repro_torch.models import lm
    w = _leaves({k: w[k] for k in CROSS})
    x, mem = x.clone().requires_grad_(), mem.clone().requires_grad_()
    m = mem if tp is None else tp.copy(mem)
    y = lm._cross_attention(cfg, x, w, lm._cross_kv(cfg, m, w), tp)
    grads = torch.autograd.grad((y * probe).sum(),
                                [x, mem] + list(w.values()))
    return y.detach(), grads[:2], dict(zip(w, grads[2:]))


def run_encoder(cfg, enc, frames, probe, tp=None):
    """``lm._encode`` and the gradients of <output, probe> for the frames
    and each encoder leaf (flat names)."""
    from repro_torch.models import lm
    from repro_torch.tree import unflatten
    enc = _leaves(enc)
    frames = frames.clone().requires_grad_()
    y = lm._encode(cfg, unflatten(enc), frames, tp)
    grads = torch.autograd.grad((y * probe).sum(),
                                [frames] + list(enc.values()))
    return y.detach(), grads[0], dict(zip(enc, grads[1:]))


def run_loss(cfg, flat, batch, tp=None):
    from repro_torch.models import lm
    from repro_torch.tree import unflatten
    flat = _leaves(flat)
    loss = lm.loss_fn(cfg, unflatten(flat), batch, tp=tp)
    return loss.detach(), dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()))))


def _encoder_leaves(flat):
    return {k: v for k, v in flat.items()
            if k.startswith("enc_layers/") or k == "enc_norm"}


def multimodal_rank(mesh):
    """Every case on this rank of the model axis."""
    from repro_torch.dist.tensor import tensor_axis
    from repro_torch.tree import flatten
    ax = tensor_axis(mesh)
    n, me = ax.size, ax.index
    out = {}
    for arch in ARCHS:
        cfg = smoke_cfg(arch)
        params, x, mem, probe, mem_probe, batch = inputs(arch, 3)
        w = {k: compute_piece(cfg, f"layers/{k}", v[0], n, me, True)
             for k, v in params["layers"].items()}
        flat = {k: compute_piece(cfg, k, v, n, me)
                for k, v in flatten(params).items()}
        if cfg.enc_layers:
            out[arch, "block"] = run_block(cfg, w, x, probe, mem, mem_probe,
                                           ax)
            out[arch, "cross"] = run_cross(cfg, w, x, mem, probe, ax)
            out[arch, "encoder"] = run_encoder(
                cfg, _encoder_leaves(flat), batch["frames"], mem_probe, ax)
        else:
            out[arch, "block"] = run_block(cfg, w, x, probe, tp=ax)
        out[arch, "loss"] = run_loss(cfg.replace(remat=True), flat, batch,
                                     ax)
    out["masks"] = masks_checked(mesh, me)
    return me, out


def masks_checked(mesh, me):
    """The round step's check that the model ranks were given the same
    chaos masks: silent on equal ones, then given rank-dependent ones,
    the error it raises (None where it raised nothing)."""
    from repro_torch.configs.base import FLTopology
    from repro_torch.core.round import _same_masks_on_axis
    from repro_torch.dist.policies import make_train_policy
    policy = make_train_policy(mesh, FLTopology(2, 1), dp_axes=("data",))
    alive, conn = np.ones(2, np.float32), np.ones(2, np.float32)
    _same_masks_on_axis(policy, alive, alive / 2, conn)
    try:
        _same_masks_on_axis(policy, alive, alive / 2, conn * me)
    except ValueError as e:
        return str(e)
    return None


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(multimodal_rank, 2, shape=(1, 2), device="cpu",
                     timeout_s=240, root=tmp_path_factory.mktemp("world"))


def _close_pieces(cfg, got, want, n, index, prefix="", layer=False):
    for k, g in want.items():
        np.testing.assert_allclose(
            got[k], compute_piece(cfg, prefix + k, g, n, index, layer),
            err_msg=k, **TOL)


def test_model_ranks_with_other_masks_raise(world):
    for _, out in world:
        assert "different chaos masks" in out["masks"]


@pytest.mark.parametrize("n", MODEL_SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_dims_cover_init(arch, n):
    """One split dim (or None) a leaf of the full-width config, dividing
    it; the heads, FFN and vocab split where n divides them."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.tree import flatten
    cfg = get_config(arch).model
    shapes = {k: tuple(v.shape)
              for k, v in flatten(lm.init(cfg, device="meta")).items()}
    dims = lm.tensor_dims(cfg, n)
    assert sorted(dims) == sorted(shapes)
    heads = cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0
    ffn, vocab = cfg.d_ff % n == 0, cfg.vocab_padded % n == 0
    want = {"wq": heads, "wk": heads, "wv": heads, "wo": heads,
            "wxq": heads, "wxk": heads, "wxv": heads, "wxo": heads,
            "w_gate": ffn, "w_up": ffn, "w_down": ffn}
    for k, d in dims.items():
        name = k.split("/")[-1]
        if d is not None:
            assert shapes[k][d] % n == 0, (k, d, shapes[k])
        if name.startswith("ln") or name.endswith("norm"):
            assert d is None, k
        elif name in ("emb", "out_head"):
            assert (d is not None) == vocab, k
        else:
            assert (d is not None) == want[name], k
    if cfg.enc_layers:
        assert {k for k in dims if k.startswith("enc_layers/")} == {
            "enc_layers/" + k for k in lm._layer_shapes(cfg)}
        assert dims["enc_norm"] is None
        if n == 2:
            assert (dims["layers/wxk"], dims["layers/wxo"],
                    dims["enc_layers/wq"], dims["enc_layers/w_down"]) == \
                (2, 1, 2, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_matches_unsplit(world, arch):
    """internvl's decoder block; seamless's with its cross-attention over
    the encoder output (whose gradient each rank holds whole)."""
    cfg = smoke_cfg(arch)
    params, x, mem, probe, mem_probe, _ = inputs(arch, 3)
    w = {k: v[0] for k, v in params["layers"].items()}
    y, dins, dw = run_block(cfg, w, x, probe,
                            mem if cfg.enc_layers else None, mem_probe)
    assert len(dins) == (2 if cfg.enc_layers else 1)
    for index, out in world:
        gy, gins, gdw = out[arch, "block"]
        np.testing.assert_allclose(gy, y, **TOL)
        for g, d in zip(gins, dins):
            np.testing.assert_allclose(g, d, **TOL)
        _close_pieces(cfg, gdw, dw, 2, index, "layers/", layer=True)


def test_cross_attention_matches_unsplit(world):
    arch = "seamless_m4t_large_v2"
    cfg = smoke_cfg(arch)
    params, x, mem, probe, _, _ = inputs(arch, 3)
    w = {k: v[0] for k, v in params["layers"].items()}
    y, (dx, dmem), dw = run_cross(cfg, w, x, mem, probe)
    assert sorted(dw) == sorted(CROSS)
    assert all(float(v.abs().max()) > 0 for v in dw.values())
    for index, out in world:
        gy, (gdx, gdmem), gdw = out[arch, "cross"]
        np.testing.assert_allclose(gy, y, **TOL)
        np.testing.assert_allclose(gdx, dx, **TOL)
        np.testing.assert_allclose(gdmem, dmem, **TOL)
        _close_pieces(cfg, gdw, dw, 2, index, "layers/", layer=True)


def test_encoder_matches_unsplit(world):
    from repro_torch.tree import flatten
    arch = "seamless_m4t_large_v2"
    cfg = smoke_cfg(arch)
    params, _, _, _, mem_probe, batch = inputs(arch, 3)
    enc = _encoder_leaves(flatten(params))
    y, dframes, denc = run_encoder(cfg, enc, batch["frames"], mem_probe)
    for index, out in world:
        gy, gframes, genc = out[arch, "encoder"]
        np.testing.assert_allclose(gy, y, **TOL)
        np.testing.assert_allclose(gframes, dframes, **TOL)
        _close_pieces(cfg, genc, denc, 2, index)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_unsplit(world, arch):
    """The loss (the patch positions' labels masked for internvl) and the
    gradient of every leaf, the encoder's included, under remat."""
    from repro_torch.tree import flatten
    cfg = smoke_cfg(arch, remat=True)
    assert cfg.vocab_padded == 512 and cfg.vocab_size == 257
    params, _, _, _, _, batch = inputs(arch, 3)
    loss, grads = run_loss(cfg, flatten(params), batch)
    assert ("patch_embeds" in batch) == (cfg.frontend == "vit_stub")
    assert any(k.startswith("enc_layers/") for k in grads) == \
        bool(cfg.enc_layers)
    for index, out in world:
        gl, gg = out[arch, "loss"]
        assert abs(float(gl) - float(loss)) < TOL["atol"]
        assert sorted(gg) == sorted(grads)
        _close_pieces(cfg, gg, grads, 2, index)
