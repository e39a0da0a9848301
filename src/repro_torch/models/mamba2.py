"""Mamba2 (SSD), the attention-free ``ssm`` family: init, forward and loss
(port of ``repro/models/mamba2.py:23-126``).  [arXiv:2405.21060]

Block: in_proj -> [z | xBC | dt]; causal depthwise conv over xBC; the SSD
scan (``ops.ssd``: the hand-written kernels on the card, forward and
backward); gated RMSNorm; out_proj.  Parameters are a plain dict with the
reference's leaf names and shapes, layers stacked on a leading L dim.  The
reference's ``lax.scan`` over layers is a Python loop; ``params["layers"]``
may also be a list of per-layer dicts (the round step differentiates with
respect to each layer's slices, so that no stacked gradient is formed).
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``: its
forward runs again in the backward, as ``jax.checkpoint`` does.

On a tensor ("model") axis (``tp``, a ``dist.tensor.TensorAxis``)
``forward`` and ``loss_fn`` split the work where the reference's
activation constraints put it (``xs`` to "ssm_x", mamba2.py:97): each
rank takes H / n heads (their z, x and dt columns of ``w_in``, x conv
channels, ``dt_bias``, ``A_log``, ``D_skip``, ``norm_w`` and ``w_out``
rows) and G / n groups of B and C where n divides G; where it does not
(one group), B and C are whole on every rank, their ``w_in`` columns and
conv channels entering through ``copy_whole``, so that their gradient is
the axis's sum.  The scan (``ops.ssd``: the kernels on the card) runs on
the rank's heads and groups; the gated norm reduces its sum of squares
over the whole d_inner (``rms_norm_split``); ``w_out``'s partial sums
are reduced.  The embedding, the tied head and the cross entropy are the
dense LM's vocab-parallel ones (``lm._embed``, ``lm._logits``), the
padded columns masked by their global index; ``ln`` and ``final_norm``
are whole.  Where n does not divide H (or G > 1 is not split by it) the
blocks run whole on every rank.  ``tensor_dims`` says where each leaf is
computed; without ``tp`` nothing changes.

Serving (reference :129-222): ``init_cache`` holds each layer's conv
window (the last conv_width - 1 pre-conv inputs) and its f32 SSM state,
O(1) in the sequence length.  ``prefill`` runs the chunked scan's plain
version, ``ref.ssd_chunked``, for y and the final state, as the
reference calls ``ssd_chunked_jnp`` there and not its Pallas kernel (the
forward kernel keeps no final state); ``decode_step`` advances both
states by one token (``ref.ssd_decode_step``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist.tensor import Segmented, shift
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       layer_list, mask_padded_logits,
                                       rms_norm, rms_norm_split,
                                       seeded_generator)


def _splits_heads(cfg: ModelConfig, n: int) -> bool:
    """Whether a model axis of n ranks splits the heads: n divides H, and
    G too unless G is 1 (a rank's heads then read the one group)."""
    G = cfg.ssm_groups
    return n > 1 and cfg.ssm_heads % n == 0 and (G % n == 0 or G == 1)


def _dims(cfg: ModelConfig, n: int = 1):
    """(Din, G, N, H, conv_ch) of one rank's piece on a model axis of n
    ranks that splits the heads (n 1: the whole model's): Din and H over
    n, G over n where n divides it (else every rank all G)."""
    Din, H = cfg.d_inner // n, cfg.ssm_heads // n
    G, N = cfg.ssm_groups, cfg.ssm_state
    if G % n == 0:
        G //= n
    return Din, G, N, H, Din + 2 * G * N


def _segments(cfg: ModelConfig, n: int):
    """(w_in's, the conv's) ``Segmented`` splits of one layer's leaves on
    their last dim: [z | x | B | C | dt] and [x | B | C], B and C whole
    where n does not divide G."""
    Din, G, N, H, _ = _dims(cfg)
    bc = G % n != 0
    return (Segmented(1, (Din, Din, G * N, G * N, H),
                      (False, False, bc, bc, False)),
            Segmented(1, (Din, G * N, G * N), (False, bc, bc)))


def tensor_dims(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    """Where mamba2 computes each leaf on a model axis of ``n`` ranks:
    {flat leaf name: the split of the unstacked leaf (a layer leaf's
    counts its L dim), or None where every rank computes it whole}: the
    heads' columns (``_segments`` for ``w_in`` and the conv), ``dt_bias``,
    ``A_log``, ``D_skip``, ``norm_w``, ``w_out``'s rows; the vocab;
    ``ln`` and ``final_norm`` whole."""
    vocab = lm._splits(cfg, n)[lm.VOCAB]
    dims = {"emb": 0 if vocab else None, "final_norm": None}
    if not cfg.tie_embeddings:
        dims["out_head"] = 1 if vocab else None
    split = {}
    if _splits_heads(cfg, n):
        w_in, conv = _segments(cfg, n)
        split = {"w_in": shift(w_in, 1), "conv_w": shift(conv, 1),
                 "conv_b": conv, "dt_bias": 1, "A_log": 1, "D_skip": 1,
                 "norm_w": 1, "w_out": 1}
    for name in ("ln", "w_in", "conv_w", "conv_b", "dt_bias", "A_log",
                 "D_skip", "norm_w", "w_out"):
        dims["layers/" + name] = split.get(name)
    return dims


def init(cfg: ModelConfig, generator: torch.Generator = None, *, seed=0,
         device=None) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (or one seeded with ``seed``
    on ``device``), with the reference's names, shapes, types and scales.
    The draws differ from ``jax.random``'s; tests carry the reference's
    weights over with ``convert.params_from_jax``."""
    dev = resolve(device)
    if generator is None:
        generator = seeded_generator(dev, seed)
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    D, L = cfg.d_model, cfg.num_layers
    Din, G, N, H, conv_ch = _dims(cfg)
    proj_in = Din + conv_ch + H  # z, xBC, dt
    draw = functools.partial(dense_init, generator, device=dev)
    full = lambda shape, v, dtype: torch.full(shape, v, dtype=dtype,
                                              device=dev)
    w_in = draw((L, D, proj_in), dt)
    conv_w = draw((L, cfg.conv_width, conv_ch), dt, scale=0.1)
    w_out = draw((L, Din, D), dt)
    layers = {
        "ln": full((L, D), 1.0, dt),
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": full((L, conv_ch), 0.0, dt),
        "dt_bias": full((L, H), 0.0, f32),
        "A_log": full((L, H), 0.0, f32),  # A = -exp(A_log) = -1
        "D_skip": full((L, H), 1.0, f32),
        "norm_w": full((L, Din), 1.0, dt),
        "w_out": w_out,
    }
    params = {
        "emb": draw((cfg.vocab_padded, D), dt),
        "final_norm": full((D,), 1.0, dt),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["out_head"] = draw((D, cfg.vocab_padded), dt)
    return params


def _conv1d(x, w, b):
    """Causal depthwise conv. x: (B, S, C); w: (K, C); b: (C,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, :S] * w[0][None, None, :]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i][None, None, :]
    return out + b[None, None, :]


def _split_proj(cfg, proj, n=1):
    Din, G, N, H, conv_ch = _dims(cfg, n)
    return (proj[..., :Din], proj[..., Din:Din + conv_ch],
            proj[..., Din + conv_ch:])


def _split_xbc(cfg, xBC, n=1):
    """The conv's output (..., conv_ch) -> xs (..., H, P), B and C (...,
    G, N) (a rank's, on a model axis of n ranks)."""
    Din, G, N, H, conv_ch = _dims(cfg, n)
    lead = xBC.shape[:-1]
    return (xBC[..., :Din].reshape(*lead, H, cfg.ssm_head_dim),
            xBC[..., Din:Din + G * N].reshape(*lead, G, N),
            xBC[..., Din + G * N:].reshape(*lead, G, N))


def _block_core(cfg, h, w, n=1):
    """Projection, conv and split. h: (B, S, D).  Returns (z, xs, B, C,
    dt, the conv's input xBC), a rank's on a model axis of n ranks."""
    cd = dtype_of(cfg.compute_dtype)
    z, xBC, dt_raw = _split_proj(cfg, (h @ w["w_in"]).to(cd), n)
    conv = F.silu(_conv1d(xBC, w["conv_w"], w["conv_b"]).float()).to(cd)
    dt = F.softplus(dt_raw.float() + w["dt_bias"])
    return (z, *_split_xbc(cfg, conv, n), dt, xBC)


def _gated_out(cfg, x, y, xs, z, w, tp=None):
    """x + out_proj(rms_norm((y + D xs) silu(z))): the block's output
    from the scan's y (..., H, P); with ``tp`` splitting the heads, the
    norm over the axis's whole d_inner and out_proj's partial sums
    reduced."""
    cd = dtype_of(cfg.compute_dtype)
    y = y + xs * w["D_skip"][:, None].to(cd)
    y = y.reshape(*x.shape[:2], -1)
    y = y * F.silu(z.float()).to(cd)
    if tp is None:
        return x + rms_norm(y, w["norm_w"], cfg.norm_eps) @ w["w_out"]
    y = rms_norm_split(y, w["norm_w"], cfg.norm_eps, tp, cfg.d_inner)
    return x + tp.reduce(y @ w["w_out"])


def _block(cfg, x, w, tp=None):
    h = rms_norm(x, w["ln"], cfg.norm_eps)
    if tp is not None and not _splits_heads(cfg, tp.size):
        tp = None  # the block whole on every rank
    n = 1
    if tp is not None:
        n = tp.size
        w_in, conv = _segments(cfg, n)
        h = tp.copy(h)
        w = dict(w, w_in=tp.copy_whole(w["w_in"], w_in),
                 conv_w=tp.copy_whole(w["conv_w"], conv),
                 conv_b=tp.copy_whole(w["conv_b"], shift(conv, -1)))
    z, xs, Bm, Cm, dt, _ = _block_core(cfg, h, w, n)
    A = -torch.exp(w["A_log"])
    y = ops.ssd(xs, dt, A, Bm, Cm, chunk=cfg.ssm_chunk)
    return _gated_out(cfg, x, y, xs, z, w, tp)


def _head(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["emb"].T if cfg.tie_embeddings else params["out_head"]
    return mask_padded_logits(cfg, x @ head.to(x.dtype))


def forward(cfg: ModelConfig, params, batch, tp=None):
    """Logits (B, S, vocab_padded) of ``batch["tokens"]`` (B, S); on a
    tensor axis ``tp`` (``params`` the rank's compute pieces) the rank's
    vocab columns where it splits the vocab."""
    if tp is None:
        x = params["emb"][batch["tokens"].long()].to(
            dtype_of(cfg.compute_dtype))
    else:
        x = lm._embed(cfg, params, batch, tp)
    block = functools.partial(_block, cfg, tp=tp)
    kw = {} if tp is None else dict(context_fn=tp.checkpoint_context)
    for w in layer_list(params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, use_reentrant=False,
                           preserve_rng_state=False, **kw)
        else:
            x = block(x, w)
    return _head(cfg, params, x) if tp is None else \
        lm._logits(cfg, params, x, tp)


def loss_fn(cfg: ModelConfig, params, batch, tp=None):
    """Mean next-token cross entropy; ``tp``: as ``forward``'s, the same
    loss on every rank of the axis."""
    logits = forward(cfg, params, batch, tp)
    vocab = tp is not None and lm._splits(cfg, tp.size)[lm.VOCAB]
    return cross_entropy(logits[:, :-1], batch["tokens"][:, 1:],
                         tp=tp if vocab else None)


# ---------------------------------------------------------------------------
# serving (reference mamba2.py:129-222)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int = 0,
               enc_len: int = 0, device=None):
    """O(1)-size decode state: ``conv`` (L, B, conv_width - 1, conv_ch) in
    the compute type, ``ssm`` (L, B, H, P, N) f32 and ``pos``."""
    dev = resolve(device)
    Din, G, N, H, conv_ch = _dims(cfg)
    L = cfg.num_layers
    return {
        "conv": torch.zeros((L, batch_size, cfg.conv_width - 1, conv_ch),
                            dtype=dtype_of(cfg.compute_dtype), device=dev),
        "ssm": torch.zeros((L, batch_size, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=dev),
        "pos": 0,
    }


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt (B, S); write each layer's conv window (its last
    conv_width - 1 pre-conv inputs) and final SSM state into ``cache`` IN
    PLACE.  Returns (last-position logits (B, 1, V), cache)."""
    S = batch["tokens"].shape[1]
    K = cfg.conv_width
    x = params["emb"][batch["tokens"].long()].to(dtype_of(cfg.compute_dtype))
    for l, w in enumerate(layer_list(params)):
        h = rms_norm(x, w["ln"], cfg.norm_eps)
        z, xs, Bm, Cm, dt, xBC = _block_core(cfg, h, w)
        # the last K - 1 pre-conv inputs; a prompt shorter than that
        # leaves zeros at the window's head
        cache["conv"][l, :, max(0, K - 1 - S):] = xBC[:, -(K - 1):]
        y, cache["ssm"][l] = ref.ssd_chunked(xs, dt, -torch.exp(w["A_log"]),
                                             Bm, Cm, chunk=cfg.ssm_chunk)
        x = _gated_out(cfg, x, y, xs, z, w)
    cache["pos"] = S
    return _head(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One token (B, 1) through every layer's conv window and SSM state,
    both advanced IN PLACE.  Returns (logits (B, 1, V), cache)."""
    cd = dtype_of(cfg.compute_dtype)
    x = params["emb"][tokens.long()].to(cd)  # (B, 1, D)
    for l, w in enumerate(layer_list(params)):
        h = rms_norm(x, w["ln"], cfg.norm_eps)
        z, xBC, dt_raw = _split_proj(cfg, (h @ w["w_in"]).to(cd))
        window = torch.cat([cache["conv"][l], xBC], dim=1)  # (B, K, C)
        conv = torch.einsum("bkc,kc->bc", window.float(),
                            w["conv_w"].float())
        xs, Bm, Cm = _split_xbc(cfg, F.silu(conv + w["conv_b"].float())
                                .to(cd))
        dt = F.softplus(dt_raw[:, 0].float() + w["dt_bias"])
        cache["ssm"][l], y = ref.ssd_decode_step(
            cache["ssm"][l], xs, dt, -torch.exp(w["A_log"]), Bm, Cm)
        cache["conv"][l] = window[:, 1:]
        x = _gated_out(cfg, x, y, xs, z, w)
    cache["pos"] += 1
    return _head(cfg, params, x), cache
