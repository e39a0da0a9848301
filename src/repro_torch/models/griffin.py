"""Griffin / RecurrentGemma, the ``hybrid`` family: RG-LRU recurrent blocks
and local MQA (port of ``repro/models/griffin.py:23-189``).
[arXiv:2402.19427]

The block pattern (("rglru", "rglru", "attn") for recurrentgemma-9b)
repeats ``num_layers // len(pattern)`` times; the remainder layers keep
the pattern's prefix, of which the recurrent blocks run (38 = 12 x 3 + 2
trailing "rglru").  A recurrent block: RMSNorm, a gelu branch y and a
branch x, a causal depthwise conv over x (its taps in the compute type,
in the reference's order), the RG-LRU gates and the log-depth scan
(``ops.rglru``: plain PyTorch on every device, since the reference has
no Pallas kernel for it), y times the scan's output, out projection; then
a gelu-gated MLP.  An attention block is the decoder's
(``lm._attention``, local with ``window=cfg.window``: the hand-written
attention kernels on the card, forward and backward) and the same MLP.

Parameters are a plain dict with the reference's names and shapes:
``emb``, ``final_norm`` and the stacks ``rec_layers`` and ``attn_layers``
(leading dims L_rec and L_attn; ``log_lambda`` f32 at 4.0).  A stack may
also be a list of per-layer dicts (the round step differentiates with
respect to each layer's slices).  With ``cfg.remat`` each block runs under
``torch.utils.checkpoint`` (per layer, where the reference checkpoints a
group and each trailing block): its forward runs again in the backward.

Serving (reference :192-391): ``init_cache`` holds each recurrent block's
conv window and f32 LRU state and each attention block's rolling K / V
ring of min(window, max_len) slots.  ``prefill`` runs the blocks as the
forward does (the attention through the window kernel), keeps the states,
and rolls the last W keys into slots pos % W (zero-padded while S < W);
``decode_step`` writes the token's K and V at slot pos % W and then
attends with kv_len = min(pos + 1, W) through ``ops.decode_attention``
(write-then-attend, the reference's order, unlike lm's).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       mask_padded_logits, rms_norm, rope,
                                       seeded_generator, softcap, stack_list)

LOSS_CHUNK = 1024  # positions a checkpointed piece of the loss holds


def _layout(cfg: ModelConfig):
    """(n_groups, remainder pattern, rglru a group, attn a group, L_rec,
    L_attn), as the reference's ``_layout``."""
    pat = cfg.block_pattern
    n_groups = cfg.num_layers // len(pat)
    rem = pat[: cfg.num_layers % len(pat)]
    rpg = sum(1 for p in pat if p == "rglru")
    apg = sum(1 for p in pat if p == "attn")
    L_rec = n_groups * rpg + sum(1 for p in rem if p == "rglru")
    L_attn = n_groups * apg + sum(1 for p in rem if p == "attn")
    return n_groups, rem, rpg, apg, L_rec, L_attn


def _mlp_shapes(cfg):
    D, F_ = cfg.d_model, cfg.d_ff
    return {"ln2": (D,), "w_gate": (D, F_), "w_up": (D, F_),
            "w_down": (F_, D)}


def _rec_shapes(cfg):
    D, W = cfg.d_model, cfg.lru_width
    return {"ln1": (D,), "w_y": (D, W), "w_x": (D, W),
            "conv_w": (cfg.conv_width, W), "conv_b": (W,),
            "wa": (W, W), "wg": (W, W), "log_lambda": (W,),
            "w_out": (W, D), **_mlp_shapes(cfg)}


def _attn_shapes(cfg):
    D, H, KH, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"ln1": (D,), "wq": (D, H * Dh), "wk": (D, KH * Dh),
            "wv": (D, KH * Dh), "wo": (H * Dh, D), **_mlp_shapes(cfg)}


def init(cfg: ModelConfig, generator: torch.Generator = None, *, seed=0,
         device=None) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (or one seeded with ``seed``
    on ``device``), with the reference's names, shapes, types and
    constants (norms 1, conv_b 0, log_lambda 4.0 in f32).  The draws
    differ from ``jax.random``'s; tests carry the reference's weights over
    with ``convert.params_from_jax``."""
    dev = resolve(device)
    if generator is None:
        generator = seeded_generator(dev, seed)
    dt = dtype_of(cfg.param_dtype)
    *_, L_rec, L_attn = _layout(cfg)

    def stack(shapes, L):
        out = {}
        for name, shp in sorted(shapes.items()):
            full = (L,) + shp
            if name.startswith("ln"):
                out[name] = torch.ones(full, dtype=dt, device=dev)
            elif name == "conv_b":
                out[name] = torch.zeros(full, dtype=dt, device=dev)
            elif name == "log_lambda":  # a = sigmoid(4) ~ 0.982
                out[name] = torch.full(full, 4.0, dtype=torch.float32,
                                       device=dev)
            else:
                out[name] = dense_init(generator, full, dt, dev)
        return out

    return {
        "emb": dense_init(generator, (cfg.vocab_padded, cfg.d_model), dt,
                          dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "rec_layers": stack(_rec_shapes(cfg), L_rec),
        "attn_layers": stack(_attn_shapes(cfg), L_attn),
    }


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def _mlp(cfg, x, w):
    cd = dtype_of(cfg.compute_dtype)
    g = _gelu((x @ w["w_gate"]).float()).to(cd)
    u = (x @ w["w_up"]).to(cd)
    return (g * u) @ w["w_down"]


def _rec_temporal(cfg, h, w):
    """The recurrent branch of h (B, S, D) from a zero state (reference
    ``_rec_temporal`` with no conv or LRU state): (out, the conv window
    (B, conv_width - 1, W), the last LRU state (B, W) f32).  A prompt
    shorter than the window leaves zeros at the window's head."""
    cd = dtype_of(cfg.compute_dtype)
    S = h.shape[1]
    y = _gelu((h @ w["w_y"]).float()).to(cd)
    xi = (h @ w["w_x"]).to(cd)  # (B, S, W)
    K = cfg.conv_width
    xp = F.pad(xi, (0, 0, K - 1, 0))
    conv = xp[:, :S] * w["conv_w"][0][None, None, :]
    for i in range(1, K):
        conv = conv + xp[:, i:i + S] * w["conv_w"][i][None, None, :]
    conv = (conv + w["conv_b"][None, None, :]).to(cd)
    log_a, gated = ref.rglru_gates(conv, w["wa"], w["wg"], w["log_lambda"])
    hs, h_last = ops.rglru(log_a, gated)
    return (y * hs.to(cd)) @ w["w_out"], xp[:, -(K - 1):], h_last


def _rec_block(cfg, x, w, tables):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    x = x + _rec_temporal(cfg, h, w)[0]
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def _attn_block(cfg, x, w, tables):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    out, _ = lm._attention(cfg, h, w, tables, causal=True,
                           window=cfg.window)
    x = x + out
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def _order(cfg):
    """The blocks in the reference's order (``_split_groups``): each
    group's recurrent blocks, then its attention blocks, then the
    trailing recurrent blocks; ("rglru", i) or ("attn", j), an index
    into its stack."""
    n_groups, rem, rpg, apg, _, _ = _layout(cfg)
    out = []
    for g in range(n_groups):
        out += [("rglru", g * rpg + i) for i in range(rpg)]
        out += [("attn", g * apg + i) for i in range(apg)]
    n_rem_rec = sum(1 for p in rem if p == "rglru")
    return out + [("rglru", n_groups * rpg + j) for j in range(n_rem_rec)]


def _blocks(cfg, params):
    """(block, weights) in ``_order``."""
    stacks = {"rglru": (functools.partial(_rec_block, cfg),
                        stack_list(params["rec_layers"])),
              "attn": (functools.partial(_attn_block, cfg),
                       stack_list(params["attn_layers"]))}
    return [(stacks[kind][0], stacks[kind][1][i]) for kind, i in _order(cfg)]


def _trunk(cfg, params, batch):
    """The residual stream after the last block, (B, S, D)."""
    x = params["emb"][batch["tokens"].long()].to(dtype_of(cfg.compute_dtype))
    tables = lm._rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
    for block, w in _blocks(cfg, params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, tables, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, w, tables)
    return x


def _head(cfg, final_norm, emb, x):
    """The final norm, the tied head, the softcap and the padded columns'
    mask: logits (B, S, vocab_padded) of the residual stream x."""
    x = rms_norm(x, final_norm, cfg.norm_eps)
    logits = x @ emb.T.to(x.dtype)
    return mask_padded_logits(cfg, softcap(logits, cfg.logits_softcap))


def forward(cfg: ModelConfig, params, batch):
    """Teacher-forced logits (B, S, vocab_padded) of ``batch["tokens"]``
    (B, S): the embedding (tied head), softcapped logits, padded columns
    masked."""
    return _head(cfg, params["final_norm"], params["emb"],
                 _trunk(cfg, params, batch))


def _ce_sum(cfg, final_norm, emb, x, labels):
    """The summed cross entropy of ``labels`` under ``_head`` of x."""
    return cross_entropy(_head(cfg, final_norm, emb, x), labels) * \
        labels.numel()


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross entropy of ``batch["tokens"]`` in f32.

    The head, the softcap and the cross entropy run over LOSS_CHUNK
    positions at a time, each chunk under ``torch.utils.checkpoint`` when
    autograd records: at recurrentgemma-9b's vocabulary of 256,000 the
    f32 logits of a 4096-token sequence are 4.2 GB, and the softcap and
    the cross entropy keep several such tensors for the backward; a chunk
    keeps a quarter.  The chunks' sums in order, over the token count,
    are the reference's mean up to the order of the f32 sum."""
    tokens = batch["tokens"]
    x = _trunk(cfg, params, batch)[:, :-1]
    labels = tokens[:, 1:]
    piece = functools.partial(_ce_sum, cfg, params["final_norm"],
                              params["emb"])
    total = 0.0
    for c0 in range(0, labels.shape[1], LOSS_CHUNK):
        args = (x[:, c0:c0 + LOSS_CHUNK], labels[:, c0:c0 + LOSS_CHUNK])
        if torch.is_grad_enabled():
            total = total + checkpoint(piece, *args, use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + piece(*args)
    return total / labels.numel()


# ---------------------------------------------------------------------------
# serving (reference griffin.py:192-391)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch_size: int, max_len: int = 0,
               enc_len: int = 0, device=None):
    """``conv`` (L_rec, B, conv_width - 1, W) in the compute type, ``lru``
    (L_rec, B, W) f32, the rings ``k`` / ``v`` (L_attn, B, min(window,
    max_len), KH, Dh) and ``pos``."""
    dev = resolve(device)
    *_, L_rec, L_attn = _layout(cfg)
    cd = dtype_of(cfg.compute_dtype)
    W = min(cfg.window, max_len) if max_len else cfg.window
    ring = (L_attn, batch_size, W, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((L_rec, batch_size, cfg.conv_width - 1,
                             cfg.lru_width), dtype=cd, device=dev),
        "lru": torch.zeros((L_rec, batch_size, cfg.lru_width),
                           dtype=torch.float32, device=dev),
        "k": torch.zeros(ring, dtype=cd, device=dev),
        "v": torch.zeros(ring, dtype=cd, device=dev),
        "pos": 0,
    }


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt (B, S) block by block, keeping each recurrent
    block's conv window and LRU state and each attention block's last W
    keys and values, rolled into slots pos % W (S >= W) or zero-padded
    (S < W), all IN PLACE in ``cache``.  Returns (last-position logits
    (B, 1, V), cache)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    W = cache["k"].shape[2]
    x = params["emb"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    tables = lm._rope_tables(cfg, torch.arange(S, device=x.device))
    stacks = {"rglru": stack_list(params["rec_layers"]),
              "attn": stack_list(params["attn_layers"])}
    for kind, i in _order(cfg):
        w = stacks[kind][i]
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        if kind == "rglru":
            out, cache["conv"][i], cache["lru"][i] = _rec_temporal(cfg, h, w)
        else:
            out, (k, v) = lm._attention(cfg, h, w, tables, causal=True,
                                        window=cfg.window)
            for name, t in (("k", k), ("v", v)):
                if S >= W:
                    cache[name][i] = torch.roll(t[:, -W:], S % W, dims=1)
                else:
                    cache[name][i, :, :S] = t
                    cache[name][i, :, S:] = 0
        x = x + out
        x = x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)
    cache["pos"] = S
    return _head(cfg, params["final_norm"], params["emb"], x[:, -1:]), cache


def _decode_rec(cfg, x, w, conv_st, lru_st):
    """One token through a recurrent block; its conv window and LRU state
    advance IN PLACE."""
    cd = dtype_of(cfg.compute_dtype)
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    y = _gelu((h @ w["w_y"]).float()).to(cd)
    xi = (h @ w["w_x"]).to(cd)  # (B, 1, W)
    window = torch.cat([conv_st, xi], dim=1)  # (B, K, W)
    conv = torch.einsum("bkw,kw->bw", window.float(), w["conv_w"].float())
    conv = (conv + w["conv_b"].float())[:, None].to(cd)
    log_a, gated = ref.rglru_gates(conv, w["wa"], w["wg"], w["log_lambda"])
    hs, h_last = ref.rglru_ref(log_a, gated, h0=lru_st)
    conv_st.copy_(window[:, 1:])
    lru_st.copy_(h_last)
    x = x + (y * hs.to(cd)) @ w["w_out"]
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def _decode_attn(cfg, x, w, k_l, v_l, pos):
    """One token through an attention block: its K and V written at slot
    pos % W of the ring first, then attended with kv_len = min(pos + 1,
    W), the reference's order."""
    B = x.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    W = k_l.shape[1]
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    tables = lm._rope_tables(cfg, torch.full((B, 1), pos, device=x.device))
    q, k, v = lm._qkv(cfg, h, w)
    q = rope(q.reshape(B, 1, H, Dh), tables)
    k_l[:, pos % W] = rope(k.reshape(B, 1, KH, Dh), tables)[:, 0]
    v_l[:, pos % W] = v.reshape(B, KH, Dh)
    kv_len = torch.full((B,), min(pos + 1, W), dtype=torch.int32,
                        device=x.device)
    o = ops.decode_attention(q, k_l, v_l, kv_len=kv_len)
    x = x + o.reshape(B, 1, H * Dh) @ w["wo"]
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One token (B, 1) through every block, the states and rings
    advanced IN PLACE.  Returns (logits (B, 1, V), cache)."""
    pos = cache["pos"]
    x = params["emb"][tokens.long()].to(dtype_of(cfg.compute_dtype))
    stacks = {"rglru": stack_list(params["rec_layers"]),
              "attn": stack_list(params["attn_layers"])}
    for kind, i in _order(cfg):
        w = stacks[kind][i]
        if kind == "rglru":
            x = _decode_rec(cfg, x, w, cache["conv"][i], cache["lru"][i])
        else:
            x = _decode_attn(cfg, x, w, cache["k"][i], cache["v"][i], pos)
    cache["pos"] = pos + 1
    return _head(cfg, params["final_norm"], params["emb"], x), cache
