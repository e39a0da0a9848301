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
``prefill``, ``decode_step`` and ``init_cache`` wait for
``Engine.generate`` (ROADMAP.md, modules to port, item 4).
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
                                       mask_padded_logits, rms_norm, softcap,
                                       stack_list)

SERVING = ("ROADMAP.md, modules to port, item 4 (Engine.generate: the "
           "hybrid family's rolling-window decode)")
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
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
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
    """The recurrent branch of h (B, S, D), from a zero state (reference
    ``_rec_temporal`` with no conv or LRU state)."""
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
    hs, _ = ops.rglru(log_a, gated)
    return (y * hs.to(cd)) @ w["w_out"]


def _rec_block(cfg, x, w, tables):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    x = x + _rec_temporal(cfg, h, w)
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def _attn_block(cfg, x, w, tables):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    out, _ = lm._attention(cfg, h, w, tables, causal=True,
                           window=cfg.window)
    x = x + out
    return x + _mlp(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


def _blocks(cfg, params):
    """(block, weights) in the reference's order: each group's recurrent
    blocks then its attention blocks, then the trailing recurrent
    blocks (``_split_groups``)."""
    n_groups, rem, rpg, apg, _, _ = _layout(cfg)
    rec = stack_list(params["rec_layers"])
    attn = stack_list(params["attn_layers"])
    rec_block = functools.partial(_rec_block, cfg)
    attn_block = functools.partial(_attn_block, cfg)
    out = []
    for g in range(n_groups):
        out += [(rec_block, rec[g * rpg + i]) for i in range(rpg)]
        out += [(attn_block, attn[g * apg + i]) for i in range(apg)]
    n_rem_rec = sum(1 for p in rem if p == "rglru")
    out += [(rec_block, rec[n_groups * rpg + j]) for j in range(n_rem_rec)]
    return out


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


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int = 0):
    raise NotImplementedError(f"griffin.init_cache is not ported yet: "
                              f"{SERVING}")


def prefill(cfg: ModelConfig, params, batch, cache):
    raise NotImplementedError(f"griffin.prefill is not ported yet: "
                              f"{SERVING}")


def decode_step(cfg: ModelConfig, params, cache, tokens):
    raise NotImplementedError(f"griffin.decode_step is not ported yet: "
                              f"{SERVING}")
