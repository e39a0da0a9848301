"""Dense decoder LM: init, the training forward and loss, and the paged
serving path (port of the dense family of ``repro/models/lm.py``).

Parameters are a plain dict with the reference's leaf names and shapes:
layers stacked on a leading L dim, weights in ``x @ w`` orientation.  The
reference's ``lax.scan``/``fori_loop`` over layers is a Python loop here,
and the paged cache is updated in place.  ``params["layers"]`` may also be
a list of per-layer dicts (the round step differentiates each layer's
slices).  With ``cfg.remat`` each layer of ``forward`` runs under
``torch.utils.checkpoint``, so its attention forward runs again in the
backward, as ``jax.checkpoint`` does.  On the card the attention's
gradient is the hand-written backward kernel (``ops.flash_attention``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       layer_list, rms_norm, rope, softcap)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D, H, KH, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    s: Dict[str, tuple] = {
        "ln1": (D,), "ln2": (D,),
        "wq": (D, H * Dh), "wk": (D, KH * Dh), "wv": (D, KH * Dh),
        "wo": (H * Dh, D),
        "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D),
    }
    if cfg.qkv_bias:
        s.update(bq=(H * Dh,), bk=(KH * Dh,), bv=(KH * Dh,))
    return s


def init(cfg: ModelConfig, generator: torch.Generator = None, *, seed=0,
         device=None) -> Dict[str, Any]:
    """Random weights drawn from ``generator`` (or one seeded with
    ``seed`` on ``device``), with the reference's names and shapes.

    The draws differ from ``jax.random``'s; tests that compare with the
    reference carry its weights over with ``convert.params_from_jax``.
    """
    dev = resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    dt = dtype_of(cfg.param_dtype)
    L = cfg.num_layers

    def draw(shape):
        return dense_init(generator, shape, dt, dev)

    params: Dict[str, Any] = {
        "emb": draw((cfg.vocab_padded, cfg.d_model)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": {
            name: (torch.ones((L,) + shp, dtype=dt, device=dev)
                   if name.startswith("ln") else draw((L,) + shp))
            for name, shp in sorted(_layer_shapes(cfg).items())},
    }
    if not cfg.tie_embeddings:
        params["out_head"] = draw((cfg.d_model, cfg.vocab_padded))
    return params


def param_count(params) -> int:
    n = 0
    for v in params.values():
        n += param_count(v) if isinstance(v, dict) else v.numel()
    return n


def _layer(params, l):
    return {name: w[l] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _qkv(cfg, x, w):
    cd = dtype_of(cfg.compute_dtype)
    q = (x @ w["wq"]).to(cd)
    k = (x @ w["wk"]).to(cd)
    v = (x @ w["wv"]).to(cd)
    if cfg.qkv_bias:
        q = q + w["bq"].to(cd)
        k = k + w["bk"].to(cd)
        v = v + w["bv"].to(cd)
    return q, k, v


def _attention(cfg, x, w, positions, *, causal, window=0):
    B, S, D = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, x, w)
    q = rope(q.reshape(B, S, H, Dh), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, KH, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, KH, Dh)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    o = o.reshape(B, S, H * Dh) @ w["wo"]
    return o, (k, v)


def _dense_ffn(cfg, x, w):
    cd = dtype_of(cfg.compute_dtype)
    g = torch.nn.functional.silu((x @ w["w_gate"]).float()).to(cd)
    u = (x @ w["w_up"]).to(cd)
    return (g * u) @ w["w_down"]


def _embed(cfg, params, tokens):
    return params["emb"][tokens].to(dtype_of(cfg.compute_dtype))


def _logits(cfg, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["emb"].T if cfg.tie_embeddings else params["out_head"]
    logits = x @ head.to(x.dtype)
    logits = softcap(logits, cfg.logits_softcap)
    if cfg.vocab_padded != cfg.vocab_size:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ---------------------------------------------------------------------------
# forward / loss (reference lm.py:293-385, the dense decoder only)
# ---------------------------------------------------------------------------

def _block(cfg, x, w, positions):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    attn_out, _ = _attention(cfg, h, w, positions, causal=True,
                             window=cfg.window)
    x = x + attn_out
    h = rms_norm(x, w["ln2"], cfg.norm_eps)
    return x + _dense_ffn(cfg, h, w)


def forward(cfg: ModelConfig, params, batch):
    """Teacher-forced logits (B, S, vocab_padded) of ``batch["tokens"]``
    (B, S).  The dense decoder only: the reference's MoE FFN, encoder and
    ViT frontend are other families here, not ported (ROADMAP.md, modules
    to port, item 6)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"lm.forward runs the dense decoder; family {cfg.family!r} is "
            f"not ported yet (ROADMAP.md, modules to port, item 6)")
    x = _embed(cfg, params, batch["tokens"].long())
    positions = torch.arange(x.shape[1], device=x.device)
    block = functools.partial(_block, cfg)
    for w in layer_list(params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, w, positions)
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross entropy of ``batch["tokens"]`` in f32."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, batch)
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


# ---------------------------------------------------------------------------
# serving: paged cache / prefill / decode
# ---------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     device=None):
    """Paged KV pool: one (L, num_pages, page_size, KH, Dh) buffer per K/V
    in the compute type, page 0 reserved as the null page."""
    dev = resolve(device)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    cd = dtype_of(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev)}


def prefill_paged(cfg: ModelConfig, params, batch, cache, page_table,
                  prompt_len):
    """Prompt prefill writing KV through the page table, IN PLACE.

    batch["tokens"]: (B, S_pad) right-padded prompts with S_pad a multiple
    of the page size; page_table: (B, P) physical page ids; prompt_len:
    (B,) true prompt lengths.  Returns logits at position prompt_len-1 per
    row (B, 1, V); ``cache`` is updated in place and returned.

    Positions >= prompt_len hold pad garbage in the written pages: reads
    are masked by kv_len and decode overwrites them as the request grows.
    Table entries past a request's own pages are the null page 0, so
    several rows may write page 0 in one call; which write lands does not
    matter, because page 0 is never read unmasked.
    """
    x = _embed(cfg, params, batch["tokens"])
    B, S, D = x.shape
    ps = cache["k"].shape[2]
    if S % ps:
        raise ValueError(f"prefill length {S} is not a multiple of the page "
                         f"size {ps}")
    Pp = S // ps
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    positions = torch.arange(S, device=x.device)
    phys = page_table[:, :Pp].long()  # (B, Pp)
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        attn_out, (k_new, v_new) = _attention(cfg, h, w, positions,
                                              causal=True, window=cfg.window)
        x = x + attn_out
        h = rms_norm(x, w["ln2"], cfg.norm_eps)
        x = x + _dense_ffn(cfg, h, w)
        cache["k"][l].index_put_(
            (phys,), k_new.reshape(B, Pp, ps, KH, Dh).to(cache["k"].dtype))
        cache["v"][l].index_put_(
            (phys,), v_new.reshape(B, Pp, ps, KH, Dh).to(cache["v"].dtype))
    idx = (prompt_len.long() - 1)[:, None, None].expand(B, 1, D)
    logits = _logits(cfg, params, torch.gather(x, 1, idx))
    return logits, cache


def decode_step_paged(cfg: ModelConfig, params, cache, tokens, page_table,
                      kv_len):
    """One-token decode through the page table, updating ``cache`` IN PLACE.

    tokens: (B, 1); page_table: (B, P) int32; kv_len: (B,) int32 per-request
    lengths (0 for empty decode slots: their reads are fully masked and
    their writes land on the null page).  Returns (logits (B, 1, V), cache).

    Attend-then-write, as the reference: the kernel reads the pre-update
    pages, ``decode_attention_combine`` folds the current token in, and
    only then is the token's (k, v) written at (phys, off).  Empty slots
    all write page 0 at offset 0; their order does not matter, because
    page 0 is never read unmasked.
    """
    B = tokens.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = cache["k"].shape[2]
    kv_len = kv_len.to(torch.int32)
    positions = kv_len[:, None]  # (B, 1) per-request rope positions
    x = _embed(cfg, params, tokens)
    pj = torch.div(kv_len, ps, rounding_mode="floor")
    phys = torch.gather(page_table, 1, pj[:, None].long())[:, 0].long()
    off = (kv_len % ps).long()
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, w)
        q = rope(q.reshape(B, 1, H, Dh), positions, cfg.rope_theta)
        k = rope(k.reshape(B, 1, KH, Dh), positions, cfg.rope_theta)
        v = v.reshape(B, 1, KH, Dh)
        kp, vp = cache["k"][l], cache["v"][l]
        o_old, m_old, l_old = ops.paged_decode_attention(
            q, kp, vp, page_table, kv_len)
        o = ops.decode_attention_combine(q, o_old, m_old, l_old, k, v)
        kp.index_put_((phys, off), k[:, 0].to(kp.dtype))
        vp.index_put_((phys, off), v[:, 0].to(vp.dtype))
        x = x + o.reshape(B, 1, H * Dh) @ w["wo"]
        h = rms_norm(x, w["ln2"], cfg.norm_eps)
        x = x + _dense_ffn(cfg, h, w)
    return _logits(cfg, params, x), cache
