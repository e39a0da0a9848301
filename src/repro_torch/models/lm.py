"""Decoder LM, the dense and moe families: init, the training forward and
loss, and the paged serving path (port of the dense and MoE decoder of
``repro/models/lm.py``).

Parameters are a plain dict with the reference's leaf names and shapes:
layers stacked on a leading L dim, weights in ``x @ w`` orientation.  The
reference's ``lax.scan``/``fori_loop`` over layers is a Python loop here,
and the paged cache is updated in place.  ``params["layers"]`` may also be
a list of per-layer dicts (the round step differentiates each layer's
slices).  With ``cfg.remat`` each layer of ``forward`` runs under
``torch.utils.checkpoint``, so its attention forward runs again in the
backward, as ``jax.checkpoint`` does.  On the card the attention's
gradient is the hand-written backward kernel (``ops.flash_attention``).
With ``cfg.num_experts`` the FFN is the reference's MoE (``_moe_ffn``):
top-k routing, capacity-bounded dispatch by gathers whose gradients are
gathers too, and the expert products as batched GEMMs.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       layer_list, rms_norm, rope,
                                       rope_tables, softcap)


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
    }
    if cfg.qkv_bias:
        s.update(bq=(H * Dh,), bk=(KH * Dh,), bv=(KH * Dh,))
    if cfg.num_experts:
        E = cfg.num_experts
        s.update(router=(D, E), we_gate=(E, D, F), we_up=(E, D, F),
                 we_down=(E, F, D))
        if cfg.moe_dense_ff:
            Fd = cfg.moe_dense_ff
            s.update(w_gate=(D, Fd), w_up=(D, Fd), w_down=(Fd, D))
    else:
        s.update(w_gate=(D, F), w_up=(D, F), w_down=(F, D))
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
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):  # ``layer_list``'s views
        return layers[l]
    return {name: w[l] for name, w in layers.items()}


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


def _rope_tables(cfg, positions):
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _attention(cfg, x, w, tables, *, causal, window=0):
    """Self-attention of x (B, S, D); ``tables``: ``_rope_tables`` at its
    positions."""
    B, S, D = x.shape
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, x, w)
    q = rope(q.reshape(B, S, H, Dh), tables)
    k = rope(k.reshape(B, S, KH, Dh), tables)
    v = v.reshape(B, S, KH, Dh)
    o = ops.flash_attention(q, k, v, causal=causal, window=window)
    o = o.reshape(B, S, H * Dh) @ w["wo"]
    return o, (k, v)


def _dense_ffn(cfg, x, w):
    cd = dtype_of(cfg.compute_dtype)
    g = torch.nn.functional.silu((x @ w["w_gate"]).float()).to(cd)
    u = (x @ w["w_up"]).to(cd)
    return (g * u) @ w["w_down"]


# ---------------------------------------------------------------------------
# MoE FFN (reference lm.py:136-290), one routing block (nblk = 1)
# ---------------------------------------------------------------------------

def _rows(x, idx, mask):
    """x[idx] * mask: rows of the 2-D ``x`` by an int64 index, each
    multiplied by its 0/1 ``mask`` entry in x's type."""
    return x.index_select(0, idx) * mask[:, None].to(x.dtype)


class _RowGather(torch.autograd.Function):
    """y = x[idx_f] * mask_f, whose gradient is the gather dy[idx_b] *
    mask_b, summed over each ``fan`` consecutive rows in order.

    The reference's ``_perm_gather`` (fan 1) and ``_fanout_gather``
    composed with it (fan K).  The dispatch's index sets are masked
    bijections, so every cotangent is a gather with the inverse index set;
    autograd's own backward of a gather, ``index_add_``, would sum a
    token's K cotangents with float atomics on CUDA, in an order that
    changes from run to run."""

    @staticmethod
    def forward(ctx, x, idx_f, mask_f, idx_b, mask_b, fan):
        ctx.save_for_backward(idx_b, mask_b)
        ctx.fan = fan
        return _rows(x, idx_f, mask_f)

    @staticmethod
    def backward(ctx, dy):
        idx_b, mask_b = ctx.saved_tensors
        dx = _rows(dy, idx_b, mask_b)
        if ctx.fan > 1:
            dx = dx.view(-1, ctx.fan, dx.shape[-1]).sum(dim=1)
        return dx, None, None, None, None, None


class Route(NamedTuple):
    """One MoE layer's routing of B x S tokens (``_moe_route``).

    Assignments are token-major, row b * S * K + s * K + k (the k-th
    expert of token s); expert slots are expert-major, row e * B * cap +
    b * cap + c (the c-th kept assignment of row b to expert e), so the
    dispatched tokens are (E, B * cap, D) for ``bmm``."""

    weight: torch.Tensor  # (B*S*K,) f32 gate weight, 0 where dropped
    src: torch.Tensor     # (E*B*cap,) token row each slot reads
    valid: torch.Tensor   # (E*B*cap,) the slot holds an assignment
    assign: torch.Tensor  # (E*B*cap,) the assignment row of each slot
    slot: torch.Tensor    # (B*S*K,) the slot row of each assignment
    ok: torch.Tensor      # (B*S*K,) the assignment is within capacity
    cap: int


def _gates(cfg, x, router):
    """(gate values, expert ids), each (B, S, K): the router logits in
    f32, softmax, the top K (sorted, the lower expert first on ties: a
    stable sort, since ``torch.topk`` does not promise that order on
    CUDA), the values renormalised with max(sum, 1e-9)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.experts_per_token
    gate_vals = top.values[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return gate_vals, top.indices[..., :K]


def _moe_route(cfg, x, router) -> Route:
    """Routing and capacity of reference lm.py:224-257 for x (B, S, D),
    each row one routing block: ``_gates``, a stable argsort of the
    expert ids, each expert's first sorted assignment by
    ``searchsorted``, and cap = max(8, 2 ceil(A / E)) slots an expert, A
    = S K.  An assignment past its expert's cap is dropped; its gate
    value still counts in the renormalisation.  Nothing here draws random
    numbers, so a checkpointed recompute routes the same way."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    A = S * K
    dev = x.device
    gate_vals, gate_idx = _gates(cfg, x, router)
    e_flat = gate_idx.reshape(B, A)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    inv_order = torch.argsort(order, dim=-1, stable=True)
    e_s = torch.gather(e_flat, 1, order)
    eids = torch.arange(E, device=dev).expand(B, E).contiguous()
    first = torch.searchsorted(e_s, eids, side="left")  # (B, E)
    cap = max(8, 2 * ((A + E - 1) // E))
    slot_src = first[..., None] + torch.arange(cap, device=dev)
    cs = slot_src.clamp(max=A - 1).view(B, E * cap)
    valid = (slot_src < A) & (torch.gather(e_s, 1, cs).view(B, E, cap)
                              == eids[..., None])
    pos = torch.arange(A, device=dev) - torch.gather(first, 1, e_s)
    ok = pos < cap  # (B, A), sorted order
    b = torch.arange(B, device=dev)
    src_a = torch.gather(order, 1, cs).view(B, E, cap)  # token-major
    assign = (b[:, None, None] * A + src_a).transpose(0, 1).reshape(-1)
    slot = (e_s * (B * cap) + b[:, None] * cap
            + pos.clamp(max=cap - 1))  # dropped: any row, masked
    ok_t = torch.gather(ok, 1, inv_order).reshape(-1)
    return Route(
        weight=gate_vals.reshape(-1) * ok_t.float(),
        src=torch.div(assign, K, rounding_mode="floor"),
        valid=valid.transpose(0, 1).reshape(-1), assign=assign,
        slot=torch.gather(slot, 1, inv_order).reshape(-1), ok=ok_t,
        cap=cap)


def _moe_dispatch(cfg, x, r: Route):
    """The tokens of every expert slot, (E, B * cap, D) in the compute
    type; zero rows where a slot is empty."""
    B, S, D = x.shape
    X = _RowGather.apply(x.reshape(B * S, D), r.src, r.valid, r.slot, r.ok,
                         cfg.experts_per_token)
    return X.view(cfg.num_experts, -1, D).to(dtype_of(cfg.compute_dtype))


def _experts(cfg, X, w):
    """The expert FFNs on X (E, rows, D) in ``bmm``, silu of the gate
    product in f32 as ``_dense_ffn``: (E, rows, D) in the compute type."""
    cd = dtype_of(cfg.compute_dtype)
    g = torch.nn.functional.silu(
        torch.bmm(X, w["we_gate"]).float()).to(cd)
    u = torch.bmm(X, w["we_up"]).to(cd)
    return torch.bmm(g * u, w["we_down"]).to(cd)


def _moe_ffn(cfg, x, w):
    """The reference's ``_moe_ffn`` (lm.py:202-290) with one routing block
    a row (nblk = 1: one card, no sequence shards).  Dispatch and combine
    are gathers, forward and backward; the expert products run as ``bmm``
    over (E, B * cap, D); the combine sums each token's K outputs in k
    order.  Arctic's dense-residual FFN (``moe_dense_ff``) runs beside it
    on the same input."""
    B, S, D = x.shape
    cd = dtype_of(cfg.compute_dtype)
    r = _moe_route(cfg, x, w["router"])
    Y = _experts(cfg, _moe_dispatch(cfg, x, r), w)
    ya = _RowGather.apply(Y.view(-1, D), r.slot, r.ok, r.assign, r.valid, 1)
    ya = ya * r.weight.to(cd)[:, None]
    y = ya.view(B, S, cfg.experts_per_token, D).sum(dim=2)
    if cfg.moe_dense_ff:  # arctic's dense-residual branch, in parallel
        y = y + _dense_ffn(cfg, x, w)
    return y


def _ffn(cfg, x, w):
    return (_moe_ffn if cfg.num_experts else _dense_ffn)(cfg, x, w)


def _ffn_half(cfg, x, w):
    """The FFN half of a block: x + FFN(rms_norm(x))."""
    return x + _ffn(cfg, rms_norm(x, w["ln2"], cfg.norm_eps), w)


class DecodeGraphs:
    """The FFN half of each decode layer (``_ffn_half``: its RMS norm,
    the dense or MoE FFN, the residual add) as CUDA graphs, one a layer
    and input shape, captured at first use; for one set of weights, which
    keep their addresses between calls (an engine's).

    The half holds no hand-written kernel, so no counted launch moves
    into a graph.  A decode step is bound by the host's launches: a
    replay takes two (the input's copy and the graph) where the half
    takes about 15 eagerly, several dozen with the MoE's routing.  A
    layer's output holds until that layer's next replay."""

    def __init__(self):
        self._graphs = {}
        # every warm-up and capture on one side stream: cuBLAS keeps a
        # workspace for each stream it has run on, for the process's life
        self._stream = None

    def ffn_half(self, cfg, x, w, layer):
        key = (layer, tuple(x.shape), x.dtype)
        if key not in self._graphs:
            self._graphs[key] = self._capture(cfg, x, w)
        static_x, out, graph = self._graphs[key]
        static_x.copy_(x)
        graph.replay()
        return out

    def _capture(self, cfg, x, w):
        if self._stream is None:
            self._stream = torch.cuda.Stream(x.device)
        side, main = self._stream, torch.cuda.current_stream(x.device)
        static_x = x.clone()
        side.wait_stream(main)
        with torch.cuda.stream(side):  # cuBLAS handle and workspace, pools
            for _ in range(2):
                _ffn_half(cfg, static_x, w)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = _ffn_half(cfg, static_x, w)
        return static_x, out, graph


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
# forward / loss (reference lm.py:293-385, the decoder only)
# ---------------------------------------------------------------------------

def _block(cfg, x, w, tables):
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    attn_out, _ = _attention(cfg, h, w, tables, causal=True,
                             window=cfg.window)
    return _ffn_half(cfg, x + attn_out, w)


def forward(cfg: ModelConfig, params, batch):
    """Teacher-forced logits (B, S, vocab_padded) of ``batch["tokens"]``
    (B, S).  The dense and MoE decoder: the reference's encoder and ViT
    frontend are other families here, not ported (ROADMAP.md, modules to
    port, item 6)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"lm.forward runs the dense and MoE decoder; family "
            f"{cfg.family!r} is not ported yet (ROADMAP.md, modules to "
            f"port, item 6)")
    x = _embed(cfg, params, batch["tokens"].long())
    tables = _rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
    block = functools.partial(_block, cfg)
    for w in layer_list(params):
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, tables, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, w, tables)
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
    tables = _rope_tables(cfg, torch.arange(S, device=x.device))
    phys = page_table[:, :Pp].long()  # (B, Pp)
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        attn_out, (k_new, v_new) = _attention(cfg, h, w, tables,
                                              causal=True, window=cfg.window)
        x = _ffn_half(cfg, x + attn_out, w)
        cache["k"][l].index_put_(
            (phys,), k_new.reshape(B, Pp, ps, KH, Dh).to(cache["k"].dtype))
        cache["v"][l].index_put_(
            (phys,), v_new.reshape(B, Pp, ps, KH, Dh).to(cache["v"].dtype))
    idx = (prompt_len.long() - 1)[:, None, None].expand(B, 1, D)
    logits = _logits(cfg, params, torch.gather(x, 1, idx))
    return logits, cache


def decode_step_paged(cfg: ModelConfig, params, cache, tokens, page_table,
                      kv_len, graphs: DecodeGraphs = None):
    """One-token decode through the page table, updating ``cache`` IN PLACE.

    tokens: (B, 1); page_table: (B, P) int32; kv_len: (B,) int32 per-request
    lengths (0 for empty decode slots: their reads are fully masked and
    their writes land on the null page).  Returns (logits (B, 1, V), cache).

    Attend-then-write, as the reference: the kernel reads the pre-update
    pages, ``decode_attention_combine`` folds the current token in, and
    only then is the token's (k, v) written at (phys, off).  Empty slots
    all write page 0 at offset 0; their order does not matter, because
    page 0 is never read unmasked.  With ``graphs`` (a ``DecodeGraphs``,
    on the card) each layer's FFN half replays as a CUDA graph.
    """
    B = tokens.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ps = cache["k"].shape[2]
    kv_len = kv_len.to(torch.int32)
    tables = _rope_tables(cfg, kv_len[:, None])  # per-request positions
    x = _embed(cfg, params, tokens)
    pj = torch.div(kv_len, ps, rounding_mode="floor")
    phys = torch.gather(page_table, 1, pj[:, None].long())[:, 0].long()
    off = (kv_len % ps).long()
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, w)
        q = rope(q.reshape(B, 1, H, Dh), tables)
        k = rope(k.reshape(B, 1, KH, Dh), tables)
        v = v.reshape(B, 1, KH, Dh)
        kp, vp = cache["k"][l], cache["v"][l]
        o_old, m_old, l_old = ops.paged_decode_attention(
            q, kp, vp, page_table, kv_len)
        o = ops.decode_attention_combine(q, o_old, m_old, l_old, k, v)
        kp.index_put_((phys, off), k[:, 0].to(kp.dtype))
        vp.index_put_((phys, off), v[:, 0].to(vp.dtype))
        x = x + o.reshape(B, 1, H * Dh) @ w["wo"]
        x = (_ffn_half(cfg, x, w) if graphs is None
             else graphs.ffn_half(cfg, x, w, l))
    return _logits(cfg, params, x), cache
