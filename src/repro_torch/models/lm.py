"""Transformer LM, the dense, moe and encdec families with the modality
frontend stubs: init, the training forward and loss, and both serving
paths, the static cache and the paged pool (port of
``repro/models/lm.py``).

Parameters are a plain dict with the reference's leaf names and shapes:
layers stacked on a leading L dim, weights in ``x @ w`` orientation.  The
reference's ``lax.scan``/``fori_loop`` over layers is a Python loop here,
and both caches are updated in place.  ``params["layers"]`` may also be
a list of per-layer dicts (the round step differentiates each layer's
slices).  With ``cfg.remat`` each layer of ``forward`` runs under
``torch.utils.checkpoint``, so its attention forward runs again in the
backward, as ``jax.checkpoint`` does.  On the card the attention's
gradient is the hand-written backward kernel (``ops.flash_attention``).
With ``cfg.num_experts`` the FFN is the reference's MoE (``_moe_ffn``):
top-k routing, capacity-bounded dispatch by gathers whose gradients are
gathers too, and the expert products as batched GEMMs.

The frontends are stubs, as in the reference: ``vit_stub`` (internvl2-2b)
puts ``batch["patch_embeds"]`` in the first ``frontend_tokens`` positions
and the loss leaves their labels out; ``audio_stub`` (seamless-m4t) feeds
``batch["frames"]`` to the encoder (``enc_layers``: non-causal blocks with
RoPE), whose output each decoder layer's cross-attention reads through
its own K and V projections.  The static path (``init_cache``,
``prefill``, ``decode_step``) serves every config of the module: prefill
takes the stand-ins, and keeps each layer's K and V of the encoder output
in ``xk`` / ``xv``.  The paged path (``init_paged_cache``,
``prefill_paged``, ``decode_step_paged``) has no cross-attention, as in
the reference, so it refuses an encoder config (``check_config(...,
paged=True)``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.kernels.ref import kv_quantize_int8
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       layer_list, rms_norm, rope,
                                       rope_tables, seeded_generator,
                                       softcap, stack_list)

FAMILIES = ("dense", "moe", "encdec")
# the frontend stubs lm computes: "audio_stub" is the encoder's input
FRONTENDS = ("", "vit_stub", "audio_stub")
PAGED_NO_ENCODER = (
    "the paged path has no cross-attention, as the reference's paged "
    "functions have none (lm.py:426-564; serving/engine.py:41 "
    "PAGED_FAMILIES): it would compute another model (ROADMAP.md §3); "
    "serve an encoder config through Engine.generate")


def check_config(cfg: ModelConfig, paged: bool = False):
    """Refuses a config lm does not compute: another family, a frontend
    other than ``FRONTENDS``, an encoder without its ``audio_stub``
    frames or the reverse; with ``paged``, an encoder (the paged path
    keeps no cross-attention cache)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"lm runs the families {FAMILIES}, not "
                         f"{cfg.family!r} (models/registry.py)")
    if cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} is not ported: lm computes "
            f"{FRONTENDS} (ROADMAP.md, modules to port, item 6)")
    encdec = cfg.family == "encdec"
    if encdec != bool(cfg.enc_layers) or \
            encdec != (cfg.frontend == "audio_stub"):
        raise ValueError(f"{cfg.name}: the encdec family, enc_layers and "
                         f"the audio_stub frontend go together")
    if paged and encdec:
        raise ValueError(f"{cfg.name}: {PAGED_NO_ENCODER}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig, cross: bool = False) -> Dict[str, tuple]:
    D, H, KH, Dh, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    s: Dict[str, tuple] = {
        "ln1": (D,), "ln2": (D,),
        "wq": (D, H * Dh), "wk": (D, KH * Dh), "wv": (D, KH * Dh),
        "wo": (H * Dh, D),
    }
    if cfg.qkv_bias:
        s.update(bq=(H * Dh,), bk=(KH * Dh,), bv=(KH * Dh,))
    if cross:
        s.update(lnx=(D,), wxq=(D, H * Dh), wxk=(D, KH * Dh),
                 wxv=(D, KH * Dh), wxo=(H * Dh, D))
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
        generator = seeded_generator(dev, seed)
    dt = dtype_of(cfg.param_dtype)

    def draw(shape):
        return dense_init(generator, shape, dt, dev)

    def stack(shapes, L):
        return {name: (torch.ones((L,) + shp, dtype=dt, device=dev)
                       if name.startswith("ln") else draw((L,) + shp))
                for name, shp in sorted(shapes.items())}

    params: Dict[str, Any] = {
        "emb": draw((cfg.vocab_padded, cfg.d_model)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "layers": stack(_layer_shapes(cfg, cross=cfg.cross_attention),
                        cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        params["out_head"] = draw((cfg.d_model, cfg.vocab_padded))
    if cfg.enc_layers:
        params["enc_layers"] = stack(_layer_shapes(_enc_cfg(cfg)),
                                     cfg.enc_layers)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=dev)
    return params


def _enc_cfg(cfg):
    """The encoder's config: the decoder's, with a dense FFN."""
    return cfg.replace(num_experts=0)


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


def _cross_kv(cfg, mem, w):
    """One decoder layer's K and V of the encoder output ``mem`` (B,
    S_enc, D), each (B, S_enc, KH, Dh) in the compute type: no RoPE."""
    B = mem.shape[0]
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    cd = dtype_of(cfg.compute_dtype)
    xk = (mem @ w["wxk"]).to(cd).reshape(B, -1, KH, Dh)
    xv = (mem @ w["wxv"]).to(cd).reshape(B, -1, KH, Dh)
    return xk, xv


def _cross_attention(cfg, x, w, mem_kv):
    """Cross-attention of x (B, S, D) over ``mem_kv`` (``_cross_kv``):
    queries from ``wxq`` with no RoPE, non-causal (reference lm.py:116)."""
    B, S, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    cd = dtype_of(cfg.compute_dtype)
    q = (x @ w["wxq"]).to(cd).reshape(B, S, H, Dh)
    k, v = mem_kv
    o = ops.flash_attention(q, k, v, causal=False)
    return o.reshape(B, S, H * Dh) @ w["wxo"]


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


def _decode_in(cfg, w, x, cos, sin):
    """A decode layer's attention input: RMS norm, then q (B, 1, H, Dh)
    and k with RoPE at the step's positions ``(cos, sin)``, and v (B, 1,
    KH, Dh)."""
    B = x.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, rms_norm(x, w["ln1"], cfg.norm_eps), w)
    return (rope(q.reshape(B, 1, H, Dh), (cos, sin)),
            rope(k.reshape(B, 1, KH, Dh), (cos, sin)), v.reshape(B, 1, KH, Dh))


def _decode_out(cfg, w, x, q, o_old, m_old, l_old, k, v):
    """The rest of a decode layer: the current token's (k, v) folded into
    the pool's partial attention (o_old, m_old, l_old), the output
    projection, the residual add and the FFN half."""
    o = ops.decode_attention_combine(q, o_old, m_old, l_old, k, v)
    x = x + o.reshape(x.shape[0], 1, -1) @ w["wo"]
    return _ffn_half(cfg, x, w)


def _same_tensor(a, b):
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride())


class DecodeGraphs:
    """A decode layer's work around its read of the pool, as CUDA graphs,
    two a layer and input shape, captured at first use: ``_decode_in``
    (RMS norm, q, k, v, RoPE) before the read and ``_decode_out`` (the
    combine, the output projection, the FFN half) after it.  For one set
    of weights, which keep their addresses between calls (an engine's).

    What touches the pool stays eager, since its address changes from
    serve to serve: the paged decode kernel (so no counted launch moves
    into a graph) and the K/V write.  A decode step is bound by the host's
    launches: a layer takes about ten where it took several dozen
    eagerly, more with the MoE's routing.  An input that is another
    graph's input or output, or a ``stage``d tensor, is read in place;
    any other is copied into the graph's own.  Outputs hold until their
    graph's next replay."""

    def __init__(self):
        self._graphs = {}
        self._staged = {}
        self._owned = set()  # data_ptrs that later captures read in place
        # every warm-up and capture on one side stream: cuBLAS keeps a
        # workspace for each stream it has run on, for the process's life
        self._stream = None

    def stage(self, *tensors):
        """``tensors`` copied into buffers kept for their shapes, which
        every graph reads in place: the step's RoPE tables, copied once a
        step and not once a layer."""
        out = []
        for i, t in enumerate(tensors):
            key = (i, tuple(t.shape), t.dtype)
            if key not in self._staged:
                self._staged[key] = t.clone()
                self._owned.add(self._staged[key].data_ptr())
            else:
                self._staged[key].copy_(t)
            out.append(self._staged[key])
        return tuple(out)

    def run(self, name, layer, fn, cfg, w, *args):
        """``fn(cfg, w, *args)`` replayed as layer ``layer``'s graph
        ``name``."""
        key = (name, layer) + tuple((tuple(a.shape), a.dtype) for a in args)
        if key not in self._graphs:
            self._graphs[key] = self._capture(fn, cfg, w, args)
        static, out, graph = self._graphs[key]
        for s, a in zip(static, args):
            if not _same_tensor(s, a):
                s.copy_(a)
        graph.replay()
        return out

    def _capture(self, fn, cfg, w, args):
        static = tuple(a if a.data_ptr() in self._owned else a.clone()
                       for a in args)
        dev = args[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        side, main = self._stream, torch.cuda.current_stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # cuBLAS handle and workspace, pools
            for _ in range(2):
                fn(cfg, w, *static)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = fn(cfg, w, *static)
        for t in static + (out if isinstance(out, tuple) else (out,)):
            self._owned.add(t.data_ptr())
        return static, out, graph


def _embed(cfg, params, batch):
    """The token embeddings of ``batch["tokens"]``; with the ``vit_stub``
    frontend the first ``frontend_tokens`` positions are
    ``batch["patch_embeds"]`` (B, P, D), cast to the compute type."""
    x = params["emb"][batch["tokens"].long()].to(dtype_of(cfg.compute_dtype))
    if cfg.frontend == "vit_stub":
        P = cfg.frontend_tokens
        pe = batch["patch_embeds"].to(device=x.device, dtype=x.dtype)
        x = torch.cat([pe, x[:, P:]], dim=1)
    return x


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
# forward / loss (reference lm.py:293-385)
# ---------------------------------------------------------------------------

def _block(cfg, x, w, tables, mem=None, *, causal=True):
    """One block: self-attention (RoPE at ``tables``); with ``mem``, the
    encoder output, the cross-attention over this layer's K and V of it,
    made here (inside the layer's checkpoint, as in the reference's scan
    body); then the FFN half."""
    h = rms_norm(x, w["ln1"], cfg.norm_eps)
    attn_out, _ = _attention(cfg, h, w, tables, causal=causal,
                             window=cfg.window)
    x = x + attn_out
    if mem is not None:
        h = rms_norm(x, w["lnx"], cfg.norm_eps)
        x = x + _cross_attention(cfg, h, w, _cross_kv(cfg, mem, w))
    return _ffn_half(cfg, x, w)


def _run_stack(cfg, layers, x, tables, mem=None, *, causal=True):
    """x through each block of ``layers`` (per-layer dicts), each under
    ``torch.utils.checkpoint`` with ``cfg.remat`` while autograd
    records."""
    block = functools.partial(_block, cfg, causal=causal)
    for w in layers:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, tables, mem, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = block(x, w, tables, mem)
    return x


def _encode(cfg, params, frames):
    """The encoder over ``frames`` (B, S_enc, D), cast to the compute
    type: non-causal blocks with RoPE at arange(S_enc), then
    ``enc_norm`` (reference lm.py:324-332)."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    tables = _rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
    x = _run_stack(_enc_cfg(cfg), stack_list(params["enc_layers"]), x,
                   tables, causal=False)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, batch):
    """Teacher-forced logits (B, S, vocab_padded) of ``batch["tokens"]``
    (B, S), with the frontend's inputs: ``patch_embeds`` (B, P, D) for
    ``vit_stub``, ``frames`` (B, S_enc, D) for the encoder."""
    check_config(cfg)
    x = _embed(cfg, params, batch)
    tables = _rope_tables(cfg, torch.arange(x.shape[1], device=x.device))
    mem = (_encode(cfg, params, batch["frames"].to(x.device))
           if cfg.enc_layers else None)
    x = _run_stack(cfg, layer_list(params), x, tables, mem)
    return _logits(cfg, params, x)


def loss_fn(cfg: ModelConfig, params, batch):
    """Mean next-token cross entropy of ``batch["tokens"]`` in f32; with
    the ``vit_stub`` frontend the labels at positions below
    ``frontend_tokens`` are left out (reference lm.py:372-381)."""
    tokens = batch["tokens"]
    logits = forward(cfg, params, batch)
    labels = tokens[:, 1:]
    mask = None
    if cfg.frontend == "vit_stub":
        pos = torch.arange(labels.shape[1], device=labels.device)
        mask = (pos >= cfg.frontend_tokens).expand(labels.shape)
    return cross_entropy(logits[:, :-1], labels, mask)


# ---------------------------------------------------------------------------
# serving: the static cache (reference lm.py:388-400, 567-681)
# ---------------------------------------------------------------------------

def _embed_tokens(cfg, params, tokens):
    """The embeddings of ``tokens`` alone (a decode step's: the frontend
    stand-ins enter in prefill only)."""
    return params["emb"][tokens.long()].to(dtype_of(cfg.compute_dtype))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               enc_len: int = 0, device=None):
    """The static KV cache: ``k`` / ``v`` (L, B, max_len, KH, Dh) in the
    compute type and ``pos`` (a Python int, the positions written); with
    an encoder, ``xk`` / ``xv`` (L, B, enc_len, KH, Dh), each layer's K
    and V of the encoder output, written once by ``prefill``."""
    check_config(cfg)
    dev = resolve(device)
    L, KH, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cd = dtype_of(cfg.compute_dtype)
    zeros = lambda n: torch.zeros((L, batch_size, n, KH, Dh), dtype=cd,
                                  device=dev)
    cache = {"k": zeros(max_len), "v": zeros(max_len), "pos": 0}
    if cfg.enc_layers:
        cache["xk"], cache["xv"] = zeros(enc_len), zeros(enc_len)
    return cache


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt ``batch["tokens"]`` (B, S) (with the frontend's
    ``patch_embeds`` or ``frames``), write its K and V at positions 0..S-1
    of ``cache`` IN PLACE (with an encoder, also each layer's ``xk`` /
    ``xv``), set ``pos`` to S.  Returns (last-position logits (B, 1, V),
    cache)."""
    check_config(cfg)
    x = _embed(cfg, params, batch)
    B, S, D = x.shape
    if S > cache["k"].shape[2]:
        raise ValueError(f"prompt of {S} positions over a cache of "
                         f"{cache['k'].shape[2]}")
    tables = _rope_tables(cfg, torch.arange(S, device=x.device))
    mem = None
    if cfg.enc_layers:
        mem = _encode(cfg, params, batch["frames"].to(x.device))
        if mem.shape[1] != cache["xk"].shape[2]:
            raise ValueError(f"{mem.shape[1]} frames for a cross-attention "
                             f"cache of {cache['xk'].shape[2]}")
    for l, w in enumerate(layer_list(params)):
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        attn_out, (k_new, v_new) = _attention(cfg, h, w, tables,
                                              causal=True, window=cfg.window)
        x = x + attn_out
        cache["k"][l, :, :S] = k_new
        cache["v"][l, :, :S] = v_new
        if mem is not None:
            xk, xv = _cross_kv(cfg, mem, w)
            cache["xk"][l] = xk
            cache["xv"][l] = xv
            h = rms_norm(x, w["lnx"], cfg.norm_eps)
            x = x + _cross_attention(cfg, h, w, (xk, xv))
        x = _ffn_half(cfg, x, w)
    cache["pos"] = S
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: ModelConfig, params, cache, tokens):
    """One-token decode over the static cache, IN PLACE.  tokens: (B, 1).
    Returns (logits (B, 1, V), cache).

    As the reference: each layer attends the PRE-update cache at kv_len =
    min(pos, max_len) through ``ops.decode_attention`` (plain PyTorch on
    every device, as the reference's jnp route is on the TPU), folds the
    token in with ``decode_attention_combine``, then writes its K and V at
    slot ``pos`` (``pos % max_len`` with ``cfg.window``).  With an encoder
    the cross-attention reads ``xk`` / ``xv``: Sq = 1 over the encoder's
    length, through ``ops.flash_attention`` (the kernel on the card)."""
    check_config(cfg)
    B = tokens.shape[0]
    H, KH, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pos, T = cache["pos"], cache["k"].shape[2]
    if pos >= T and not cfg.window:
        raise ValueError(f"decode at position {pos} past a cache of {T}")
    slot = pos % T if cfg.window else pos
    x = _embed_tokens(cfg, params, tokens)
    tables = _rope_tables(cfg, torch.full((B, 1), pos, device=x.device))
    kv_len = torch.full((B,), min(pos, T), dtype=torch.int32,
                        device=x.device)
    for l, w in enumerate(layer_list(params)):
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, h, w)
        q = rope(q.reshape(B, 1, H, Dh), tables)
        k = rope(k.reshape(B, 1, KH, Dh), tables)
        v = v.reshape(B, 1, KH, Dh)
        k_l, v_l = cache["k"][l], cache["v"][l]
        o_old, m_old, l_old = ops.decode_attention(q, k_l, v_l, kv_len=kv_len,
                                                   return_stats=True)
        o = ops.decode_attention_combine(q, o_old, m_old, l_old, k, v)
        k_l[:, slot] = k[:, 0]
        v_l[:, slot] = v[:, 0]
        x = x + o.reshape(B, 1, H * Dh) @ w["wo"]
        if cfg.enc_layers:
            h = rms_norm(x, w["lnx"], cfg.norm_eps)
            x = x + _cross_attention(cfg, h, w,
                                     (cache["xk"][l], cache["xv"][l]))
        x = _ffn_half(cfg, x, w)
    cache["pos"] = pos + 1
    return _logits(cfg, params, x), cache


# ---------------------------------------------------------------------------
# serving: the paged pool (reference lm.py:403-564)
# ---------------------------------------------------------------------------

KV_DTYPES = (None, "int8")


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     kv_dtype: str = None, device=None):
    """Paged KV pool: one (L, num_pages, page_size, KH, Dh) buffer per K/V
    in the compute type, page 0 reserved as the null page.  ``kv_dtype=
    "int8"`` stores block-scaled int8 values and ``k_scale`` / ``v_scale``
    (L, num_pages, page_size, KH) f32, one scale a (page, position, head)
    head_dim block (``ref.kv_quantize_int8``)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
    dev = resolve(device)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    vd = torch.int8 if kv_dtype == "int8" else dtype_of(cfg.compute_dtype)
    cache = {"k": torch.zeros(shape, dtype=vd, device=dev),
             "v": torch.zeros(shape, dtype=vd, device=dev)}
    if kv_dtype == "int8":
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1], dtype=torch.float32,
                                      device=dev)
    return cache


def _write_kv(cache, l, idx, k, v):
    """Write K and V rows at ``idx`` (an index tuple into a layer's pool)
    of layer l, quantized where the pool is int8."""
    for name, t in (("k", k), ("v", v)):
        if "k_scale" in cache:
            tq, ts = kv_quantize_int8(t)
            cache[name][l].index_put_(idx, tq)
            cache[name + "_scale"][l].index_put_(idx, ts)
        else:
            cache[name][l].index_put_(idx, t.to(cache[name].dtype))


def prefill_paged(cfg: ModelConfig, params, batch, cache, page_table,
                  prompt_len):
    """Prompt prefill writing KV through the page table, IN PLACE.

    batch["tokens"]: (B, S_pad) right-padded prompts with S_pad a multiple
    of the page size (and ``patch_embeds`` for the ViT stub, as the
    reference's function takes them); page_table: (B, P) physical page
    ids; prompt_len: (B,) true prompt lengths.  Returns logits at position
    prompt_len-1 per row (B, 1, V); ``cache`` is updated in place (int8
    with its scales where the pool is) and returned.

    Positions >= prompt_len hold pad garbage in the written pages: reads
    are masked by kv_len and decode overwrites them as the request grows.
    Table entries past a request's own pages are the null page 0, so
    several rows may write page 0 in one call; which write lands does not
    matter, because page 0 is never read unmasked.
    """
    check_config(cfg, paged=True)
    x = _embed(cfg, params, batch)
    B, S, D = x.shape
    ps = cache["k"].shape[2]
    if S % ps:
        raise ValueError(f"prefill length {S} is not a multiple of the page "
                         f"size {ps}")
    Pp = S // ps
    KH, Dh = cfg.num_kv_heads, cfg.head_dim
    tables = _rope_tables(cfg, torch.arange(S, device=x.device))
    phys = (page_table[:, :Pp].long(),)  # (B, Pp)
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        h = rms_norm(x, w["ln1"], cfg.norm_eps)
        attn_out, (k_new, v_new) = _attention(cfg, h, w, tables,
                                              causal=True, window=cfg.window)
        x = _ffn_half(cfg, x + attn_out, w)
        _write_kv(cache, l, phys, k_new.reshape(B, Pp, ps, KH, Dh),
                  v_new.reshape(B, Pp, ps, KH, Dh))
    idx = (prompt_len.long() - 1)[:, None, None].expand(B, 1, D)
    logits = _logits(cfg, params, torch.gather(x, 1, idx))
    return logits, cache


def decode_step_paged(cfg: ModelConfig, params, cache, tokens, page_table,
                      kv_len, graphs: DecodeGraphs = None,
                      contiguous: bool = False):
    """One-token decode through the page table, updating ``cache`` IN PLACE.

    tokens: (B, 1); page_table: (B, P) int32; kv_len: (B,) int32 per-request
    lengths (0 for empty decode slots: their reads are fully masked and
    their writes land on the null page).  Returns (logits (B, 1, V), cache).

    Attend-then-write, as the reference: ``ops.paged_decode_attention``
    reads the pre-update pages (the kernel on the card for a pool in the
    compute type; the gather, the dequantization and the direct decode for
    an int8 pool or ``contiguous``, the reference's routing),
    ``decode_attention_combine`` folds the current token in, and only
    then is the token's (k, v) written at (phys, off), quantized in an
    int8 pool.  Empty slots all write page 0 at offset 0; their order does
    not matter, because page 0 is never read unmasked.  ``contiguous``
    asserts that slot b owns pages [1 + b P, 1 + (b + 1) P).  With
    ``graphs`` (a ``DecodeGraphs``, on the card) each layer's work before
    and after its read of the pool replays as two CUDA graphs.
    """
    check_config(cfg, paged=True)
    ps = cache["k"].shape[2]
    kv_len = kv_len.to(torch.int32)
    tables = _rope_tables(cfg, kv_len[:, None])  # per-request positions
    x = _embed_tokens(cfg, params, tokens)
    pj = torch.div(kv_len, ps, rounding_mode="floor")
    phys = torch.gather(page_table, 1, pj[:, None].long())[:, 0].long()
    off = (kv_len % ps).long()
    quant = "k_scale" in cache
    if graphs is None:
        run = lambda name, l, fn, *args: fn(*args)  # noqa: E731
    else:
        tables, run = graphs.stage(*tables), graphs.run
    for l in range(cfg.num_layers):
        w = _layer(params, l)
        q, k, v = run("in", l, _decode_in, cfg, w, x, *tables)
        scales = (dict(k_scale=cache["k_scale"][l],
                       v_scale=cache["v_scale"][l]) if quant else {})
        o_old, m_old, l_old = ops.paged_decode_attention(
            q, cache["k"][l], cache["v"][l], page_table, kv_len,
            contiguous=contiguous, **scales)
        x = run("out", l, _decode_out, cfg, w, x, q, o_old, m_old, l_old, k,
                v)
        _write_kv(cache, l, (phys, off), k[:, 0], v[:, 0])
    return _logits(cfg, params, x), cache
