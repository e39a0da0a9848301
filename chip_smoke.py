#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit):

1. print the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the build time;
2. flash-attention prefill kernel vs its plain version at the qwen2-7b
   shapes (B=1, H=28, KH=4, Dh=128, bf16, causal, S in {144, 512, 2048} and
   the serve trace's padded prompt length), plus an f32 case and a
   window/q_offset case at Dh=64;
3. paged-decode kernel vs its plain version at the serve shapes (B=8,
   ps=16, KH=4, G=7, Dh=128, bf16; a permuted page table and ragged
   kv_len including 0 and a length that is not a page multiple);
4. the serving path: first a small f32 model's prefill and decode steps on
   the card (kernels) must give the CPU's logits (plain versions) within
   1e-4; then qwen2-7b at full width (bf16, seeded random weights)
   serves 16 Poisson requests, with every launch counted;
5. top-k compression kernel vs its plain version, bit for bit (int32 /
   int16 views): the reference's test grid in f32 and bf16 with ef absent,
   of x's type and f32; an all-zero block, tied magnitudes, theta = 1 and
   k = 1; every ResNet-20 leaf at R = 64, block 256 (the round's 59
   launches, timed together); FEMNIST's fc1_w at R = 64 (timed);
6. the FedSim path: a small MLP FedSim runs 3 rounds on the card (kernel)
   and on the CPU (plain version) from the same parameters and bits; the
   histories agree within FEDSIM_RTOL;
7. the HCEF round at full width: ResNet-20 on the synthetic CIFAR-10
   stand-in, 64 devices in 8 clusters, the configuration's budgets,
   FEDSIM_ROUNDS rounds (two of them gossip rounds), then the averaged
   model's accuracy, with every top-k launch counted.

It prints one JSON line of per-kernel numbers and, last, the device line.
It needs one CUDA card and the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # tests/test_kernels.py:13
F32_TOL = dict(atol=2e-5, rtol=2e-5)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM
PEAK_BYTES = 3.35e12
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2
SLOTS, PAGE = 8, 16  # the engine's decode slots and page size in phase 4
TOPK_GRID = [(1, 2048, 256), (4, 4096, 512), (3, 1024, 1024)]  # test_kernels
# phase 6: card vs CPU histories of the same small FedSim.  Both are f32;
# sums run in other orders, and a coordinate at a top-k threshold may be
# kept on one side only, so the history is held to a relative tolerance.
FEDSIM_RTOL = 1e-3
FEDSIM_ROUNDS = 12  # phase 7: gossip at rounds 5 and 10 (q = 5)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_flush_buf = None


def time_ms(fn, iters=10, warmup=2):
    """Mean device time of ``fn`` over ``iters`` runs, each after an L2
    flush (the serve path finds its KV and activations cold: every decode
    step streams all weights through the cache)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        _flush_buf.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in evs) / iters


def max_err(a, b, tol):
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= tol["atol"] + tol["rtol"] * b.abs()).all())
    return float(err.max()), ok


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


# ---------------------------------------------------------------------------
# phase 2: prefill kernel
# ---------------------------------------------------------------------------

def live_pairs(Sq, Skv, causal, window, q_offset):
    """(query, key) pairs the mask keeps: the work this input needs."""
    qpos = q_offset + np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    return int(keep.sum())


def prefill_case(fa, gen, *, S, H, KH, Dh, dtype, window=0, q_offset=0,
                 Skv=None):
    Skv = Skv or S
    q = torch.randn((1, S, H, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Skv, KH, Dh), generator=gen, device="cuda").to(dtype)
    v = torch.randn((1, Skv, KH, Dh), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, **kw)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err, ok = max_err(out, ref, tol)
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                       iters=3, warmup=1)
    library_ms = None
    if not window and not q_offset and Skv == S:
        G = H // KH
        qt = q.transpose(1, 2).contiguous()
        kt = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        vt = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    pairs = live_pairs(S, Skv, True, window, q_offset)
    flops = 4 * Dh * H * pairs  # q.k and p.v, 2 ops per multiply-add
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    row = dict(S=S, Skv=Skv, H=H, KH=KH, Dh=Dh, dtype=str(dtype)[6:],
               window=window, q_offset=q_offset, max_abs_err=err,
               tol=tol["atol"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=library_ms)
    print("prefill " + json.dumps(row))
    if not ok:
        fail(f"flash-attention kernel disagrees with the plain version: {row}")
    return row


# ---------------------------------------------------------------------------
# phase 3: paged decode kernel
# ---------------------------------------------------------------------------

def decode_case(fa, gen, *, B, P, ps, KH, G, Dh, dtype, kv_len):
    H = KH * G
    NP = 1 + B * P
    q = torch.randn((B, 1, H, Dh), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((NP, ps, KH, Dh), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((NP, ps, KH, Dh), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(NP - 1, generator=gen, device="cuda") + 1
    table = perm.to(torch.int32).reshape(B, P).contiguous()
    kl = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    o, m, l = fa.paged_decode_attention_cuda(q, kp, vp, table, kl)
    torch.cuda.synchronize()
    o_p, m_p, l_p = fa.paged_decode_attention_plain(q, kp, vp, table, kl)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err_o, ok_o = max_err(o, o_p, tol)
    err_m, ok_m = max_err(m, m_p, tol)
    err_l, ok_l = max_err(l, l_p, tol)
    empty = [b for b, n in enumerate(kv_len) if n == 0]
    ok_empty = all(bool((o[b] == 0).all()) and bool((m[b] == -1e30).all())
                   and bool((l[b] == 1e-20).all()) for b in empty)
    ms = time_ms(lambda: fa.paged_decode_attention_cuda(q, kp, vp, table, kl))
    plain_ms = time_ms(
        lambda: fa.paged_decode_attention_plain(q, kp, vp, table, kl))

    mask = (torch.arange(P * ps, device="cuda")[None, :] < kl[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)  # (B, H, 1, Dh)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        k = fa.gather_kv_pages(kp, table).transpose(1, 2)
        v = fa.gather_kv_pages(vp, table).transpose(1, 2)
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        return sdpa(qt, k, v, attn_mask=mask)

    library_ms = time_ms(library)
    n_kv = int(sum(kv_len))
    flops = 4 * Dh * H * n_kv
    nbytes = (2 * n_kv * KH * Dh * kp.element_size()      # live K and V
              + 2 * q.numel() * q.element_size()          # q, out
              + 2 * m.numel() * 4 + table.numel() * 4 + B * 4)
    bound_ms, bound_by = bound(flops, nbytes, dtype)
    # max_abs_err is the output's; m and l are held to the same atol+rtol
    # (l is a sum of up to kv_len terms, so its absolute error scales).
    row = dict(B=B, P=P, ps=ps, KH=KH, G=G, Dh=Dh, dtype=str(dtype)[6:],
               kv_len=list(kv_len), max_abs_err=err_o, err_m=err_m,
               err_l=err_l, tol=tol["atol"], ms=ms,
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               library_ms=library_ms)
    print("decode " + json.dumps(row))
    if not (ok_o and ok_m and ok_l and ok_empty):
        fail(f"paged-decode kernel disagrees with the plain version "
             f"(empty slots exact: {ok_empty}): {row}")
    return row


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------

class Recorder:
    """Stands in for the engine's model module: counts prefills and decode
    steps, times each call to its logits (the engine synchronises there
    anyway, to sample), and keeps a device flag per call that all logits
    were finite."""

    def __init__(self, model):
        self.model = model
        self.init_paged_cache = model.init_paged_cache
        self.ms = {"prefill": [], "decode": []}
        self.finite = []

    @property
    def prefills(self):
        return len(self.ms["prefill"])

    @property
    def decode_steps(self):
        return len(self.ms["decode"])

    def _call(self, kind, fn, *a, **kw):
        t0 = time.perf_counter()
        logits, cache = fn(*a, **kw)
        torch.cuda.synchronize()
        self.ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.finite.append(torch.isfinite(logits).all())
        return logits, cache

    def prefill_paged(self, *a, **kw):
        return self._call("prefill", self.model.prefill_paged, *a, **kw)

    def decode_step_paged(self, *a, **kw):
        return self._call("decode", self.model.decode_step_paged, *a, **kw)


def small_path_agrees(lm, configs):
    """prefill_paged + 5 decode_step_paged of a small f32 qwen2-shaped model
    on the card (kernels) against the same calls on the CPU (plain
    versions, which the CPU tests hold to the JAX package), fed the same
    tokens: logits within 1e-4.  One decode slot is empty (kv_len 0)."""
    cfg = configs.smoke_model(configs.get_config("qwen2_7b").model)
    params = lm.init(cfg, seed=1, device="cpu")
    on_gpu = {k: ({n: w.cuda() for n, w in v.items()}
                  if isinstance(v, dict) else v.cuda())
              for k, v in params.items()}
    rng = np.random.default_rng(1)
    B, ps, P, S = 4, 16, 4, 32
    NP = 1 + B * P
    table = rng.permutation(np.arange(1, NP)).astype(np.int32).reshape(B, P)
    table[3] = 0  # the empty slot's row is null
    plen = np.array([5, 16, 30, 1], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    runs = {}
    for dev, p in (("cpu", params), ("cuda", on_gpu)):
        cache = lm.init_paged_cache(cfg, NP, ps, device=dev)
        logits, cache = lm.prefill_paged(
            cfg, p, {"tokens": torch.as_tensor(toks[:3], device=dev)}, cache,
            torch.as_tensor(table[:3], device=dev),
            torch.as_tensor(plen[:3], device=dev))
        runs[dev] = [p, cache, [logits.cpu()]]
    kv_len = plen.copy()
    kv_len[3] = 0
    tok = torch.argmax(runs["cpu"][2][0][:, -1], -1)
    tok = torch.cat([tok, torch.zeros(1, dtype=tok.dtype)])
    for _ in range(5):
        for dev, run in runs.items():
            logits, run[1] = lm.decode_step_paged(
                cfg, run[0], run[1], tok[:, None].to(dev),
                torch.as_tensor(table, device=dev),
                torch.as_tensor(kv_len, device=dev))
            run[2].append(logits.cpu())
        tok = torch.argmax(runs["cpu"][2][-1][:, -1], -1)
        kv_len[:3] += 1
    diff = max(float((a - b).abs().max())
               for a, b in zip(runs["cpu"][2], runs["cuda"][2]))
    print(f"small path: card vs CPU max |logit diff| {diff:.3e} over "
          f"1 prefill + 5 decode steps")
    if not diff <= 1e-4:
        fail("the serving path on the card disagrees with the CPU path")


def serve_full(lm, engine_mod, cfg, fa, reqs, poisson_requests):
    """Serve ``reqs`` with qwen2-7b at full width; check and print the
    serve's numbers; return the kernels' launch counts of that serve."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm.init(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    n_params = lm.param_count(params)
    print(f"qwen2-7b full width: {n_params} params "
          f"({n_params * 2 / 1e9:.2f} GB bf16) initialised in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = engine_mod.Engine(cfg, params, device="cuda",
                            paged=engine_mod.PagedConfig(page_size=PAGE,
                                                         max_slots=SLOTS))
    # warm-up: cuBLAS handles, allocator pools (not measured or counted)
    eng.serve(poisson_requests(2, 1e6, 32, 4, cfg.vocab_size, seed=7))
    rec = Recorder(eng.model)
    eng.model = rec
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)

    L = cfg.num_layers
    bad = [r.rid for r in reqs
           if r.rid not in outs or len(outs[r.rid].tokens) != r.max_new_tokens
           or outs[r.rid].finish_reason != "length"]
    if bad:
        fail(f"requests without their full budget of tokens: {bad}")
    if not bool(torch.stack(rec.finite).all()):
        fail("non-finite logits on the serve path")
    if rec.prefills != len(reqs):
        fail(f"{rec.prefills} prefills for {len(reqs)} requests")
    if not (launches["flash_attention"] == L * rec.prefills > 0
            and launches["paged_decode_attention"] == L * rec.decode_steps
            > 0):
        fail(f"launch counts {launches} != {L} x ({rec.prefills} prefills, "
             f"{rec.decode_steps} decode steps)")
    n_tok = sum(len(o.tokens) for o in outs.values())
    ttft = np.array([o.ttft for o in outs.values()]) * 1e3
    tpot = np.array([o.tpot for o in outs.values()]) * 1e3
    stats = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                 tok_per_s=n_tok / wall,
                 ttft_p50_ms=float(np.percentile(ttft, 50)),
                 ttft_p99_ms=float(np.percentile(ttft, 99)),
                 tpot_p50_ms=float(np.percentile(tpot, 50)),
                 prefills=rec.prefills, decode_steps=rec.decode_steps,
                 prefill_ms_total=sum(rec.ms["prefill"]),
                 prefill_ms_p50=float(np.percentile(rec.ms["prefill"], 50)),
                 decode_ms_total=sum(rec.ms["decode"]),
                 decode_step_ms_p50=float(np.percentile(rec.ms["decode"],
                                                        50)),
                 launches=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 prompt_lens=[len(r.prompt) for r in reqs],
                 max_new=[r.max_new_tokens for r in reqs])
    print("serve " + json.dumps(stats))
    return launches


# ---------------------------------------------------------------------------
# phase 5: top-k compression kernel
# ---------------------------------------------------------------------------

def _raw(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def topk_case(tk, gen, *, R, L, block, dtype, ef_dtype=None, theta=None,
              x=None, ef=None, label=""):
    """The kernel and the plain version on the same inputs, bit for bit;
    masked + resid == x + ef exactly where both are f32.  Returns the
    largest |difference| (0 when the bits agree)."""
    if x is None:
        x = torch.randn((R, L), generator=gen, device="cuda").to(dtype)
    if ef is None and ef_dtype is not None:
        ef = (0.3 * torch.randn((R, L), generator=gen,
                                device="cuda")).to(ef_dtype)
    if theta is None:
        theta = 0.05 + 0.95 * torch.rand((R,), generator=gen, device="cuda")
    got = tk.topk_compress_cuda(x, theta, ef=ef, block=block)
    torch.cuda.synchronize()
    want = tk.topk_compress_plain(x, theta, ef=ef, block=block)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    same = all(a.dtype == b.dtype and torch.equal(_raw(a), _raw(b))
               for a, b in zip(got, want))
    if not same:
        fail(f"top-k kernel differs from the plain version ({label} R={R} "
             f"L={L} block={block} {dtype} ef={ef_dtype}): max |diff| "
             f"{err}")
    if x.dtype == torch.float32 and (ef is None
                                     or ef.dtype == torch.float32):
        total = x if ef is None else x + ef
        if not torch.equal(got[0] + got[1], total):
            fail(f"masked + residual != x + ef ({label} R={R} L={L})")
    return err


def _edge_inputs(block):
    """Row 0: an all-zero block, then tied magnitudes; row 1: five
    distinct magnitudes, then random normals."""
    g = torch.Generator(device="cuda").manual_seed(7)
    x = torch.zeros((2, 2 * block), device="cuda")
    sign = torch.randint(0, 2, (block,), generator=g, device="cuda") * 2 - 1
    x[0, block:] = 1.5 * sign
    vals = torch.tensor([-2.0, -0.5, 0.5, 1.0, 2.0], device="cuda")
    x[1, :block] = vals[torch.randint(0, 5, (block,), generator=g,
                                      device="cuda")]
    x[1, block:] = torch.randn((block,), generator=g, device="cuda")
    return x


def topk_bytes(x, ef):
    """Each input read once, each output written once (masked in x's
    type, residual in ef's)."""
    reads = x.element_size() + (0 if ef is None else ef.element_size())
    writes = x.element_size() + (x if ef is None else ef).element_size()
    return x.numel() * (reads + writes)


def topk_phase(tk, leaf_shapes, femnist_fc1):
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = 0.0
    n_cases = 0
    for R, L, block in TOPK_GRID:
        for dtype in (torch.float32, torch.bfloat16):
            for ef_dtype in (None, dtype, torch.float32):
                worst = max(worst, topk_case(tk, gen, R=R, L=L, block=block,
                                             dtype=dtype, ef_dtype=ef_dtype,
                                             label="grid"))
                n_cases += 1
    for dtype in (torch.float32, torch.bfloat16):
        x = _edge_inputs(256).to(dtype)
        for th in (1.0, 1e-4, 0.3):  # everything kept; k = 1; ties
            theta = torch.full((2,), th, device="cuda")
            for ef_dtype in (None, torch.float32):
                ef = None
                if ef_dtype is not None:  # keeps the zero block zero
                    ef = torch.zeros((2, 512), device="cuda")
                    ef[1] = 0.25 * torch.randn((512,), generator=gen,
                                               device="cuda")
                worst = max(worst, topk_case(
                    tk, gen, R=2, L=512, block=256, dtype=dtype, x=x,
                    ef=ef, theta=theta, label=f"edge theta={th}"))
                n_cases += 1
        if tk.topk_compress_cuda(x, torch.full((2,), 0.3, device="cuda"),
                                 block=256)[0][0, :256].any():
            fail("top-k kernel kept a nonzero in an all-zero block")

    # the main path: every ResNet-20 leaf, padded to the block, at R = 64,
    # f32 delta and f32 EF, theta as the controller hands it over (f32)
    R, block = 64, 256
    xs, efs = [], []
    for shape in leaf_shapes:
        L = int(np.prod(shape))
        Lp = L + (-L) % block
        xs.append(torch.randn((R, Lp), generator=gen, device="cuda"))
        efs.append(0.3 * torch.randn((R, Lp), generator=gen, device="cuda"))
    theta = 0.05 + 0.95 * torch.rand((R,), generator=gen, device="cuda")
    for x, ef in zip(xs, efs):
        worst = max(worst, topk_case(tk, gen, R=R, L=x.shape[1], block=block,
                                     dtype=torch.float32, x=x, ef=ef,
                                     theta=theta, label="resnet20 leaf"))
        n_cases += 1
    round_k = lambda: [tk.topk_compress_cuda(x, theta, ef=e, block=block)
                       for x, e in zip(xs, efs)]
    round_p = lambda: [tk.topk_compress_plain(x, theta, ef=e, block=block)
                       for x, e in zip(xs, efs)]
    nbytes = sum(topk_bytes(x, e) for x, e in zip(xs, efs))
    ms = time_ms(round_k)
    plain_ms = time_ms(round_p, iters=3, warmup=1)
    bound_ms, bound_by = bound(0, nbytes, torch.float32)
    main = dict(case="resnet20 round: 59 leaves, R=64, block 256, f32 x/ef",
                elements=sum(x.numel() for x in xs), bytes=nbytes,
                launches_timed=len(xs), max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)
    print("topk " + json.dumps(main))

    # where the kernel does real work: FEMNIST-CNN's fc1_w at R = 64
    L = int(np.prod(femnist_fc1))
    x = torch.randn((R, L), generator=gen, device="cuda")
    ef = 0.3 * torch.randn((R, L), generator=gen, device="cuda")
    err = topk_case(tk, gen, R=R, L=L, block=block, dtype=torch.float32,
                    x=x, ef=ef, theta=theta, label="femnist fc1_w")
    nbytes = topk_bytes(x, ef)
    bound_f, by_f = bound(0, nbytes, torch.float32)
    big = dict(case=f"femnist fc1_w {tuple(femnist_fc1)}, R=64, block 256, "
               f"f32 x/ef", elements=x.numel(), bytes=nbytes,
               max_abs_err=err,
               ms=time_ms(lambda: tk.topk_compress_cuda(x, theta, ef=ef,
                                                        block=block)),
               plain_ms=time_ms(lambda: tk.topk_compress_plain(
                   x, theta, ef=ef, block=block), iters=3, warmup=1),
               bound_ms=bound_f, bound_by=by_f, library_ms=None)
    print("topk " + json.dumps(big))
    print(f"topk: {n_cases + 1} cases bitwise equal to the plain version")
    del x, ef, xs, efs
    torch.cuda.empty_cache()
    main["max_abs_err"] = max(worst, err)
    return main


# ---------------------------------------------------------------------------
# phases 6 and 7: the FedSim round
# ---------------------------------------------------------------------------

HIST_KEYS = ("loss", "rho_mean", "theta_mean", "time", "energy")


def fedsim_agrees(fedsim):
    """A small MLP FedSim (8 devices in 4 clusters, the ResNet-20
    configuration's round and budgets) for 3 rounds on the card and on the
    CPU, from the same parameters and masked-step bits."""
    def three_rounds(dev):
        sim = fedsim.make_sim("hcef", model="mlp", n_devices=8, n_clusters=4,
                              n_train=2048, device=dev)
        return [sim.run_round() for _ in range(3)]

    cpu, card = three_rounds("cpu"), three_rounds("cuda")
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                for a, b in zip(card, cpu) for k in HIST_KEYS)
    print(f"fedsim small: card vs CPU over 3 rounds, largest relative "
          f"deviation of {HIST_KEYS} {worst:.3e} (tolerance {FEDSIM_RTOL}); "
          f"theta_mean {[round(h['theta_mean'], 4) for h in card]}")
    if not worst <= FEDSIM_RTOL:
        fail("the FedSim path on the card disagrees with the CPU path")


def fedsim_full(fedsim, tk):
    """ResNet-20 at the paper's topology: FEDSIM_ROUNDS rounds of
    ``FedSim.run`` as the launcher drives it, every top-k launch counted."""
    t0 = time.perf_counter()
    sim = fedsim.make_sim("hcef", model="resnet20", device="cuda")
    torch.cuda.synchronize()
    n_leaves = len(sim.params)
    n_params = sum(p[0].numel() for p in sim.params.values())
    print(f"fedsim resnet20: {n_params} params in {n_leaves} leaves, "
          f"{sim.cfg.n_devices} devices in {sim.cfg.n_clusters} clusters, "
          f"set up in {time.perf_counter() - t0:.1f} s")
    sim.timings = {}
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    sim.run(FEDSIM_ROUNDS, eval_every=5,
            on_round=fedsim.print_round(sim, "resnet20 "))
    launches = tk.LAUNCHES["topk_compress"]
    hist, walls = sim.history, sim.round_ms
    if len(hist) != FEDSIM_ROUNDS:
        fail(f"the run stopped after {len(hist)} of {FEDSIM_ROUNDS} rounds")
    if not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"non-finite loss: {[h['loss'] for h in hist]}")
    if not min(h["theta_mean"] for h in hist) < 1.0:
        fail("theta_mean is 1 in every round: Q dropped nothing")
    if launches != n_leaves * FEDSIM_ROUNDS:
        fail(f"{launches} top-k launches, expected {n_leaves} leaves x "
             f"{FEDSIM_ROUNDS} rounds")
    if sim.budget.l < 2:
        fail(f"{sim.budget.l} gossip rounds, expected 2")
    if any(b["time"] < a["time"] or b["energy"] < a["energy"]
           for a, b in zip(hist, hist[1:])):
        fail("simulated time or energy decreased")
    acc = hist[-1]["acc"]
    if not 0.0 <= acc <= 1.0:
        fail(f"accuracy {acc}")
    med = lambda v: float(np.percentile(v, 50))
    stats = dict(rounds=FEDSIM_ROUNDS, gossip_rounds=sim.budget.l,
                 round_wall_ms_p50=med(walls), round_wall_ms=walls,
                 phase_ms_p50={k: med(v) for k, v in sim.timings.items()},
                 launches=launches, acc=acc,
                 loss=[h["loss"] for h in hist],
                 theta_mean=[h["theta_mean"] for h in hist],
                 rho_mean=[h["rho_mean"] for h in hist],
                 time_s=hist[-1]["time"], energy_j=hist[-1]["energy"],
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print("fedsim " + json.dumps(stats))
    return launches


# ---------------------------------------------------------------------------

def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no port package under {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import topk_compress as tk
    from repro_torch.launch import fedsim
    from repro_torch.models.vision import make_vision_model
    from repro_torch.launch.serve import poisson_requests
    from repro_torch.models import lm
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.page_manager import pages_for

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 compared at 2e-5
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- phase 1 -------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build.lib()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc wall {build.build_seconds})")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas: " + line.strip())

    # the served stream fixes the main path's prefill and decode shapes:
    # every prefill runs at S_pad, every decode over `width` pages per slot
    cfg = configs.get_config("qwen2_7b").model
    reqs = poisson_requests(16, 50.0, 512, 64, cfg.vocab_size, seed=0,
                            min_prompt=16, min_new=16)
    S_pad = engine_mod._align(max(len(r.prompt) for r in reqs), PAGE)
    width = pages_for(S_pad + max(r.max_new_tokens for r in reqs), PAGE)

    # -- phase 2 -------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    qwen = dict(H=cfg.num_heads, KH=cfg.num_kv_heads, Dh=cfg.head_dim)
    main_prefill = None
    for S in sorted({144, 512, 2048, S_pad}):
        row = prefill_case(fa, gen, S=S, dtype=torch.bfloat16, **qwen)
        if S == S_pad:
            main_prefill = row
    prefill_case(fa, gen, S=512, dtype=torch.float32, **qwen)
    prefill_case(fa, gen, S=200, Skv=328, H=8, KH=2, Dh=64,
                 dtype=torch.float32, window=96, q_offset=128)
    prefill_case(fa, gen, S=256, H=8, KH=2, Dh=64, dtype=torch.bfloat16,
                 window=64)

    # -- phase 3 -------------------------------------------------------------
    kv_len = [0, 1, 16, 100, 257, 333, S_pad + 31, width * PAGE - 1]
    shape = dict(B=SLOTS, P=width, ps=PAGE, KH=cfg.num_kv_heads,
                 G=cfg.num_heads // cfg.num_kv_heads, Dh=cfg.head_dim,
                 kv_len=kv_len)
    main_decode = decode_case(fa, gen, dtype=torch.bfloat16, **shape)
    decode_case(fa, gen, dtype=torch.float32, **shape)

    # -- phase 4 -------------------------------------------------------------
    small_path_agrees(lm, configs)
    launches = serve_full(lm, engine_mod, cfg, fa, reqs, poisson_requests)

    # -- phase 5 -------------------------------------------------------------
    init = lambda m: make_vision_model(fedsim.vision_config(m))[0](
        torch.Generator().manual_seed(0))
    leaf_shapes = [tuple(p.shape) for p in init("resnet20").values()]
    fc1 = tuple(init("femnist_cnn")["fc1_w"].shape)
    main_topk = topk_phase(tk, leaf_shapes, fc1)

    # -- phases 6 and 7 ------------------------------------------------------
    fedsim_agrees(fedsim)
    launches["topk_compress"] = fedsim_full(fedsim, tk)

    # -- report --------------------------------------------------------------
    kernels = []
    for name, src, replaces, row in (
            ("flash_attention", "src/repro_torch/kernels/csrc/"
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:202",
             main_prefill),
            ("paged_decode_attention", "src/repro_torch/kernels/csrc/"
             "paged_decode.cu", "src/repro/kernels/flash_attention.py:90",
             main_decode),
            ("topk_compress", "src/repro_torch/kernels/csrc/"
             "topk_compress.cu", "src/repro/kernels/topk_compress.py:101",
             main_topk)):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
