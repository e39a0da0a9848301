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
   serves 16 Poisson requests, with every launch counted.

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

def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no port package under {SRC}: run from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
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

    # -- report --------------------------------------------------------------
    kernels = []
    for name, src, replaces, row in (
            ("flash_attention", "src/repro_torch/kernels/csrc/"
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:202",
             main_prefill),
            ("paged_decode_attention", "src/repro_torch/kernels/csrc/"
             "paged_decode.cu", "src/repro/kernels/flash_attention.py:90",
             main_decode)):
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
