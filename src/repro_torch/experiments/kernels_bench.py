"""Kernel and round-step microbenchmarks (port of
``benchmarks/kernels_bench.py``): ``name,us_per_call,derived`` CSV rows.

    PYTHONPATH=src python -m repro_torch.experiments.kernels_bench [--smoke]
    PYTHONPATH=src python -m repro_torch.experiments.kernels_bench \
        --smoke --device cpu

The reference's rows at its shapes, timed on the card with CUDA events
(on the CPU with the host clock), under its names:

- ``flash_attention_512``, ``ssd_chunked_1k``, ``topk_compress_8x1M``
  (f32, the reference's inputs) and ``rglru_assoc_2k``;
- ``agg_dense_*``, ``agg_structured_*``, ``agg_fused_*``: the round's
  aggregation W = B^T diag(1/Dev) H B over (R, d) f32 rows of the paper's
  two vision models, as the dense (R, R) product, the (C, R) GEMM the
  off-mesh round uses, and the fused branch's ``mix_local`` at one
  process (the reference's shard_map over 8 fake devices);
- ``round_{dense,sparse}_gossip_th*``, ``round_sparse_pc_gossip_*``,
  ``round_overlap_stale1_gossip``: the smoke smollm's HCEF round step with
  a policy (the fused branch), dense or over the sparse wire, at each
  level, per-cluster levels, and the overlapped engine at staleness 1;
  ``round_overlap_model_smollm``: the cost model's overlapped round.

A row whose op runs a hand-written kernel on the card (the attention
forward, the SSD scan, the top-k, and the round rows, whose top-k and
wire go through ``impl``) has a twin, ``<name>_plain``, that runs the
plain version on the same inputs; the ``derived`` column starts with the
route (``kernel`` / ``plain``; on the CPU both are the plain version).
The RG-LRU, the aggregations and the cost model have no kernel.  The
model's attention in the round rows takes its kernel in both twins.
``--smoke`` times one call after a warm-up (the reference: 10, 5 for the
aggregations and rounds).  On the CPU the aggregation rows' d is cut to
CPU_MAX_DIM (FEMNIST's at R 128 would take 3.4 GB a copy), and their
``derived`` says so.  ``bench(...)`` also returns each row's output,
which ``chip_smoke.py`` holds to its twin's.  The rows go to
``common.RESULTS / "kernels.json"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.kernels import ops
from repro_torch.tree import flatten

ROUND_LEVELS = (0.1, 0.4, 1.0)
AGG_ARCHS, AGG_RS = ("femnist_cnn", "resnet20_cifar10"), (16, 64, 128)
CPU_MAX_DIM = 1 << 12
SEED = 0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench(fn, dev, iters):
    """(us per call, the warm-up call's output): CUDA events around
    ``iters`` calls on the card, the host clock on the CPU."""
    out = fn()
    _sync(dev)
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3, out
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6, out


def _route(dev):
    return "kernel" if dev.type == "cuda" else "plain"


def kernel_rows(dev, iters, rng):
    """The four op rows, each kernel's with its ``_plain`` twin: [(name,
    us, derived, output)]."""
    rows = []
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)

    def twin(name, fn, derived):
        for impl, route in ((None, _route(dev)), ("plain", "plain")):
            us, out = _bench(lambda: fn(impl), dev, iters)
            rows.append((name if impl is None else name + "_plain", us,
                         f"{route}|{derived(us)}", out))

    B, S, H, KH, Dh = 1, 512, 8, 2, 64
    q = t(rng.normal(size=(B, S, H, Dh)))
    k = t(rng.normal(size=(B, S, KH, Dh)))
    v = t(rng.normal(size=(B, S, KH, Dh)))
    fl = 2 * B * H * S * S * Dh * 2 / 2
    twin("flash_attention_512",
         lambda impl: ops.flash_attention(q, k, v, causal=True, impl=impl),
         lambda us: f"{fl / us / 1e3:.2f}GFLOPs")

    b, s, h, p, g, n = 1, 1024, 8, 64, 1, 64
    x = t(rng.normal(size=(b, s, h, p)))
    dt = t(rng.uniform(0.01, 0.1, size=(b, s, h)))
    A = -torch.ones((h,), dtype=torch.float32, device=dev)
    Bm = t(rng.normal(size=(b, s, g, n)))
    Cm = t(rng.normal(size=(b, s, g, n)))
    twin("ssd_chunked_1k",
         lambda impl: ops.ssd(x, dt, A, Bm, Cm, chunk=64, impl=impl),
         lambda us: "chunk=64")

    from repro_torch.core import wire_format as wf
    xc = t(rng.normal(size=(8, 1 << 20)))
    th = torch.full((8,), 0.1, dtype=torch.float32, device=dev)
    L = xc.shape[1]

    def topk_derived(us):
        # input GB/s (the HBM traffic the compress reads) and the rate at
        # which it produces wire bytes at this theta (wire_format tables)
        gbps = xc.numel() * 4 / (us / 1e6) / 1e9
        wire = {wd: xc.shape[0] * min(wf.row_bytes(0.1, L, wire_dtype=wd),
                                      L * 4) / (us / 1e6) / 1e6
                for wd in ("f32", "int4")}
        return (f"{gbps:.2f}GB/s_in|wire_f32={wire['f32']:.0f}MB/s"
                f"|wire_int4={wire['int4']:.0f}MB/s")
    twin("topk_compress_8x1M",
         lambda impl: ops.topk_compress(xc, th, block=1024, impl=impl),
         topk_derived)

    la = -t(rng.uniform(0.01, 1, size=(2, 2048, 256)))
    gx = t(rng.normal(size=(2, 2048, 256)))
    us, out = _bench(lambda: ops.rglru(la, gx)[0], dev, iters)
    rows.append(("rglru_assoc_2k", us, "plain|assoc-scan", out))
    return rows


def _param_dim(name: str) -> int:
    """Per-replica size of a paper vision model."""
    from repro_torch.configs import get_vision_config
    from repro_torch.models.vision import make_vision_model, param_count
    init_fn = make_vision_model(get_vision_config(name).vision)[0]
    return param_count(init_fn(torch.Generator().manual_seed(0), "cpu"))


def aggregation_rows(dev, iters):
    """The round's aggregation three ways, C = 8 clusters (Dev = R / 8),
    the ring backhaul: dense (R, R) product, structured (C, R) GEMM and
    broadcast, fused ``mix_local``; x drawn N(0, 1) on the device."""
    from repro_torch.core import mixing
    from repro_torch.dist.collectives import mix_local
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for arch in AGG_ARCHS:
        d_full = _param_dim(arch)
        d = d_full if dev.type == "cuda" else min(d_full, CPU_MAX_DIM)
        cut = "" if d == d_full else f"|d={d}_of_{d_full}"
        for R in AGG_RS:
            C = 8
            Dev = R // C
            Hn = mixing.make_mixing("ring", C)
            cl = np.repeat(np.arange(C), Dev)
            W = torch.as_tensor(Hn[np.ix_(cl, cl)] / Dev, dtype=torch.float32,
                                device=dev)
            M = torch.repeat_interleave(
                torch.as_tensor(Hn, dtype=torch.float32, device=dev) / Dev,
                Dev, dim=1)
            x = torch.randn((R, d), generator=gen, device=dev)
            tag = f"R{R}_{arch}"
            it = min(iters, 3) if x.numel() * 4 > 5e8 else iters
            us_d, _ = _bench(lambda: torch.einsum("rs,sd->rd", W, x), dev,
                             it)
            gbps = x.numel() * 4 / (us_d / 1e6) / 1e9
            rows.append((f"agg_dense_{tag}", us_d, f"plain|{gbps:.2f}GB/s"
                         + cut, None))

            def structured():
                yc = M @ x
                return yc[:, None].expand(C, Dev, d).reshape(R, d)
            us_s, _ = _bench(structured, dev, it)
            rows.append((f"agg_structured_{tag}", us_s,
                         f"plain|{us_d / us_s:.1f}x_vs_dense" + cut, None))
            us_f, _ = _bench(lambda: mix_local(x, clusters=C, dev=Dev,
                                               hkind="ring"), dev, it)
            rows.append((f"agg_fused_{tag}", us_f,
                         f"plain|{us_d / us_f:.1f}x_vs_dense|one_process"
                         + cut, None))
            del x, W, M
    return rows


def _state_leaves(state):
    fl = getattr(state, "fl", state)
    return {k: v.detach().clone() for k, v in flatten(fl.params).items()}


def round_rows(dev, iters):
    """The smoke smollm's round step with a policy: dense and sparse
    gossip at each ROUND_LEVELS level, per-cluster levels, the overlapped
    engine at staleness 1; each with its ``_plain`` twin (``impl="plain"``:
    the top-k and the wire).  Output: the parameters after the first
    call from the initial state, and the loss."""
    from repro_torch.configs import get_config, smoke_model
    from repro_torch.configs.base import FLTopology, HCEFConfig
    from repro_torch.core import wire_format as wf
    from repro_torch.core.round import (init_overlap_state, init_state,
                                        make_overlap_round_step,
                                        make_round_step)
    from repro_torch.dist.policies import make_train_policy
    from repro_torch.models import lm
    from repro_torch.models.common import dtype_of

    cfg = smoke_model(get_config("smollm_135m").model).replace(
        d_model=64, d_ff=128)
    topo = FLTopology(clusters=2, devices_per_cluster=2)
    hcef = HCEFConfig(tau=2, q=2, eta=0.1, momentum=0.0)
    R = topo.num_devices
    params0 = lm.init(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (R * 2 * 2, 32)), device=dev)
    batch = {"tokens": tokens}
    rho = np.ones(R, np.float32)
    policy = make_train_policy(topo)
    leaf_dims = [int(v.numel()) for v in flatten(params0).values()]
    d_item = torch.empty((), dtype=dtype_of(cfg.param_dtype)
                         ).element_size()

    def wire_col(levels, hc):
        tot = sum(min(wf.row_bytes(float(t), L, wire_dtype=hc.wire_dtype,
                                   wire_block=hc.wire_block), L * d_item)
                  for t in levels for L in leaf_dims)
        return f"wire{tot / 1024:.0f}KB"

    rows = []

    def run(name, make, theta, derived, overlap=False):
        for impl, route in ((None, _route(dev)), ("plain", "plain")):
            step = make(impl)
            state = (init_overlap_state if overlap else init_state)(
                cfg, hcef, topo, params0, device=dev)
            first = step(state, batch, rho, theta, 0)
            out = (_state_leaves(first[0]), first[1]["loss"].detach().clone())
            box = [first[0]]

            def call():
                box[0] = step(box[0], batch, rho, theta, 0)[0]
            us, _ = _bench(call, dev, iters)
            rows.append((name if impl is None else name + "_plain", us,
                         f"{route}|{derived(us)}", out))

    hcef_sp = dataclasses.replace(hcef, sparse_gossip=True,
                                  theta_levels=ROUND_LEVELS)
    for variant, hc in (("dense", hcef), ("sparse", hcef_sp)):
        for th in ROUND_LEVELS:
            theta = np.full(R, th, np.float32)
            col = ("R4_smoke_one_process" if variant == "dense" else
                   "R4_smoke_one_process_"
                   + wire_col((th,) * topo.clusters, hc))
            run(f"round_{variant}_gossip_th{th}",
                lambda impl, hc=hc: make_round_step(
                    cfg, hc, topo, policy, gossip=True, impl=impl),
                theta, lambda us, col=col: col)
    lv = (ROUND_LEVELS[0], ROUND_LEVELS[-1])
    theta = np.full(R, lv[0], np.float32)
    pc_us = {}

    def pc_derived(us):
        pc_us.setdefault("us", us)
        return "R4_smoke_one_process_" + wire_col(lv, hcef_sp)
    run(f"round_sparse_pc_gossip_th{lv[0]}-{lv[1]}",
        lambda impl: make_round_step(cfg, hcef_sp, topo, policy,
                                     gossip=True, impl=impl,
                                     cluster_levels=lv),
        theta, pc_derived)
    hcef_ov = dataclasses.replace(hcef_sp, overlap=True, staleness=1)
    run("round_overlap_stale1_gossip",
        lambda impl: make_overlap_round_step(cfg, hcef_ov, topo, policy,
                                             gossip=True, impl=impl,
                                             cluster_levels=lv),
        theta, lambda us: (f"sync={pc_us['us']:.0f}us_R4_smoke_one_process_"
                           + wire_col(lv, hcef_ov)), overlap=True)

    # the cost model's overlapped round on the smollm heterogeneity cell
    from repro_torch.fl.cost_model import (decide_stale_clusters,
                                           overlap_round_time, round_time)
    from repro_torch.fl.heterogeneity import HeterogeneityModel
    het = HeterogeneityModel(num_devices=R, profile="tpu_pod",
                             base_step_time=10.0, model_bits=135e6 * 16)
    rep = het.sample_round(0)
    cluster_of = np.repeat(np.arange(topo.clusters),
                           topo.devices_per_cluster)
    rho_m, th_m = np.ones(R), np.full(R, 0.4)
    bh = het.backhaul_time()
    t_sync, _ = round_time(rho_m, th_m, rep.mu, rep.nu, hcef.tau,
                           cluster_of, gossip=True, backhaul=bh)
    stale = decide_stale_clusters(rho_m, th_m, rep.mu, rep.nu, hcef.tau,
                                  cluster_of, backhaul=bh)
    t_ov, _ = overlap_round_time(rho_m, th_m, rep.mu, rep.nu, hcef.tau,
                                 cluster_of, gossip=True, backhaul=bh,
                                 stale_clusters=stale or
                                 tuple(range(topo.clusters)))
    rows.append(("round_overlap_model_smollm", t_ov * 1e6,
                 f"model|sync={t_sync:.1f}s_hidden={1 - t_ov / t_sync:.2f}",
                 None))
    return rows


def bench(device=None, smoke=False):
    """Every row: [(name, us_per_call, derived, output or None)]."""
    dev = resolve(device)
    rng = np.random.default_rng(SEED)
    iters = 1 if smoke else 10
    rows = kernel_rows(dev, iters, rng)
    rows += aggregation_rows(dev, 1 if smoke else 5)
    rows += round_rows(dev, 1 if smoke else 5)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="one timed call a row after the warm-up")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    args = ap.parse_args(argv)
    rows = bench(args.device, smoke=args.smoke)
    print("name,us_per_call,derived")
    for name, us, derived, _ in rows:
        print(f"{name},{us:.1f},{derived}")
    from repro_torch.experiments import common
    p = common.save_json("kernels", {
        name: {"us_per_call": round(us, 1), "derived": derived}
        for name, us, derived, _ in rows})
    print(f"wrote {p}")
    return rows


if __name__ == "__main__":
    main()
