"""Federated training launcher, on the card unless ``--device cpu`` (port of
``repro/launch/train.py``, its ``--mesh host`` path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_1p3b \
        --full --rounds 4 --seq 511
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
        --full --rounds 4 --seq 2047
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch granite_moe_1b_a400m --full --rounds 4 --seq 2047

runs the HCEF round step (``core/round.py``) on 2 clusters x 2 devices,
with the architecture's HCEF configuration, the online controller, the
Eq. 8/9 time and energy accounting against its budgets, and the
device-skewed synthetic token corpus, and prints one line per round: mean
loss, mean rho and theta, simulated time, wall ms and its split, and peak
device memory on the card.  ``--smoke`` (the default) runs the reduced
same-family config, ``--full`` the architecture itself.  ``--profile``
traces the rounds after the first with torch.profiler and prints the
device's busy share and its kernels by device time.

``--sparse-gossip`` (with ``--wire-dtype``) keeps the reference's
``--mesh host`` meaning: no policy, so the round takes the off-mesh
aggregate, while theta is quantized up to the level grid and the
simulated time and energy charge the wire's bytes (``dense_bits=16``).
``--wire-ef`` needs a policy and raises, as in the reference.  The fused
branch with the wire runs from ``make_round_step(..., policy=...)``
(``chip_smoke.py`` phase 12).

The numpy stream is the reference's: the corpus, then per round
``rng.integers(0, n_seq, (R, b_per_dev))`` from ``default_rng(0)``.  The
weights (``init`` from a seeded ``torch.Generator``) and the masked-step
bits (``bits_fn(1000 + round, rho)``) cannot be the reference's
``jax.random`` draws.

Every decoder-only LM arch trains through the attention kernels, forward
and backward: the dense smollm-135M, qwen2-7b, codeqwen1.5-7b and
phi3-medium-14b (bf16 momentum), and the MoE granite-moe-1b-a400m (32
experts, top 8) and arctic-480b (128 experts, top 2, a dense residual, no
momentum).  So does the hybrid recurrentgemma-9b (``models/griffin.py``:
RG-LRU blocks, whose scan is plain PyTorch, and local MQA, 16 heads of
256 over one KV head under a 2048-token window), e.g.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma_9b --rounds 2

at smoke size (3 layers).  So do the two configs with a frontend stub:
internvl2-2b (``vit_stub``: each sequence's first 256 positions take
patch embeddings) and seamless-m4t-large-v2 (``encdec``: a 24-layer
encoder over frame embeddings, cross-attention in each decoder layer).
The reference's launcher builds batches of tokens alone and so cannot
train them (ROADMAP.md §3); this one feeds stand-ins drawn N(0, 1) each
round from a numpy generator of their own, seeded with ``--seed``, so
that the token stream of every architecture stays the reference's:
``patch_embeds`` (B, frontend_tokens, d_model) and ``frames`` (B, seq +
1, d_model).  The reference serve's zero patch embeddings are no stand-in
for training: an all-zero row stays zero through every block, the RMS
norm's gradient there is 1 / sqrt(norm_eps), and the backward through
each layer's V and O projections multiplies it again, so that at
internvl2-2b's width it passes bf16's range by layer 16.  At full width smollm-135M and
granite-moe-1b-a400m fit four replicas on one card; qwen2-7b,
codeqwen1.5-7b, phi3-medium-14b, arctic-480b and recurrentgemma-9b need
more than one card holds (``--full`` at recurrentgemma-9b's 38 layers is
about 9.4 B parameters; at about 10 bytes a parameter a replica's state,
parameters, momentum, EF and the round's delta, is about 94 GB), and the
memory is the caller's problem, as in the reference.  ``chip_smoke.py``
phase 28 trains recurrentgemma-9b at full width and depth 5 with R = 2,
phases 30 and 31 internvl2-2b and seamless-m4t-large-v2 at full width and
depth with R = 2.

``--chaos`` injects faults (``runtime/chaos``: ``--chaos-dropout``,
``--chaos-partition``, ``--chaos-coord-fail``, ``--chaos-seed``): the
controller solves P2 over the live devices, the fault plan drops the
devices that miss the deadline and partitions clusters on gossip rounds,
and a degraded round calls the step with the masks; a round with all
alive and all links up runs the fault-free step.  The round line gains
the participation, deadline misses, coordinator and cut links.
``--population N`` (>= R) runs N logical clients behind the R slots: each
round a cohort (``--cohort-seed``) swaps into the slots through
``runtime/population.PopulationStore`` (LRU of 4R clients, pages under
``--store-root``, by default a temporary directory removed at the end),
with per-client data shards and energy caps; N = R is bit for bit the
fixed roster.  ``--verify-conservation`` checks that every swap kept the
population's EF sum and the sum of its whole per-client state (float64,
under ==; ``runtime/elastic.verified_swap``, as FedSim's
``verify_conservation``), prints them and keeps them in the round's
record; their host time is left out of the round's wall time.

``--overlap`` runs the overlapped engine (``core/round.
make_overlap_round_step``) at ``--staleness`` (1 by default; 0 is the
synchronous program's bits): each gossip round the clusters whose gossip
does not fit before the ``--stale-quantile`` straggler deadline run stale
(``fl.cost_model.decide_stale_clusters``, over the live devices under
chaos), the round is charged by ``overlap_round_time`` when that set is
not empty, and the round line gains stale=k/C.  The steps are kept by
(gossip, stale set); cohort swaps and chaos act on the working buffer,
and ``pending`` stays on the mesh.

``--ckpt-dir DIR`` saves the round state after every round, as the
reference does: ``ckpt_{round:06d}.npz`` (``runtime/checkpoint.
save_pytree`` of ``state_tree``: the working buffer's params, momentum,
EF, round_idx and wire-EF estimates under the reference's key paths, bf16
leaves as their 16-bit patterns) with ``meta = {"round": round}``, and
with a population the store's manifest ``ckpt_{round:06d}.pop.npz`` and
the cohort's ids in the meta.  The manifest pins page versions under the
store's root, which is ``DIR/pop_store`` unless ``--store-root`` names
another, so that the pages outlive the run.  Its bytes and write time
are kept in the result's ``ckpts``, outside the round's wall time;
``--profile`` refuses ``--ckpt-dir``, whose host writes would fall in
the traced window.

Not ported: ``--mesh single|multi`` (more than one rank) exits naming its
ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.configs.base import FLTopology
from repro_torch.core.compression import quantize_theta
from repro_torch.core.controller import BudgetState, population_energy_caps
from repro_torch.core.round import (client_template, init_overlap_state,
                                    init_state, make_overlap_round_step,
                                    make_round_step, split_state)
from repro_torch.data.synthetic import client_token_shard, synthetic_tokens
from repro_torch.device import resolve
from repro_torch.dist.collectives import MULTI_RANK, participation_weights
from repro_torch.fl.baselines import CONTROLLERS, make_controller
from repro_torch.fl.cost_model import (decide_stale_clusters,
                                       overlap_round_time, per_device_energy,
                                       per_device_time, round_energy,
                                       round_time)
from repro_torch.fl.heterogeneity import HeterogeneityModel
from repro_torch.launch.profiling import activities, print_profile
from repro_torch.models.lm import param_count
from repro_torch.models.registry import get_model
from repro_torch.runtime.chaos import ChaosConfig, FaultPlan, controls_on_live
from repro_torch.runtime.checkpoint import save_pytree
from repro_torch.runtime.elastic import cohort_swap, verified_swap
from repro_torch.runtime.population import PopulationStore
from repro_torch.tree import flatten

N_SEQ = 32  # sequences per device in the corpus (train.py)


def state_tree(fl) -> dict:
    """The checkpoint's tree of an ``FLState``: the reference's
    ``FLState._asdict()`` (train.py:375), None fields left out as its
    pytree flattening leaves them, ``round_idx`` an int32 scalar."""
    tree = {f: getattr(fl, f) for f in ("params", "momentum", "ef",
                                        "wire_ef")}
    tree["round_idx"] = torch.tensor(int(fl.round_idx), dtype=torch.int32)
    return {k: v for k, v in tree.items() if v is not None}


def frontend_stand_ins(cfg, batch: int, seq: int, seed: int):
    """Returns a function of no arguments giving the frontend inputs of
    one round's batch of ``batch`` sequences of ``seq`` tokens, drawn
    N(0, 1) anew each call from ``default_rng(seed)`` (the reference
    serve's frames, launch/serve.py:99-104; its patch embeddings are
    zero, which training cannot take: see the module's docstring):
    ``patch_embeds`` (batch, frontend_tokens, d_model) for ``vit_stub``,
    ``frames`` (batch, seq, d_model) for the encoder; {} without a
    frontend.  f32 host tensors."""
    frng = np.random.default_rng(seed)
    shapes = {}
    if cfg.frontend == "vit_stub":
        shapes["patch_embeds"] = (batch, cfg.frontend_tokens, cfg.d_model)
    if cfg.enc_layers:
        shapes["frames"] = (batch, seq, cfg.d_model)

    def draw():
        return {k: torch.from_numpy(frng.standard_normal(shp,
                                                         dtype=np.float32))
                for k, shp in shapes.items()}
    return draw


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_1p3b", choices=ARCH_IDS)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--controller", default="hcef",
                    choices=sorted(CONTROLLERS))
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the frontend "
                         "stand-ins (the token stream is the "
                         "reference's)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CPU fallback)")
    ap.add_argument("--profile", action="store_true",
                    help="trace the rounds after the first and print the "
                         "device busy share and kernels by time")
    ap.add_argument("--sparse-gossip", action="store_true",
                    help="quantize theta to the level grid and charge the "
                         "gossip wire's bytes")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "int8", "int4", "fp8"])
    ap.add_argument("--wire-ef", action="store_true",
                    help="CHOCO wire error feedback (needs a policy: "
                         "raises on --mesh host, as in the reference)")
    ap.add_argument("--chaos", action="store_true",
                    help="seeded fault injection (runtime/chaos)")
    ap.add_argument("--chaos-dropout", type=float, default=0.2)
    ap.add_argument("--chaos-partition", type=float, default=0.1)
    ap.add_argument("--chaos-coord-fail", type=float, default=0.2)
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--population", type=int, default=0,
                    help="logical clients behind the R slots (0: the "
                         "fixed roster)")
    ap.add_argument("--cohort-seed", type=int, default=0)
    ap.add_argument("--store-root", default=None,
                    help="population page directory (default: a "
                         "temporary one)")
    ap.add_argument("--verify-conservation", action="store_true",
                    help="check that every cohort swap keeps the "
                         "population's EF and state sums")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped round engine: stale clusters ship "
                         "their start-of-round model (bounded staleness)")
    ap.add_argument("--staleness", type=int, default=1, choices=[0, 1],
                    help="with --overlap: 0 is the synchronous program, 1 "
                         "lets behind clusters ship their stale-by-1 model")
    ap.add_argument("--stale-quantile", type=float, default=0.9,
                    help="straggler-deadline quantile deciding which "
                         "clusters run stale on gossip rounds")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the round state here after every round")
    return ap


def main(argv=None):
    """Run the launcher; returns {"history", "round_ms", "timings",
    "n_params", "cfg", "peak_mem_gb", "swap_bytes", "pop_store",
    "cohort_ids", "state", "ckpts"} (``state`` an ``OverlapState`` with
    ``--overlap``; ``ckpts`` a {"path", "bytes", "write_ms"} a checkpoint
    written).  ``pop_store`` is None where its pages were in a temporary
    directory, removed before the return."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.mesh != "host":
        ap.error(f"--mesh {args.mesh} is not ported yet: {MULTI_RANK}")
    if args.profile and args.ckpt_dir:
        ap.error("--profile with --ckpt-dir: the checkpoints' host writes "
                 "would fall in the traced wall time")
    bundle = get_config(args.arch)
    cfg = smoke_model(bundle.model) if args.smoke else bundle.model
    hcef = bundle.hcef
    if args.sparse_gossip or args.wire_dtype or args.wire_ef or args.overlap:
        hcef = dataclasses.replace(
            hcef, sparse_gossip=hcef.sparse_gossip or args.sparse_gossip,
            wire_dtype=args.wire_dtype or hcef.wire_dtype,
            wire_ef=hcef.wire_ef or args.wire_ef, overlap=args.overlap,
            staleness=args.staleness if args.overlap else 0)
    topo = FLTopology(clusters=2, devices_per_cluster=2)
    R = topo.num_devices
    if args.population and args.population < R:
        ap.exit(2, f"--population {args.population} smaller than the mesh "
                   f"cohort R={R}\n")
    if args.population > R and hcef.wire_ef:
        # the CHOCO estimates are shared between gossip neighbours; a
        # rotating cohort would desync them
        ap.exit(2, "--wire-ef is incompatible with cohort sampling "
                   "(--population > R): neighbor estimates desync under "
                   "churn\n")
    dev = resolve(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference is f32

    cluster_of = np.repeat(np.arange(topo.clusters), topo.devices_per_cluster)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params0 = get_model(cfg).init(cfg, gen, device=dev)
    n_params = param_count(params0)
    state = (init_overlap_state if hcef.overlap else init_state)(
        cfg, hcef, topo, params0, device=dev)
    del params0
    # the working buffer: the state of the synchronous engine, the
    # overlapped engine's fl
    fl = lambda: state.fl if hcef.overlap else state
    steps = {}  # (gossip, stale set) -> step

    def get_step(gossip, stale):
        if (gossip, stale) not in steps:
            steps[gossip, stale] = (
                make_overlap_round_step(cfg, hcef, topo, gossip=gossip,
                                        stale_clusters=stale)
                if hcef.overlap else make_round_step(cfg, hcef, topo,
                                                     gossip=gossip))
        return steps[gossip, stale]

    for g in (False, True):  # the configuration's errors raise here
        get_step(g, None)
    controller = make_controller(args.controller, hcef.tau,
                                 theta_min=hcef.theta_min,
                                 rho_min=hcef.rho_min)
    het = HeterogeneityModel(num_devices=R, model_bits=n_params * 16,
                             population=args.population)
    budget = BudgetState(
        time_budget=hcef.time_budget or np.inf,
        energy_budget=hcef.energy_budget or np.inf,
        phi=max(args.rounds // hcef.q, 1), q=hcef.q,
        backhaul_time=het.backhaul_time(),
        population=args.population, cohort=R if args.population else 0)
    pop_store = cohort_ids = tmp = None
    swap_bytes = []  # device<->host bytes of each round's swap
    if args.population:
        if args.store_root:
            root = Path(args.store_root)
        elif args.ckpt_dir:  # the manifests' pages outlive the run
            root = Path(args.ckpt_dir) / "pop_store"
        else:
            tmp = tempfile.TemporaryDirectory(prefix="pop_store_")
            root = Path(tmp.name)
        tmpl = client_template(fl())
        pop_store = PopulationStore(args.population, tmpl, root=root,
                                    resident_max=4 * R)
        client_bytes = sum(t.numel() * t.element_size()
                           for t in flatten(tmpl).values())

        # per-client shards made by id; with population == R they are
        # synthetic_tokens' rows
        @functools.lru_cache(maxsize=4 * R)
        def shard(cid: int) -> np.ndarray:
            return client_token_shard(cfg.vocab_size, n_seq=N_SEQ,
                                      seq_len=args.seq + 1, client_id=cid,
                                      beta=0.5)
    else:
        corpus = synthetic_tokens(cfg.vocab_size, n_seq=N_SEQ,
                                  seq_len=args.seq + 1, n_devices=R,
                                  beta=0.5)
    plan = None
    if args.chaos:
        plan = FaultPlan(ChaosConfig(
            seed=args.chaos_seed, dropout_prob=args.chaos_dropout,
            partition_prob=args.chaos_partition,
            coordinator_fail_prob=args.chaos_coord_fail),
            num_devices=R, num_clusters=topo.clusters)
    rng = np.random.default_rng(0)
    b_per_dev = hcef.tau * 2
    stand_ins = frontend_stand_ins(cfg, R * b_per_dev, args.seq + 1,
                                   args.seed)
    # dense_bits=16: het's model_bits above is n_params * 16 (bf16)
    wire_kw = (dict(wire_dtype=hcef.wire_dtype, wire_block=hcef.wire_block,
                    dense_bits=16) if hcef.sparse_gossip else {})

    print(f"arch={args.arch} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}) mesh=host R={R} controller={args.controller} "
          f"params/replica={n_params:,} seq={args.seq + 1} on {dev}"
          + (f" population={args.population}" if args.population else "")
          + (" chaos" if plan is not None else ""), flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    history, round_ms, timings = [], [], {}

    def swap(rnd):
        """This round's cohort into the slots (``elastic.cohort_swap``);
        returns its ``elastic.verified_swap`` record where checked."""
        nonlocal cohort_ids
        old_ids = cohort_ids
        new_ids = (het.sample_cohort(rnd, R, seed=args.cohort_seed)
                   if args.population > R else np.arange(R, dtype=np.int64))
        _, client = split_state(fl())

        def move():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            # bytes between card and host: the outgoing cohort's state,
            # and the incoming clients' that took part before (a
            # first-time client's rows are zeroed on the card)
            held = pop_store.touched | set(
                () if old_ids is None else old_ids.tolist())
            moved = sum(int(c) in held for c in new_ids)
            if old_ids is None:
                # the slots hold zeros, every client's state before it
                # takes part: nothing to scatter yet
                pop_store.gather(new_ids, out=client)
            else:
                cohort_swap(client, old_ids, new_ids, pop_store)
                moved += R
            swap_bytes.append(moved * client_bytes)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings.setdefault("cohort_swap", []).append(
                (time.perf_counter() - t0) * 1e3)

        check = None
        if args.verify_conservation and old_ids is not None:
            check = verified_swap(move, pop_store, client, old_ids, new_ids)
            print(f"cohort swap before round {rnd}: the population's EF "
                  f"sum {check['ef_before']!r} before, "
                  f"{check['ef_after']!r} after; its whole per-client "
                  f"state (EF, momentum) {check['state_before']!r} before,"
                  f" {check['state_after']!r} after ("
                  f"{'equal' if check['equal'] else 'NOT EQUAL'}; checked "
                  f"in {check['host_ms']:.0f} ms)", flush=True)
        else:
            move()
        cohort_ids = new_ids
        return check

    def one_round(rnd):
        nonlocal state
        t0 = time.perf_counter()
        check = swap(rnd) if pop_store is not None else None
        reports = het.sample_round(rnd, ids=cohort_ids)
        if pop_store is not None and args.population > R:
            reports = dataclasses.replace(
                reports, energy_cap=population_energy_caps(
                    budget, pop_store.rounds_participated[cohort_ids],
                    pop_store.energy_spent[cohort_ids]))
        alive0 = plan.sample_available(rnd) if plan is not None else None
        if alive0 is not None:
            rho, theta = controls_on_live(controller, reports, budget,
                                          alive0)
        else:
            rho, theta = controller.controls(reports, budget)
        gossip = (rnd + 1) % hcef.q == 0
        if hcef.sparse_gossip:  # the wire ships grid levels only
            theta = quantize_theta(theta, hcef.theta_levels)
        idx = rng.integers(0, N_SEQ, (R, b_per_dev))
        if pop_store is not None:
            tokens = np.concatenate([shard(int(cohort_ids[d]))[idx[d]]
                                     for d in range(R)])
        else:
            tokens = np.concatenate([corpus[d, idx[d]] for d in range(R)])
        stale = None
        if hcef.overlap and hcef.staleness and gossip:
            # the clusters whose gossip does not fit before the deadline
            stale = decide_stale_clusters(
                rho, theta, reports.mu, reports.nu, hcef.tau, cluster_of,
                backhaul=het.backhaul_time(), alive=alive0,
                quantile=args.stale_quantile, **wire_kw)
        faults = alive = conn = None
        masks = {}
        if plan is not None:
            faults = plan.step(rnd, gossip_round=gossip,
                               per_device_time=per_device_time(
                                   rho, theta, reports.mu, reports.nu,
                                   hcef.tau, **wire_kw),
                               alive=alive0)
            alive, conn = faults.alive, faults.cluster_conn
            if not (alive.all() and conn.all()):
                masks = dict(alive=alive.astype(np.float32),
                             alive_w=participation_weights(
                                 alive, clusters=topo.clusters,
                                 dev=topo.devices_per_cluster),
                             conn=conn.astype(np.float32))
        state, m = get_step(gossip, stale)(
            state, {"tokens": torch.from_numpy(tokens), **stand_ins()},
            rho, theta, 1000 + rnd, timings=timings, **masks)
        # a stale cluster's gossip runs during its local steps
        t, _ = (overlap_round_time if stale else round_time)(
            rho, theta, reports.mu, reports.nu, hcef.tau, cluster_of,
            gossip=gossip, backhaul=het.backhaul_time(), alive=alive,
            conn=conn, **(dict(stale_clusters=stale) if stale else {}),
            **wire_kw)
        e = round_energy(rho, theta, reports.mu, reports.nu, reports.alpha,
                         reports.p, hcef.tau, alive=alive, **wire_kw)
        if pop_store is not None:
            pop_store.record_round(cohort_ids, rnd, energy=per_device_energy(
                rho, theta, reports.mu, reports.nu, reports.alpha,
                reports.p, hcef.tau, alive=alive, **wire_kw))
        budget.charge(t, e, gossip)
        loss = float(m["loss"].mean())  # waits for the round
        round_ms.append((time.perf_counter() - t0) * 1e3
                        - (check["host_ms"] if check else 0.0))
        rec = {"round": rnd, "loss": loss, "gossip": gossip,
               "rho_mean": float(np.mean(rho)),
               "theta_mean": float(np.mean(theta)),
               "time": budget.time_spent_prev + budget.time_spent_this,
               "energy": budget.energy_spent_prev + budget.energy_spent_this}
        names = ["device_round", "compress", "aggregate"]
        extra = ""
        if pop_store is not None:
            names.append("cohort_swap")
            rec["cohort"] = [int(c) for c in cohort_ids]
            if check is not None:
                rec["swap_check"] = check
            extra += (f" cohort[{int(cohort_ids.min())}.."
                      f"{int(cohort_ids.max())}] "
                      f"res={pop_store.resident_count}")
        if stale is not None:
            rec["stale"] = list(stale)
            extra += f" stale={len(stale)}/{topo.clusters}"
        if faults is not None:
            rec.update(participation=faults.participation,
                       n_deadline_missed=faults.n_deadline_missed,
                       coordinator=faults.coordinator,
                       n_partitioned=int((~conn).sum()),
                       degraded=bool(masks))
            extra += (f" part={faults.participation:.2f} "
                      f"miss={faults.n_deadline_missed} "
                      f"coord={faults.coordinator}"
                      + (f" cut={rec['n_partitioned']}"
                         if rec["n_partitioned"] else ""))
        split = "/".join(f"{timings[k][-1]:.0f}" for k in names)
        mem = (f" peak={torch.cuda.max_memory_allocated(dev) / 1e9:.2f}GB"
               if dev.type == "cuda" else "")
        print(f"round {rnd:3d} loss={loss:7.4f} rho={rec['rho_mean']:.2f} "
              f"theta={rec['theta_mean']:.2f} sim_t={rec['time']:9.0f}s "
              f"wall={round_ms[-1]:.0f}ms ({'/'.join(names)} {split} ms)"
              f"{extra}{mem}", flush=True)
        return rec

    ckpts = []

    def save(rnd):
        """The reference's checkpoint of the round (train.py:368-376)."""
        d = Path(args.ckpt_dir)
        meta = {"round": rnd}
        if pop_store is not None:
            meta["cohort_ids"] = [int(c) for c in cohort_ids]
            pop_store.save(d / f"ckpt_{rnd:06d}.pop.npz")
        path = d / f"ckpt_{rnd:06d}.npz"
        t0 = time.perf_counter()
        save_pytree(path, state_tree(fl()), meta=meta)
        ckpts.append({"path": str(path), "bytes": path.stat().st_size,
                      "write_ms": (time.perf_counter() - t0) * 1e3})

    prof, t_prof = None, 0.0
    try:
        with contextlib.ExitStack() as stack:
            for rnd in range(args.rounds):
                if args.profile and rnd == 1:  # after a warm-up round
                    prof = stack.enter_context(torch.profiler.profile(
                        activities=activities(dev)))
                    t_prof = time.perf_counter()
                history.append(one_round(rnd))
                if args.ckpt_dir:
                    save(rnd)
            wall = time.perf_counter() - t_prof
    finally:
        if tmp is not None:
            tmp.cleanup()
    if prof is not None:
        print_profile(prof, wall)
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    return {"history": history, "round_ms": round_ms, "timings": timings,
            "n_params": n_params, "cfg": cfg, "peak_mem_gb": peak,
            "swap_bytes": swap_bytes,
            "pop_store": pop_store if tmp is None else None,
            "cohort_ids": cohort_ids, "state": state, "ckpts": ckpts}


if __name__ == "__main__":
    main()
