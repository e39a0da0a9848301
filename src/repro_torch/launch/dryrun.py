"""The dry run: every architecture x shape cell's step counted on ``meta``
(the one-process half of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm_135m \
        --shape train_4k --sparse-gossip --wire-dtype int4

The reference lowers each cell onto its production mesh of 256 fake
devices and reads the compiled HLO; it compiles but never executes.  Here
a cell's state and inputs are tensors on ``meta`` (shapes and types,
nothing allocated: ``core.round.abstract_state``,
``models.registry.input_specs`` / ``cache_specs``) and its step runs once
under ``dist.step_analysis.analyze_step``, which counts the dot FLOPs and
bytes and the live storages; on ``meta`` every op takes its plain route.
The cell's JSON keeps the reference's keys where they mean something at
one process (``hlo`` holds the counted keys, so ``experiments/roofline.py``
reads them as the reference's roofline does):

- train: the ``fl_single`` topology's whole state as one process would
  hold it (R replicas of the parameters, the momentum, the EF) and the
  global batch as arguments; the counted step allocates the round's
  delta buffer and runs one device's local step (loss, gradients, the
  SGD update in place) at b_local = global_batch / (R * tau), and its
  FLOPs and dot bytes are multiplied by R * tau, the round's local steps
  (the reference's loop-weighted count).  With ``--sparse-gossip`` (or
  ``--wire-dtype``) the ``gossip_bytes_scale_with_theta`` section holds a
  gossip round's wire bytes at every level of the grid; with
  ``--theta-spread`` the ``cluster_gossip_bytes`` section those at the
  per-cluster levels against the all-max baseline;
- prefill and decode: the parameters, the inputs and the static cache
  (``cache_specs``) as arguments, one ``make_prefill_step`` /
  ``make_serve_step`` call counted under ``torch.no_grad``;
- a shape in the bundle's ``skip_shapes``: ``status: skipped`` with its
  ``skip_reason``.

``memory.peak_est_bytes`` is the arguments plus the high-water mark of
the storages the step made; ``fits_72gb`` says whether it stays under the
72 GB a card's runs are held to.  Results go to
``experiments_out/dryrun/<arch>.<shape>.host[.<wire>].json``.

Only ``--mesh host`` (one process) is ported.  The production-mesh
lowering, per-shard bytes, ``no_full_leaf_allgather``, the ``coll:<op>``
bytes and the serve policy need more than one rank and exit naming
ROADMAP.md item 5; the gossip-overlap verdict has its counterpart in
``chip_smoke.py``'s CUDA-event check of the overlap engine.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_model
from repro_torch.configs.base import FLTopology
from repro_torch.core.round import (_per_layer, _split_batch,
                                    abstract_state, make_prefill_step,
                                    make_serve_step)
from repro_torch.dist.collectives import MULTI_RANK
from repro_torch.dist.step_analysis import (
    analyze_step, check_cluster_gossip_bytes,
    check_gossip_bytes_scale_with_theta, leaf_numels, round_gossip_bytes)
from repro_torch.models.common import dtype_of
from repro_torch.models.registry import cache_specs, get_model, input_specs
from repro_torch.optim.sgd import sgd_update_
from repro_torch.tree import flatten, tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "experiments_out" / \
    "dryrun"
FIT_BYTES = 72e9  # the peak a card's runs are held to (PERF.md section 2)
HLO_KEYS = ("flops", "dot_bytes", "coll_total", "gossip_wire_bytes")


# a train cell's counted local step, by (config, shape, topology, tau,
# eta, momentum): the sparse cells of one cell count it once a process
_COUNTED: dict = {}


def _tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in flatten(tree).values())


def local_step_fn(cfg, hcef, R: int):
    """step(state, batch) -> loss: the round's delta buffer, then device
    0's first local step on it (``make_round_step``'s ``device_round`` at
    one step): loss and per-layer gradients at b_local, the SGD update in
    place.  The delta is held to the end of the step, as the round holds
    it."""
    model = get_model(cfg)

    def step(state, batch):
        delta = tree_map(torch.empty_like, state.params)
        work = tree_map(lambda d: d[0], delta)
        leaves, rebuild = _per_layer(work)
        moms = None if state.momentum is None else _per_layer(
            tree_map(lambda m: m[0], state.momentum))[0]
        local = {k: v[0, 0] for k, v in
                 _split_batch(batch, R, hcef.tau).items()}
        ps = [v.detach().requires_grad_() for v in leaves]
        with torch.enable_grad():
            loss = model.loss_fn(cfg, rebuild(ps), local)
            grads = torch.autograd.grad(loss, ps)
        with torch.no_grad():
            sgd_update_(ps, grads, moms, lr=hcef.eta,
                        momentum=hcef.momentum)
        del grads, delta
        return loss.detach()
    return step


def _gossip_sections(state, cfg, hcef, topo, theta_spread):
    """The gossip's byte sections of a train cell: (hlo bytes, {section:
    verdict})."""
    C = topo.clusters
    numels = leaf_numels(state.params)
    kw = dict(clusters=C, hkind=topo.backhaul, wire_dtype=hcef.wire_dtype,
              wire_block=hcef.wire_block,
              dense_itemsize=torch.empty((), dtype=dtype_of(
                  cfg.param_dtype)).element_size())
    if not hcef.sparse_gossip:
        return round_gossip_bytes(numels, sparse=False, **kw), {}
    if C < 2:  # no backhaul: nothing crosses it
        return 0.0, {}
    check_kw = {k: kw[k] for k in ("wire_dtype", "wire_block",
                                   "dense_itemsize")}
    if theta_spread:
        spread = [float(t) for t in theta_spread.split(",")]
        cl = tuple(spread[i % len(spread)] for i in range(C))
        got = round_gossip_bytes(numels, cluster_theta=cl, **kw)
        base = round_gossip_bytes(numels, theta=max(cl), **kw)
        return got, {"cluster_gossip_bytes": check_cluster_gossip_bytes(
            got, base, cl, **check_kw)}
    levels = sorted({float(t) for t in hcef.theta_levels})
    per_level = [round_gossip_bytes(numels, theta=t, **kw) for t in levels]
    return per_level[-1], {
        "gossip_bytes_scale_with_theta":
            check_gossip_bytes_scale_with_theta(per_level, levels,
                                                **check_kw)}


def lower_cell(arch: str, shape_name: str = None, *, shape=None,
               topo: FLTopology = None, sparse_gossip: bool = False,
               theta_spread: str = None, wire_dtype: str = None,
               smoke: bool = False, verbose: bool = True) -> dict:
    """One cell's result dict.  ``shape`` (a ShapeConfig) and ``topo``
    replace the bundle's cell and its ``fl_single`` topology (a cell of
    the caller's own, e.g. a chip run's configuration); ``smoke`` counts
    the reduced config (``smoke_model``)."""
    bundle = get_config(arch)
    cfg, hcef = bundle.model, bundle.hcef
    if smoke:
        cfg = smoke_model(cfg)
    if sparse_gossip or theta_spread or wire_dtype:
        hcef = dataclasses.replace(hcef, sparse_gossip=True)
    if wire_dtype:
        hcef = dataclasses.replace(hcef, wire_dtype=wire_dtype)
    if shape is None:
        shape = {s.name: s for s in bundle.shapes}[shape_name]
    head = {"arch": arch, "shape": shape.name, "mesh": "host"}
    if shape.name in bundle.skip_shapes:
        return dict(head, status="skipped", reason=bundle.skip_reason)
    t0 = time.perf_counter()
    model = get_model(cfg)
    sections = {}
    if shape.kind == "train":
        topo = topo or bundle.fl_single
        R = topo.num_devices
        state = abstract_state(cfg, hcef, topo)
        pcount = sum(v[0].numel() for v in flatten(state.params).values())
        key = (cfg, shape, topo, hcef.tau, hcef.eta, hcef.momentum)
        if key not in _COUNTED:  # the wire's settings leave it unchanged
            _COUNTED[key] = analyze_step(local_step_fn(cfg, hcef, R), state,
                                         input_specs(cfg, shape))
        got = _COUNTED[key]
        weight = R * hcef.tau
        gossip, sections = _gossip_sections(state, cfg, hcef, topo,
                                            theta_spread)
        hlo = {"flops": got["flops"] * weight,
               "dot_bytes": got["dot_bytes"] * weight,
               "gossip_wire_bytes": gossip}
        extra = {"replicas": R, "tau": hcef.tau,
                 "b_local": shape.global_batch // weight,
                 "local_steps_counted": weight,
                 "state_bytes": _tree_bytes(state.params) + _tree_bytes(
                     state.ef) + (0 if state.momentum is None
                                  else _tree_bytes(state.momentum))}
    else:
        params = model.init(cfg, device="meta")
        pcount = sum(v.numel() for v in flatten(params).values())
        cache = cache_specs(cfg, shape)
        if shape.kind == "prefill":
            fn, args = make_prefill_step(cfg), (params, input_specs(
                cfg, shape), cache)
        else:
            fn, args = make_serve_step(cfg), (params, cache, input_specs(
                cfg, shape)["tokens"])
        with torch.no_grad():
            got = analyze_step(fn, *args)
        hlo = {"flops": got["flops"], "dot_bytes": got["dot_bytes"],
               "gossip_wire_bytes": 0.0}
        extra = {"cache_bytes": _tree_bytes(
            {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)})}
    hlo["coll_total"] = 0.0
    peak = got["peak_est_bytes"]
    result = dict(
        head, wire_dtype=hcef.wire_dtype, status="ok", kind=shape.kind,
        smoke=smoke, param_count=int(pcount), n_chips=1,
        seq_len=shape.seq_len,
        global_batch=shape.global_batch,
        count_s=round(time.perf_counter() - t0, 2),
        memory={"argument_bytes": int(got["argument_bytes"]),
                "output_bytes": int(got["output_bytes"]),
                "temp_bytes": int(peak - got["argument_bytes"]),
                "alias_bytes": 0, "peak_est_bytes": int(peak)},
        fits_72gb=bool(peak <= FIT_BYTES),
        hlo={k: float(hlo[k]) for k in HLO_KEYS}, **extra, **sections)
    if verbose:
        print(f"== {arch} x {shape.name} x host == counted in "
              f"{result['count_s']:.1f} s; params {pcount:,}")
        print(f"  memory: args={got['argument_bytes'] / 2**30:.2f}GiB "
              f"peak_est={peak / 2**30:.2f}GiB "
              f"({'fits' if result['fits_72gb'] else 'does not fit'} "
              f"72 GB)")
        print(f"  counted: flops={hlo['flops']:.3e} "
              f"dot_bytes={hlo['dot_bytes']:.3e} "
              f"gossip_wire_bytes={hlo['gossip_wire_bytes']:.3e}")
        for name, v in sections.items():
            print(f"  {name}: ok={v['ok']}")
    return result


def cell_path(arch: str, shape: str, wire_dtype: str = None,
              theta_spread: str = None, out_dir: Path = None) -> Path:
    out_dir = RESULTS_DIR if out_dir is None else out_dir
    tag = f".{wire_dtype}" if wire_dtype else ""
    if theta_spread:
        tag += ".spread" + theta_spread.replace(",", "_")
    return out_dir / f"{arch}.{shape}.host{tag}.json"


def run_cell(arch, shape, *, out: Path = None, sparse_gossip=False,
             theta_spread=None, wire_dtype=None, verbose=True) -> dict:
    """``lower_cell`` with a failure kept as ``status: error``, written to
    ``out`` (default ``cell_path``)."""
    if (sparse_gossip or theta_spread) and not wire_dtype:
        wire_dtype = get_config(arch).hcef.wire_dtype
    t0 = time.perf_counter()
    try:
        res = lower_cell(arch, shape, sparse_gossip=sparse_gossip,
                         theta_spread=theta_spread, wire_dtype=wire_dtype,
                         verbose=verbose)
    except Exception as e:  # recorded, the --all summary counts it
        res = {"arch": arch, "shape": shape, "mesh": "host",
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "wall_s": time.perf_counter() - t0}
    out = out or cell_path(arch, shape, wire_dtype, theta_spread)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return res


def verdicts_failed(res: dict):
    return [k for k in ("gossip_bytes_scale_with_theta",
                        "cluster_gossip_bytes")
            if isinstance(res.get(k), dict) and not res[k]["ok"]]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["host", "single", "multi"],
                    default="host")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sparse-gossip", action="store_true",
                    help="train cells with the sparse gossip wire: the "
                         "gossip_bytes_scale_with_theta verdict")
    ap.add_argument("--theta-spread", default=None,
                    help="comma-separated theta levels assigned round-robin "
                         "to the clusters: the cluster_gossip_bytes verdict "
                         "against the all-max baseline")
    ap.add_argument("--wire-dtype", default=None,
                    choices=["f32", "bf16", "int8", "int4", "fp8"],
                    help="the sparse gossip's value encoding (implies "
                         "--sparse-gossip)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.mesh != "host":
        ap.error(f"--mesh {args.mesh} is not ported yet: {MULTI_RANK}")
    kw = dict(sparse_gossip=args.sparse_gossip,
              theta_spread=args.theta_spread, wire_dtype=args.wire_dtype)
    if args.all:
        counts = {"ok": 0, "error": 0, "skipped": 0}
        bad = []
        for arch in ARCH_IDS:
            for s in get_config(arch).shapes:
                res = run_cell(arch, s.name, verbose=False, **kw)
                counts[res["status"]] += 1
                bad += [f"{arch}/{s.name}: {v}"
                        for v in verdicts_failed(res)]
                note = res.get("error") or res.get("reason", "")
                print(f"{arch:24s} {s.name:12s} host   -> {res['status']} "
                      f"{res.get('count_s', '')} {note[:60]}", flush=True)
        print(f"TOTAL ok={counts['ok']} err={counts['error']} "
              f"skipped={counts['skipped']}")
        if bad:
            print(f"VERDICT FAILED: {bad}")
        sys.exit(1 if counts["error"] or bad else 0)
    if not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")
    res = run_cell(args.arch, args.shape,
                   out=Path(args.out) if args.out else None, **kw)
    if res["status"] == "error":
        print(f"ERROR: {res['error']}")
        sys.exit(1)
    bad = verdicts_failed(res)
    if bad:
        print(f"VERDICT FAILED: {bad}")
        sys.exit(1)


if __name__ == "__main__":
    main()
