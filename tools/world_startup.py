#!/usr/bin/env python3
"""Where a world of ranks sharing the card spends its start-up.

    PYTHONPATH=<checkout>/src python3 tools/world_startup.py [--ranks 4]
        [--worlds 2] [--launcher] [--layers 30] [--profile-rows 25]

Starts ``--worlds`` worlds of ``--ranks`` ranks in turn through the
checkout's ``dist.mesh.run_world`` (run it with two checkouts' ``src`` in
turns to compare them on one card) and prints, for each world and rank,
the wall-clock seconds from the call to each step of the rank's start-up:
the main module imported in the rank (where it was), ``run_world``'s
child entered, its job read and its mesh made (where the checkout's
``run_world`` records them, ``mesh.STARTUP``), the rank's function
entered; then in the rank the CUDA context, the kernel library loaded
(``build.lib``), a first and a second bf16 GEMM of 4096^3, a first and a
second 64 MB psum over the world (staged through pinned host memory on
gloo) and a first and a second 512 MB pinned host buffer; and the call's
return.  ``--launcher`` then runs, in one more world of 2 ranks, the
train launcher's smollm-135M at full width (``--layers`` of its 30)
through ``--mesh single`` for 3 rounds, as ``chip_smoke.py`` phase 43
does, with rank 0 under ``cProfile``: each rank's round ms, the modules
it imported during the run (by package) and rank 0's ``--profile-rows``
functions by their own time.  Prints the card's name
and power limit first.
"""
from __future__ import annotations

import time

T_MAIN = time.time()  # this module's import: in a rank, where it is redone

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

LAUNCHER_ARGV = ["--arch", "smollm_135m", "--full", "--mesh", "single",
                 "--rounds", "3", "--seq", "2047", "--tau", "2", "--q", "2",
                 "--sparse-gossip", "--wire-dtype", "int4"]


def _sync():
    torch.cuda.synchronize()
    return time.time()


def probe_rank(mesh):
    """This rank's start-up stamps (time.time()) and its steps' seconds."""
    from repro_torch.dist import mesh as mesh_mod
    stamps = {"fn": time.time(), "main": T_MAIN,
              **getattr(mesh_mod, "STARTUP", {})}
    steps = {}
    t = time.time()
    torch.empty(1, device="cuda")
    steps["cuda_context"] = _sync() - t
    from repro_torch.kernels import build
    t = time.time()
    build.lib()
    steps["kernel_library"] = time.time() - t
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    for name in ("gemm_first", "gemm_second"):
        t = _sync()
        a @ a
        steps[name] = _sync() - t
    x = torch.ones(16 << 20, device="cuda")
    for name in ("psum_64mb_first", "psum_64mb_second"):
        t = _sync()
        mesh.psum(x, mesh.axis_names)
        steps[name] = _sync() - t
    for name in ("pinned_512mb_first", "pinned_512mb_second"):
        t = time.time()
        h = torch.empty(512 << 20, dtype=torch.uint8, pin_memory=True)
        steps[name] = time.time() - t
        del h
    return dict(rank=mesh.rank, stamps=stamps, steps=steps)


@contextlib.contextmanager
def launcher_depth(train, layers):
    real = train.get_config

    def cut(arch):
        bundle = real(arch)
        return dataclasses.replace(
            bundle, model=bundle.model.replace(num_layers=layers))
    train.get_config = cut
    try:
        yield
    finally:
        train.get_config = real


def launcher_rank(mesh, layers, rows):
    """The launcher on this rank (rank 0 under cProfile): round ms, and
    rank 0's functions by their own time."""
    import cProfile
    import io
    import pstats
    from repro_torch.kernels import build
    from repro_torch.launch import train
    t0 = time.time()
    build.lib()
    before = set(sys.modules)
    prof = cProfile.Profile() if mesh.rank == 0 else None
    with launcher_depth(train, layers):
        if prof is not None:
            prof.enable()
        out = train.main(LAUNCHER_ARGV)
        if prof is not None:
            prof.disable()
    torch.cuda.synchronize()
    table = None
    if prof is not None:
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(
            rows)
        table = buf.getvalue()
    lazy = {}
    for name in set(sys.modules) - before:
        top = ".".join(name.split(".")[:2])
        lazy[top] = lazy.get(top, 0) + 1
    return dict(rank=mesh.rank, round_ms=out["round_ms"],
                main_s=time.time() - t0, profile=table,
                lazy_imports=dict(sorted(lazy.items(), key=lambda kv: -kv[1])))


def _world(run_world, fn, n, args, timeout_s=300.0):
    t0 = time.time()
    got = run_world(fn, n, *args, timeout_s=timeout_s, threads=2)
    return t0, time.time(), got


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--worlds", type=int, default=2)
    ap.add_argument("--launcher", action="store_true")
    ap.add_argument("--layers", type=int, default=30)
    ap.add_argument("--profile-rows", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("world_startup: no CUDA device")
    from repro_torch.dist.mesh import run_world
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    torch.empty(1, device="cuda")  # the caller's own context, as phases'
    for w in range(args.worlds):
        t0, t1, got = _world(run_world, probe_rank, args.ranks, ())
        rows = []
        for g in got:
            rel = {k: round(v - t0, 3) for k, v in g["stamps"].items()}
            rows.append(dict(rank=g["rank"], since_call_s=rel,
                             steps_s={k: round(v, 4)
                                      for k, v in g["steps"].items()}))
        print("world_startup " + json.dumps(dict(
            world=w, ranks=args.ranks, checkout=str(
                Path(sys.modules["repro_torch"].__file__).parents[2]),
            call_s=round(t1 - t0, 3), per_rank=rows)))
    if args.launcher:
        t0, t1, got = _world(run_world, launcher_rank, 2,
                             (args.layers, args.profile_rows))
        for g in got:
            print("world_launcher " + json.dumps(dict(
                rank=g["rank"], layers=args.layers,
                round_ms=g["round_ms"], main_s=round(g["main_s"], 3),
                call_s=round(t1 - t0, 3),
                modules_imported_in_the_run=g["lazy_imports"])))
        print(got[0]["profile"])


if __name__ == "__main__":
    main()
