"""Build the hand-written CUDA kernels at first use and load them.

Every ``csrc/*.cu`` of this package is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` per source, all started together), linked into one shared
library with a plain C interface and loaded with ``ctypes``.  The library
goes into ``_build/`` beside this file, named by a hash of the sources and
flags, so an unchanged tree reuses it and a changed one rebuilds.  A build
that fails raises; nothing falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# name -> argtypes of each C entry point (all return a cudaError_t as int)
SIGNATURES = {
    "repro_flash_attention_fwd":
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "repro_paged_decode_attention_fwd": [_P] * 12 + [_I] * 9 + [_F, _P],
    "repro_topk_compress_leaves": [_P, _I, _I, _I, _P],
    "repro_ssd_plan": [_I] * 9 + [_P],
    "repro_ssd_fwd": [_P] * 8 + [_LL] + [_I] * 8 + [_P],
    "repro_ssd_bwd": [_P] * 13 + [_LL] + [_I] * 8 + [_P],
    "repro_wire_encode_rows": [_P, _LL, _P, _I, _LL, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _P],
    "repro_wire_pack_p4": [_P, _P, _LL, _I, _I, _I, _P],
    "repro_wire_unpack_p4": [_P, _P, _LL, _I, _I, _I, _P],
    "repro_wire_decode_mix": [_P, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""                    # nvcc's output (ptxas register use)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit required)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds):
    """Start every command at once, wait for all, raise on any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            for q in procs:
                q.wait()
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    return "".join(logs)


def build() -> Path:
    """Compile and link the kernels unless this tree's library exists."""
    global build_seconds, build_log
    srcs = _sources()
    lib_path = BUILD_DIR / f"librepro_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                    for s, o in zip(srcs, objs)])
    tmp = lib_path.with_suffix(f".{tag}.tmp")
    log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                      "-o", str(tmp)]])
    os.replace(tmp, lib_path)  # atomic: a reader sees a whole library
    for o in objs:
        o.unlink()
    build_seconds = time.perf_counter() - t0
    build_log = log
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
