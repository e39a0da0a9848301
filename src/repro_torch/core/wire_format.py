"""Wire byte layouts (own copy of ``repro/core/wire_format.py``, numpy).

The cost model reads ``compression_ratio_bytes`` when a FedSim runs with
``sparse_gossip``; the gossip wire itself (``dist/collectives`` in the
reference) is not ported yet (ROADMAP.md, multi-GPU mesh path).

Formats (per wire block of ``wb`` dense entries, ``k_b`` kept):

  dtype   values                offsets                      scale
  f32     k_b * 4 B (f32)       k_b * 4 B (int32)            —
  bf16    k_b * 2 B (bf16)      k_b * 4 B (int32)            —
  int8    k_b * 1 B (int8)      k_b * 2 B (int16)            4 B (f32)
  fp8     k_b * 1 B (e4m3)      packed (u8 | p4, see below)  4 B (f32)
  int4    ceil(k_b/2) B         packed (u8 | p4)             4 B (f32)
          (2 nibbles / byte)

The v2 formats (int4/fp8) ship sorted ascending block-local offsets in
whichever packed encoding is smaller for the static (wb, k_b) pair:

  u8  raw uint8 offsets, k_b bytes — valid only when wb <= 256;
  p4  lo nibbles packed two per byte (ceil(k_b/2) bytes) followed by a
      delta-unary bitmap of the hi nibbles, ceil((k_b + ceil(wb/16)) / 8)
      bytes.

All sizes are static in (wb, k_b); functions accept scalar or ndarray
``k_b``/``theta`` (the cost model's per-device vectors).  The layouts'
other helpers (offset modes, row bytes, the dense-fallback test) come with
the gossip wire.
"""
from __future__ import annotations

import numpy as np

WIRE_DTYPES = ("f32", "bf16", "int8", "int4", "fp8")

# value bits per kept entry
_VAL_BITS = {"f32": 32, "bf16": 16, "int8": 8, "fp8": 8, "int4": 4}
# per-wire-block f32 dequant scale (quantized formats only)
_SCALE_BYTES = {"f32": 0, "bf16": 0, "int8": 4, "fp8": 4, "int4": 4}
# fixed-width offset itemsize of the v1 formats (v2 formats pack)
_V1_OFF_BYTES = {"f32": 4, "bf16": 4, "int8": 2}


def _ceil_div(a, b):
    return -(-a // b)


def value_bytes(k_b, wire_dtype: str):
    """Bytes the k_b kept values occupy (int4 packs 2 per byte)."""
    return _ceil_div(np.asarray(k_b) * _VAL_BITS[wire_dtype], 8)


def p4_bytes(wb: int, k_b):
    """Bytes of the p4 packed-offset encoding (lo nibbles + hi bitmap)."""
    k = np.asarray(k_b)
    return _ceil_div(k, 2) + _ceil_div(k + _ceil_div(int(wb), 16), 8)


def offset_bytes(wb: int, k_b, wire_dtype: str):
    """Bytes the k_b block-local offsets occupy on the wire."""
    if wire_dtype in _V1_OFF_BYTES:
        return np.asarray(k_b) * _V1_OFF_BYTES[wire_dtype]
    p4 = p4_bytes(wb, k_b)
    if wb <= 256:
        return np.minimum(np.asarray(k_b), p4)
    return p4


def block_bytes(wb: int, k_b, wire_dtype: str):
    """Exact bytes one encoded wire block occupies (values+offsets+scale)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype {wire_dtype!r} not in {WIRE_DTYPES}")
    return (value_bytes(k_b, wire_dtype) + offset_bytes(wb, k_b, wire_dtype)
            + _SCALE_BYTES[wire_dtype])


def compression_ratio_bytes(theta, *, wire_dtype: str = "f32",
                            wire_block: int = 1024, dense_bits=16):
    """Wire bytes of the sparse encoding as a fraction of the dense
    payload — the cost model's effective theta.  Exact per-block math
    (k_b = ceil(theta * wb), clamped to [1, wb]) over the same tables
    ``dist/collectives.wire_encode`` ships, elementwise over scalar or
    array theta (the controller's per-device vector)."""
    wb = int(wire_block)
    k_b = np.clip(np.ceil(np.asarray(theta, np.float64) * wb),
                  1, wb).astype(np.int64)
    return block_bytes(wb, k_b, wire_dtype) / (wb * dense_bits / 8)
