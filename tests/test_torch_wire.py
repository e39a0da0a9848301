"""The wire's plain versions against the JAX package, on the CPU.

The p4 offset pack and unpack bit for bit against ``pack_offsets_jnp`` /
``unpack_offsets_jnp`` and the Pallas kernels in interpret mode (the zero
payload included); the encode's plain version (the kernel's bisection) bit
for bit against ``encode_blocks_pallas(interpret=True)`` on blocks with
planted threshold ties, all-zero blocks and every k_b regime, and the
exact oracle against ``encode_blocks_jnp``; the encode of rows with the
offsets in their packed wire forms (what the fused encode kernel writes)
against the reference's pack of the reference encode's offsets, Pallas in
interpret mode included; the int8 / int4 / fp8 value
quantization bit for bit over a grid of ratios with half-ulp ties; and
``wire_encode`` / ``wire_decode`` round trips against the reference for
each wire dtype, and the wire's byte tables.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import wire_format as jwf  # noqa: E402
from repro.dist import collectives as jcol  # noqa: E402
from repro.kernels import wire_pack as jwp  # noqa: E402
from repro_torch.core import wire_format as twf  # noqa: E402
from repro_torch.dist import collectives as tcol  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wire_pack as twp  # noqa: E402

ALL = ("f32", "bf16", "int8", "int4", "fp8")
V2 = ("int4", "fp8")
# test_wire_v2.py's (wb, k_b) grid, both of its tests
PACK_GRID = [(1024, 1), (1024, 52), (1024, 205), (256, 8), (256, 200),
             (128, 7), (512, 26), (2048, 103)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want):
    """Bit for bit: equal shapes and values (bf16 by its bits; floats
    compare -0 equal to +0)."""
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        if got.dtype == torch.bfloat16:
            assert want.dtype == jnp.bfloat16
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        else:
            got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def sorted_offsets(rng, m, nb, wb, k_b):
    return np.stack([np.sort(rng.choice(wb, size=k_b, replace=False))
                     for _ in range(m * nb)]).reshape(m, nb, k_b).astype(
        np.int32)


@pytest.mark.parametrize("wb,k_b", PACK_GRID)
def test_pack_unpack_match_reference(wb, k_b):
    rng = np.random.default_rng(wb * 1000 + k_b)
    off = sorted_offsets(rng, 2, 4, wb, k_b)
    for mode in sorted({twf.offset_mode(wb, k_b, wd) for wd in V2}):
        want = np.asarray(jwp.pack_offsets_jnp(jnp.asarray(off), wb=wb,
                                               mode=mode))
        got = twp.pack_offsets_plain(t(off), wb=wb, mode=mode)
        same(got, want)
        back = twp.unpack_offsets_plain(got, wb=wb, k_b=k_b, mode=mode)
        same(back, off)
        same(back, jwp.unpack_offsets_jnp(jnp.asarray(want), wb=wb,
                                          k_b=k_b, mode=mode))
        # the zero payload of a partial rotation decodes to offset 0
        zero = np.zeros_like(want)
        z = twp.unpack_offsets_plain(t(zero), wb=wb, k_b=k_b, mode=mode)
        assert not z.any()
        same(z, jwp.unpack_offsets_jnp(jnp.asarray(zero), wb=wb, k_b=k_b,
                                       mode=mode))
        # ops routes the CPU tensor to the plain version
        same(ops.pack_offsets(t(off), wb=wb, mode=mode), want)
        same(ops.unpack_offsets(got, wb=wb, k_b=k_b, mode=mode), off)


@pytest.mark.parametrize("wb,k_b", [(1024, 52), (1024, 205), (512, 26),
                                    (2048, 103)])
def test_pack_unpack_match_pallas_interpret(wb, k_b):
    """The p4 kernels' plain versions against the Pallas kernels in
    interpret mode (test_wire_v2.py's grid), the zero payload included."""
    rng = np.random.default_rng(7 + wb + k_b)
    off = sorted_offsets(rng, 2, 4, wb, k_b)
    got = twp.pack_offsets_plain(t(off), wb=wb, mode="p4")
    same(got, jwp.pack_offsets_pallas(jnp.asarray(off), wb=wb, mode="p4",
                                      interpret=True))
    packed = np.concatenate([got.numpy(), np.zeros_like(got.numpy())])
    same(twp.unpack_offsets_plain(t(packed), wb=wb, k_b=k_b, mode="p4"),
         jwp.unpack_offsets_pallas(jnp.asarray(packed), wb=wb, k_b=k_b,
                                   mode="p4", interpret=True))


def tie_blocks(rng, m, nb, wb, k_b):
    """(m, nb, wb) f32 blocks covering the bisection's hard cases: block 0
    all zero; block 1 with fewer than k_b nonzeros; block 2 with many
    magnitudes equal to the k_b-th; block 3 with magnitudes spaced below
    the bisection's resolution (max * 2^-16) around the threshold; the
    rest normal.  Signs random."""
    x = rng.standard_normal((m, nb, wb)).astype(np.float32)
    for r in range(m):
        x[r, 0] = 0.0
        x[r, 1] = 0.0
        nz = max(k_b // 2, 1) if k_b > 1 else 0
        x[r, 1, rng.choice(wb, size=nz, replace=False)] = rng.standard_normal(
            nz).astype(np.float32)
        if nb > 2:
            v = np.abs(x[r, 2])
            thr = np.sort(v)[::-1][k_b - 1]
            pick = rng.choice(wb, size=min(wb, k_b + 5), replace=False)
            v[pick] = thr
            x[r, 2] = v
        if nb > 3:
            v = 1.0 + np.arange(wb, dtype=np.float32) * np.float32(2 ** -22)
            v[0] = 2.0  # the block max
            x[r, 3] = rng.permutation(v)
    return x * rng.choice([-1.0, 1.0], size=x.shape).astype(np.float32)


ENCODE_CASES = [(128, 1), (128, 128), (1000, 333), (1024, 52), (1024, 615),
                (2048, 103)]


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("wb,k_b", ENCODE_CASES)
def test_encode_plain_matches_pallas_bisection(wd, wb, k_b):
    rng = np.random.default_rng(wb + 7 * k_b)
    x = tie_blocks(rng, 2, 5, wb, k_b)
    want = jwp.encode_blocks_pallas(jnp.asarray(x), k_b, wire_dtype=wd,
                                    interpret=True)
    got = twp.encode_blocks_plain(t(x), k_b, wire_dtype=wd)
    for g, w in zip(got, want):
        same(g, w)
    assert got[0].dtype == {"f32": torch.float32, "bf16": torch.bfloat16,
                            "int8": torch.int8}.get(wd, torch.uint8)
    # exactly k_b kept, ascending, in every block (an all-zero one too)
    assert got[1].shape[-1] == k_b
    assert bool((got[1][..., 1:] > got[1][..., :-1]).all())


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("wb,k_b", ENCODE_CASES)
def test_exact_oracle_matches_encode_jnp(wd, wb, k_b):
    rng = np.random.default_rng(3 * wb + k_b)
    x = tie_blocks(rng, 2, 5, wb, k_b)
    want = jwp.encode_blocks_jnp(jnp.asarray(x), k_b, wire_dtype=wd)
    got = ref.encode_blocks_topk(t(x), k_b, wire_dtype=wd)
    for g, w in zip(got, want):
        same(g, w)
    got_ops = ops.encode_blocks(t(x), k_b, wire_dtype=wd, impl="ref")
    for g, w in zip(got_ops, got):
        assert torch.equal(g, w)


# (wb, k_b, offset form): the forms offset_mode picks on the gossip path,
# and p4 at small blocks too; L = 2 wb + wb // 3 + 1 (a ragged last block)
PACKED_CASES = [(128, 7, "u8"), (256, 200, "p4"), (1000, 333, "p4"),
                (1024, 615, "p4"), (2048, 103, "p4")]


@pytest.mark.parametrize("wd", V2)
@pytest.mark.parametrize("wb,k_b,omode", PACKED_CASES)
def test_encode_rows_packed_offsets_match_reference(wb, k_b, omode, wd):
    """``ops.encode_rows(..., omode=)`` on rows (0, 2) of a (3, L) matrix:
    with ``impl="ref"`` (the exact top-k) the reference's
    ``encode_blocks_jnp`` then ``pack_offsets_jnp``; with the plain route
    (the kernels' bisection) ``encode_blocks_pallas`` then
    ``pack_offsets_pallas``, both in interpret mode (int4 only: the
    offsets do not depend on the value type, and interpret mode compiles
    per shape), bit for bit."""
    rng = np.random.default_rng(wb + k_b)
    L = 2 * wb + wb // 3 + 1
    x = rng.standard_normal((3, L)).astype(np.float32)
    x[0, :wb] = 0.0  # an all-zero block
    x[2, wb:wb + 9] = 0.75  # tied magnitudes
    xb = np.pad(x[[0, 2]], ((0, 0), (0, (-L) % wb))).reshape(2, -1, wb)
    routes = [("ref", jwp.encode_blocks_jnp, jwp.pack_offsets_jnp)]
    if wd == "int4":
        routes.append(("plain", functools.partial(jwp.encode_blocks_pallas,
                                                  interpret=True),
                       functools.partial(jwp.pack_offsets_pallas,
                                         interpret=True)))
    for impl, encode, pack in routes:
        vals, off, scale = encode(jnp.asarray(xb), k_b, wire_dtype=wd)
        got = ops.encode_rows(t(x), (0, 2), k_b, wb=wb, wire_dtype=wd,
                              omode=omode, impl=impl)
        same(got[0], vals)
        same(got[1], pack(off, wb=wb, mode=omode))
        same(got[2], scale)
        # int32 offsets are the unpacked form
        i32 = ops.encode_rows(t(x), (0, 2), k_b, wb=wb, wire_dtype=wd,
                              impl=impl)[1]
        same(twp.unpack_offsets_plain(got[1], wb=wb, k_b=k_b, mode=omode),
             i32.numpy())


def test_bisection_and_exact_topk_differ_only_inside_the_band():
    """On a block whose magnitudes sit within the bisection's resolution,
    the two encodes may keep different members; on separated ones they
    agree (the reference's own contract, wire_pack.py:344)."""
    rng = np.random.default_rng(5)
    wb, k_b = 1024, 52
    sep = (rng.permutation(wb) + 1.0) / wb
    x = np.stack([sep, sep]).astype(np.float32).reshape(1, 2, wb)
    x[0, 1] = 1.0 + np.arange(wb) * 2.0 ** -22
    x[0, 1, 0] = 2.0
    a = twp.encode_blocks_plain(t(x), k_b, wire_dtype="f32")
    b = ref.encode_blocks_topk(t(x), k_b, wire_dtype="f32")
    assert torch.equal(a[1][0, 0], b[1][0, 0])
    assert not torch.equal(a[1][0, 1], b[1][0, 1])


def ratio_grid():
    """f32 ratios r in [-1, 1]: random; every e4m3 value and the midpoints
    between neighbours (fp8 ties) with their f32 neighbours; and the f32
    values next to the int4 / int8 rounding ties (r * 7, r * 127 at n +
    1/2)."""
    rng = np.random.default_rng(0)
    r = [rng.uniform(-1, 1, 4096).astype(np.float32)]
    e4m3 = np.asarray(jnp.arange(256, dtype=jnp.uint8).view(
        jnp.float8_e4m3fn).astype(jnp.float32))
    e4m3 = np.unique(e4m3[np.isfinite(e4m3) & (np.abs(e4m3) <= 1)])
    mids = ((e4m3[1:].astype(np.float64) + e4m3[:-1]) / 2).astype(np.float32)
    r += [e4m3, mids]
    for levels in (7.0, 127.0):
        n = np.arange(-levels, levels) + 0.5
        r.append((n / levels).astype(np.float32))
    base = np.concatenate(r)
    near = [np.nextafter(base, np.float32(s) * np.inf) for s in (-1, 1)]
    out = np.concatenate([base] + near)
    return np.clip(out, -1, 1).astype(np.float32)


@pytest.mark.parametrize("wd", ["int8", "int4", "fp8"])
def test_quantization_bit_for_bit_on_ties(wd):
    r = ratio_grid()
    k = 2 * (len(r) // 2)
    for scale in (1.0, 0.37):
        vals = (r[:k] * np.float32(scale)).reshape(1, 1, k).astype(
            np.float32)
        s = np.full((1, 1), scale, np.float32)
        want = jwp._quantize_vals(jnp.asarray(vals), jnp.asarray(s), wd)
        got = twp.quantize_vals(t(vals), t(s), wd)
        same(got, want)
        back = twp.dequantize_vals(got, t(s), k, wire_dtype=wd)
        same(back, jwp.dequantize_vals_jnp(want, jnp.asarray(s), k,
                                           wire_dtype=wd))


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("theta", [0.05, 1.0])
def test_wire_roundtrip_matches_reference(wd, theta):
    """wire_encode / wire_decode against the reference's, on rows with
    planted ties: with impl="ref" (the reference's CPU route) every
    payload field and the decode are bit for bit; the plain route (the
    bisection) decodes to rows with the same kept count a block."""
    rng = np.random.default_rng(int(theta * 100))
    m, wb, L = 3, 1024, 2500  # the last block is padded
    k_b = tcol.wire_k(theta, L, wb)
    assert k_b == jcol.wire_k(theta, L, wb)
    x = tie_blocks(rng, m, -(-L // wb), wb, k_b).reshape(m, -1)[:, :L]
    jw = jcol.wire_encode(jnp.asarray(x), k_b, wire_block=wb, wire_dtype=wd)
    tw = tcol.wire_encode(t(x), k_b, wire_block=wb, wire_dtype=wd,
                          impl="ref")
    for g, w in zip(tw, jw):
        if w is None:
            assert g is None
        else:
            same(g, w)
    jd = jcol.wire_decode(jw, L, wire_block=wb, wire_dtype=wd, k_b=k_b)
    td = tcol.wire_decode(tw, L, wire_block=wb, wire_dtype=wd, k_b=k_b)
    same(td, jd)
    pw = tcol.wire_encode(t(x), k_b, wire_block=wb, wire_dtype=wd)
    pd = tcol.wire_decode(pw, L, wire_block=wb, wire_dtype=wd, k_b=k_b)
    assert pd.shape == (m, L)
    if wd == "f32":  # the kept values are exact, so count them
        xp = np.pad(x, ((0, 0), (0, (-L) % wb))).reshape(m, -1, wb)
        dp = np.pad(pd.numpy(), ((0, 0), (0, (-L) % wb))).reshape(m, -1, wb)
        assert np.array_equal(dp[dp != 0], xp[dp != 0])


def test_wire_v2_decode_needs_k_b_and_int8_block_limit():
    w = tcol.wire_encode(torch.ones(1, 64), 8, wire_block=64,
                         wire_dtype="int4")
    with pytest.raises(ValueError, match="k_b"):
        tcol.wire_decode(w, 64, wire_block=64, wire_dtype="int4")
    with pytest.raises(ValueError, match="32768"):
        tcol.wire_encode(torch.ones(1, 40000), 8, wire_block=40000,
                         wire_dtype="int8")
    with pytest.raises(ValueError, match="wire_dtype"):
        tcol.wire_encode(torch.ones(1, 64), 8, wire_dtype="fp16")


@pytest.mark.parametrize("wd", ALL)
def test_byte_tables_match_reference(wd):
    for L in (64, 1000, 2500, 1 << 20):
        for wbk in (128, 1024, 4096):
            for theta in (0.01, 0.05, 0.3, 0.6, 1.0):
                assert tcol.wire_bytes_per_row(
                    theta, L, wire_dtype=wd, wire_block=wbk) == \
                    jcol.wire_bytes_per_row(theta, L, wire_dtype=wd,
                                            wire_block=wbk)
                for item in (2, 4):
                    assert tcol.wire_ships_dense(
                        theta, L, wire_dtype=wd, wire_block=wbk,
                        dense_itemsize=item) == jcol.wire_ships_dense(
                        theta, L, wire_dtype=wd, wire_block=wbk,
                        dense_itemsize=item)
            for k_b in (1, 7, 100, 255):
                assert twf.offset_mode(min(L, wbk), k_b, wd) == \
                    jwf.offset_mode(min(L, wbk), k_b, wd)
    # the offset modes the v2 wire picks (test_wire_v2.py's grid)
    for wb, k_b in PACK_GRID:
        assert twf.offset_mode(wb, k_b, wd) == jwf.offset_mode(wb, k_b, wd)


def test_wire_plans_match_reference():
    for wd in ALL:
        for lv in [(0.05, 0.05, 1.0, 0.2), (0.6, 0.1), (1.0, 1.0, 1.0)]:
            for L in (2048, 2500, 96):
                for item in (2, 4):
                    want = jcol._wire_plans(lv, L, 1024, wd, item)
                    got = tcol._wire_plans(lv, L, 1024, wd, item)
                    assert got == [(k, s) for k, s, _ in want]


def test_kernel_wrappers_refuse_cpu_tensors():
    """On the CPU ops routes to the plain versions; asked for the kernel
    there, each wrapper raises before launching anything."""
    twp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ops.encode_blocks(torch.zeros(1, 2, 128), 4, wire_dtype="int4",
                          impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.pack_offsets(torch.zeros(1, 2, 4, dtype=torch.int32), wb=128,
                         mode="p4", impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.unpack_offsets(torch.zeros(1, 2, sum(twp._p4_sizes(128, 4)),
                                       dtype=torch.uint8),
                           wb=128, k_b=4, mode="p4", impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.encode_rows(torch.zeros(3, 300), (0, 2), 4, wb=128,
                        wire_dtype="int4", impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        ops.wire_decode_mix(torch.zeros(2, 256), [], wb=128,
                            wire_dtype="int4", impl="kernel")
    assert twp.LAUNCHES == {"wire_encode": 0, "wire_pack": 0,
                            "wire_unpack": 0, "wire_decode_mix": 0}
