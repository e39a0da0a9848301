"""The warp-per-block p4 pack and unpack kernels' steps on the CPU.

``pack_p4_words_plain`` / ``unpack_p4_words_plain`` below follow the
warp kernels of ``csrc/wire_pack.cu`` step by step (the lanes' rounds of
offsets and shared bitmap words; the 16-byte chunks that stage a block
from any byte, the lanes' runs of bitmap words, the shuffle scan, each
lane's walk and the row's 16-byte stores at any output phase).  They are
held bit for bit to the plain versions (what the card's kernels are held
to) and to the reference's ``pack_offsets_jnp`` / ``unpack_offsets_jnp``
and Pallas kernels in interpret mode, on the edge grid that
``chip_smoke.py`` phase 10 runs on the card: wire blocks 1-4096, k_b 1,
7, wb / 10, wb / 2 - 1, wb - 1 and wb, and payloads that are valid, all
zero, short of set bits, over-full and random bytes.  Where a bitmap has
fewer than k_b set bits the jnp version decodes a rank past them at a
clear bit's position, the Pallas kernel (and the port) at hi = 0.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import wire_pack as jwp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wire_pack as twp  # noqa: E402

# chip_smoke.py:WIRE_BLOCKS and phase 10's p4 grid
BLOCKS = (1, 31, 33, 64, 128, 257, 1000, 1024, 2048, 4096)


def kbs(wb):
    return sorted({k for k in (1, 7, wb // 10, wb // 2 - 1, wb - 1, wb)
                   if 1 <= k <= wb})


GRID = [(wb, k) for wb in BLOCKS for k in kbs(wb)]


def pack_p4_words_plain(off, *, wb: int):
    """The warp pack kernel's steps (``csrc/wire_pack.cu``) on the CPU:
    in round r lane l takes offset i = 32 r + l, writes its
    low nibble and votes its bit (off_i >> 4) + i (none past k_b or
    outside the bitmap); the lanes of one word OR their bits and the
    lowest ORs them into the word; then ``p4_store``'s bytes.  off: (...,
    k_b) int32 -> (..., nbytes) uint8."""
    off = np.asarray(off, np.int64)
    k_b = off.shape[-1]
    lo_bytes, bm_bytes = twp._p4_sizes(wb, k_b)
    flat = off.reshape(-1, k_b)
    onib = np.zeros((flat.shape[0], 2 * lo_bytes), np.int64)
    words = np.zeros((flat.shape[0], -(-bm_bytes // 4)), np.int64)
    for b, row in enumerate(flat):
        for i0 in range(0, k_b, 32):
            votes = {}  # word -> its lanes' bits ORed
            for lane in range(32):
                i = i0 + lane
                if i >= k_b:
                    continue
                onib[b, i] = row[i] & 15
                pos = (int(row[i]) >> 4) + i
                if 0 <= pos < 8 * bm_bytes:
                    votes[pos >> 5] = votes.get(pos >> 5, 0) | 1 << (pos & 31)
            for word, bits in votes.items():  # one atomic a word
                words[b, word] |= bits
    lo = onib[:, 0::2] | (onib[:, 1::2] << 4)
    j = np.arange(bm_bytes)
    bm = (words[:, j >> 2] >> (8 * (j & 3))) & 255
    out = np.concatenate([lo, bm], axis=1).astype(np.uint8)
    return torch.from_numpy(out.reshape(off.shape[:-1] + (-1,)))


def unpack_p4_words_plain(packed, *, wb: int, k_b: int, in_phase: int = 0,
                          out_phase: int = 0):
    """The warp unpack kernel's steps (``csrc/wire_pack.cu``) on the CPU,
    block by block.  The blocks lie back to back starting
    ``in_phase`` bytes into a 16-byte chunk, the offsets ``out_phase``
    int32s into one.  Each block's bytes come from the 16-byte chunks that
    cover them; lane l takes the bitmap words [l nwords / 32, (l + 1)
    nwords / 32) and its popcount; a 5-step shuffle scan gives each lane
    its first rank; each lane walks its set bits into the row, ranks past
    k_b dropped; ranks past the set bits take their low nibble; the row
    leaves by the 16-byte chunks of the output (whole ones as one store,
    the two ends entry by entry), and every entry must be stored once.
    (..., nbytes) uint8 -> (..., k_b) int32."""
    p = np.asarray(packed, np.uint8)
    lo_bytes, bm_bytes = twp._p4_sizes(wb, k_b)
    nbytes = lo_bytes + bm_bytes
    flat = p.reshape(-1, nbytes)
    nblk = flat.shape[0]
    mem = np.zeros(in_phase + nblk * nbytes + 32, np.uint8)
    mem[in_phase:in_phase + nblk * nbytes] = flat.reshape(-1)
    out = np.full(out_phase + nblk * k_b, -1, np.int64)
    stored = np.zeros(out_phase + nblk * k_b, np.int64)
    nwords = -(-bm_bytes // 4)
    for b in range(nblk):
        addr = in_phase + b * nbytes
        head = addr & 15
        chunks = (head + nbytes + 15) >> 4
        stage = mem[addr - head:addr - head + 16 * chunks]
        assert len(stage) == 16 * chunks
        lo = stage[head:head + lo_bytes].astype(np.int64)
        bits = stage[head + lo_bytes:head + nbytes].astype(np.int64)
        nib = lambda i: (lo[i >> 1] >> (4 * (i & 1))) & 15
        word = [sum(int(bits[4 * w + j]) << (8 * j) for j in range(4)
                    if 4 * w + j < bm_bytes) for w in range(nwords)]
        runs = [range((lane * nwords) >> 5, ((lane + 1) * nwords) >> 5)
                for lane in range(32)]
        count = [sum(bin(word[w]).count("1") for w in run) for run in runs]
        incl = list(count)
        for d in (1, 2, 4, 8, 16):
            incl = [incl[lane] + (incl[lane - d] if lane >= d else 0)
                    for lane in range(32)]
        total = incl[31]
        row = {}
        for lane in range(32):
            rank = incl[lane] - count[lane]
            for w in runs[lane]:
                for bit in range(32):
                    if rank < k_b and word[w] >> bit & 1:
                        row[rank] = 16 * max(32 * w + bit - rank, 0) + nib(
                            rank)
                        rank += 1
        for i in range(total, k_b):
            row[i] = nib(i)
        assert sorted(row) == list(range(k_b))
        g = out_phase + b * k_b  # the row's first int32
        a = g & 3
        for q in range((a + k_b + 3) >> 2):
            e0 = 4 * q - a
            for e in range(max(e0, 0), min(e0 + 4, k_b)):
                out[g + e] = row[e]
                stored[g + e] += 1
    assert (stored[out_phase:] == 1).all()
    res = out[out_phase:].astype(np.int32).reshape(p.shape[:-1] + (k_b,))
    return torch.from_numpy(res)


def jitted(fn, **kw):
    """The reference's jnp function as one compiled program (its eager ops
    would compile one by one at every shape of the grid)."""
    return jax.jit(functools.partial(fn, **kw))


def sorted_offsets(rng, n, wb, k_b):
    return np.stack([np.sort(rng.choice(wb, size=k_b, replace=False))
                     for _ in range(n)]).astype(np.int32)


def payloads(wb, k_b, seed):
    """(blocks, nbytes) uint8: two valid blocks, an all-zero one, two with
    set bits cleared (short), two with bits added (over-full: a bitmap
    always has more bits than k_b) and two of random bytes; and the valid
    blocks' int32 offsets."""
    rng = np.random.default_rng(seed)
    off = sorted_offsets(rng, 2, wb, k_b)
    valid = twp.pack_offsets_plain(torch.from_numpy(off), wb=wb,
                                   mode="p4").numpy()
    lo_bytes, bm_bytes = twp._p4_sizes(wb, k_b)
    bm = lambda p: p[:, lo_bytes:]
    short = valid.copy()
    for b in bm(short):  # keep the first n < k_b set bits (n = 0 too)
        bits = np.unpackbits(b, bitorder="little")
        keep = np.flatnonzero(bits)[:rng.integers(0, k_b)]
        bits[:] = 0
        bits[keep] = 1
        b[:] = np.packbits(bits, bitorder="little")
    full = valid.copy()
    for b in bm(full):  # set the last clear bit and about half the others
        bits = np.unpackbits(b, bitorder="little")
        clear = np.flatnonzero(bits == 0)
        bits[clear[-1]] = 1
        bits[clear[rng.random(len(clear)) < 0.5]] = 1
        b[:] = np.packbits(bits, bitorder="little")
    rand = rng.integers(0, 256, (2, lo_bytes + bm_bytes), dtype=np.uint8)
    zero = np.zeros((1, lo_bytes + bm_bytes), np.uint8)
    return np.concatenate([valid, zero, short, full, rand]), off


def set_bits(packed, lo_bytes):
    return np.unpackbits(packed[:, lo_bytes:], axis=1).sum(axis=1)


@pytest.mark.parametrize("wb,k_b", GRID)
def test_unpack_words_is_the_plain_and_the_reference(wb, k_b):
    packed, off = payloads(wb, k_b, wb * 7919 + k_b)
    lo_bytes, _ = twp._p4_sizes(wb, k_b)
    n = set_bits(packed, lo_bytes)
    assert (n[[3, 4]] < k_b).all() and n[2] == 0  # short and zero
    assert (n[[5, 6]] > k_b).all()  # over-full
    want = twp.unpack_offsets_plain(torch.from_numpy(packed), wb=wb, k_b=k_b,
                                    mode="p4")
    for in_phase, out_phase in ((0, 0), ((wb + k_b) % 16, k_b % 4),
                                (15, 3)):
        got = unpack_p4_words_plain(torch.from_numpy(packed), wb=wb,
                                        k_b=k_b, in_phase=in_phase,
                                        out_phase=out_phase)
        assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(want[:2], torch.from_numpy(off))  # lossless
    assert not want[2].any()  # the zero payload: offset 0
    # the jnp reference agrees wherever the bitmap has no rank to spare
    # (k_b set bits or more, or none at all)
    ref = np.asarray(jitted(jwp.unpack_offsets_jnp, wb=wb, k_b=k_b,
                            mode="p4")(jnp.asarray(packed)))
    rows = (n >= k_b) | (n == 0)
    assert rows.sum() >= 5
    np.testing.assert_array_equal(want.numpy()[rows], ref[rows])
    # ops routes the CPU tensor to the plain version
    assert torch.equal(ops.unpack_offsets(torch.from_numpy(packed), wb=wb,
                                          k_b=k_b, mode="p4"), want)


@pytest.mark.parametrize("wb,k_b", GRID)
def test_pack_words_is_the_plain_and_the_reference(wb, k_b):
    rng = np.random.default_rng(wb * 31 + k_b)
    off = sorted_offsets(rng, 3, wb, k_b).reshape(1, 3, k_b)
    want = twp.pack_offsets_plain(torch.from_numpy(off), wb=wb, mode="p4")
    got = pack_p4_words_plain(torch.from_numpy(off), wb=wb)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(jitted(jwp.pack_offsets_jnp, wb=wb,
                                        mode="p4")(jnp.asarray(off))))
    assert torch.equal(ops.pack_offsets(torch.from_numpy(off), wb=wb,
                                        mode="p4"), want)


@pytest.mark.parametrize("wb,k_b", [(257, 25), (1000, 7), (1024, 511),
                                    (1024, 1024)])
def test_the_port_follows_the_pallas_kernels_on_any_bytes(wb, k_b):
    """Short, over-full and random bitmaps included: the Pallas unpack
    clamps a rank past the set bits to hi = 0, as the port does."""
    packed, off = payloads(wb, k_b, wb + k_b)
    want = np.asarray(jwp.unpack_offsets_pallas(
        jnp.asarray(packed[None]), wb=wb, k_b=k_b, mode="p4",
        interpret=True))[0]
    t = torch.from_numpy(packed)
    np.testing.assert_array_equal(
        twp.unpack_offsets_plain(t, wb=wb, k_b=k_b, mode="p4").numpy(), want)
    np.testing.assert_array_equal(
        unpack_p4_words_plain(t, wb=wb, k_b=k_b, in_phase=9,
                                  out_phase=1).numpy(), want)
    np.testing.assert_array_equal(
        pack_p4_words_plain(torch.from_numpy(off), wb=wb).numpy(),
        np.asarray(jwp.pack_offsets_pallas(jnp.asarray(off[None]), wb=wb,
                                           mode="p4", interpret=True))[0])


def test_routes_by_shape():
    assert [twp.encode_route(wb) for wb in BLOCKS] == \
        ["warp"] * 8 + ["block"] * 2


@pytest.mark.parametrize("wb,k_b,force_block", [(1024, 2000, False),
                                                (2048, 0, False),
                                                (128, 129, True)])
def test_kernel_wrappers_check_k_b_first(wb, k_b, force_block):
    """The wrappers refuse a CPU tensor, then an offset count the kernels
    do not take (on either route), before anything is launched."""
    twp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        twp.unpack_offsets_cuda(torch.zeros(1, 1, 8, dtype=torch.uint8),
                                wb=wb, k_b=k_b, _force_block=force_block)
    with pytest.raises(ValueError, match="k_b"):
        twp._p4_warp("wire_unpack", wb, k_b, force_block)
    assert twp.LAUNCHES["wire_unpack"] == 0
