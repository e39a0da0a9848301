"""The bf16 attention backward's order of work, emulated on the CPU and held
to the JAX package's gradient.

``csrc/flash_attention_bwd.cu`` runs bf16 in two wgmma passes after
``flash_bwd_prep``: the dK/dV pass, a CTA per (b, KV head, 64-key block)
whose two consumer warpgroups take its (query head, 64-row query block)
tiles in turn and sum their dK and dV once at the end, and the dQ pass, a
CTA per two (query head, 64-row query block) units of a (b, KV head), one
warpgroup a unit, over the units' live key blocks.
``emulate_bwd_wgmma`` below does the same work in the same order in plain
torch: the same live tiles (``dkdv_items`` and ``dq_ctas`` mirror the
kernels' ``live_rows``, ``live_keys`` and ``dq_unit``), the same split of the tiles
between the two warpgroups, the same fixed-order sum, P^T and dS rounded
to bf16 where the kernels round them, every other step in f32.  At head
dim 256 the kernels split the head dim instead: both warpgroups take
every item, each owning half of dK's and dV's columns (so each column
sums its items in order, with no sum between the warpgroups), and a dQ
CTA holds one unit.  The card
cannot be reached here, so this is how the design's rounding and order
are shown to meet the gate that ``chip_smoke.py`` phase 14 holds the
kernels to: each gradient within 2e-2 of its largest entry (bf16).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TILE = 64  # kB in csrc/flash_attention_bwd.cu
LOG2E = 1.4426950408889634
# each gradient within this share of its largest entry: chip_smoke.py's
# BWD_TOL_OF_MAX for bf16 (P and dS are rounded to bf16 in the kernels)
TOL_OF_MAX = 2e-2

# (B, S, KH, G, Dh, causal, window): G 1-3, S 65-200 (ragged and whole
# tiles), Dh 16, 64 and 128, causal and not, a window
CASES = [
    (1, 65, 3, 1, 16, True, 0),
    (2, 130, 2, 2, 64, False, 0),
    (1, 200, 2, 3, 64, True, 0),
    (1, 130, 1, 3, 64, False, 16),
    (1, 200, 1, 2, 128, True, 0),
    (1, 128, 2, 3, 128, True, 96),
    (1, 130, 1, 3, 256, True, 96),  # MQA at head dim 256 under a window
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from threads, and a pool of them per
    test worker oversubscribes the cores the suite shares."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dkdv_items(k0, nk, Sq, G, causal, window):
    """The dK/dV CTA's (head in group, query block) items in the kernel's
    order for keys [k0, k0 + nk): every head of the group, each over the
    query blocks that hold the keys' live rows (``live_rows``)."""
    lo = k0 if causal else 0
    hi = Sq - 1
    if window:
        hi = min(hi, k0 + nk - 1 + window - 1)
    if lo > hi:
        return []
    return [(hg, qb) for hg in range(G)
            for qb in range(lo // TILE, hi // TILE + 1)]


def dq_tiles(q0, nq, Skv, causal, window):
    """The key blocks of rows [q0, q0 + nq) in the kernel's order
    (``live_keys``)."""
    hi = min(Skv - 1, q0 + nq - 1) if causal else Skv - 1
    lo = max(0, q0 - window + 1) if window else 0
    return list(range(lo // TILE, hi // TILE + 1)) if lo <= hi else []


def dq_ctas(Sq, Skv, G, causal, window, per_cta=2):
    """The dQ CTAs of a (b, KV head) in launch order, each the (head in
    group, query block, key blocks) of its ``per_cta`` units or fewer
    (two, one at head dim 256; ``dq_unit``: unit u is query block n - 1 -
    u // G of head u % G), and the key blocks its producer streams (the
    hull of its units')."""
    n = -(-Sq // TILE)
    units = []
    for u in range(n * G):
        qb = n - 1 - u // G
        units.append((u % G, qb, dq_tiles(qb * TILE, min(TILE, Sq - qb *
                                                         TILE), Skv, causal,
                                           window)))
    ctas = []
    for c in range(0, len(units), per_cta):
        pair = units[c:c + per_cta]
        seen = [kb for _, _, t in pair for kb in t]
        hull = list(range(min(seen), max(seen) + 1)) if seen else []
        ctas.append((pair, hull))
    return ctas


def _live(i, j, Sq, Skv, causal, window):
    """(len(i), len(j)) mask of the live (query, key) pairs."""
    i, j = i[:, None], j[None, :]
    keep = (i < Sq) & (j < Skv)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    return keep


def _tile(x, b, r0, hh):
    """Rows r0 .. r0 + 63 of head hh of x (B, S, NH, Dh) in f32, rows past
    the end as zeros (TMA's fill)."""
    rows = x[b, r0:r0 + TILE, hh].float()
    return torch.nn.functional.pad(rows, (0, 0, 0, TILE - rows.shape[0]))


def _bf16(x):
    return x.bfloat16().float()


def emulate_bwd_wgmma(q, k, v, out, lse, dout, *, causal, window):
    """dq, dk, dv (bf16) of the bf16 route, step by step in its order."""
    B, Sq, H, Dh = q.shape
    _, Skv, KH, _ = k.shape
    G = H // KH
    split = Dh == 256  # both warpgroups take every item, half the columns
    scale = Dh ** -0.5
    sl2 = scale * LOG2E
    D = (out.float() * dout.float()).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    L = lse.float() * LOG2E
    rows = torch.arange(TILE)
    dq = torch.zeros((B, Sq, H, Dh))
    dk = torch.zeros((B, Skv, KH, Dh))
    dv = torch.zeros((B, Skv, KH, Dh))

    def row_vals(x, b, h, r0):
        vals = x[b, h, r0:r0 + TILE]
        return torch.nn.functional.pad(vals, (0, TILE - vals.shape[0]))

    for b in range(B):
        for kh in range(KH):
            for k0 in range(0, Skv, TILE):
                K, V = _tile(k, b, k0, kh), _tile(v, b, k0, kh)
                acc = [[torch.zeros((TILE, Dh)) for _ in range(2)]
                       for _ in range(2)]  # acc[w] = [dK_w, dV_w]
                items = dkdv_items(k0, min(TILE, Skv - k0), Sq, G, causal,
                                   window)
                for it, (hg, qb) in enumerate(items):
                    w, h, q0 = (0 if split else it % 2), kh * G + hg, \
                        qb * TILE
                    Q, dO = _tile(q, b, q0, h), _tile(dout, b, q0, h)
                    live = _live(q0 + rows, k0 + rows, Sq, Skv, causal,
                                 window).T
                    pT = torch.where(live, torch.exp2(
                        (K @ Q.T) * sl2 - row_vals(L, b, h, q0)), 0.0)
                    dsT = pT * ((V @ dO.T) - row_vals(D, b, h, q0))
                    acc[w][1] += _bf16(pT) @ dO
                    acc[w][0] += _bf16(dsT) @ Q
                n = min(TILE, Skv - k0)
                dk[b, k0:k0 + n, kh] = ((acc[1][0] + acc[0][0]) * scale)[:n]
                dv[b, k0:k0 + n, kh] = (acc[0][1] + acc[1][1])[:n]
        for kh in range(KH):
            units = [u for pair, _ in dq_ctas(Sq, Skv, G, causal, window,
                                              1 if split else 2)
                     for u in pair]
            for hg, qb, tiles in units:
                h, q0 = kh * G + hg, qb * TILE
                Q, dO = _tile(q, b, q0, h), _tile(dout, b, q0, h)
                Lr, Dr = row_vals(L, b, h, q0), row_vals(D, b, h, q0)
                adq = torch.zeros((TILE, Dh))
                for kb in tiles:
                    k0 = kb * TILE
                    K, V = _tile(k, b, k0, kh), _tile(v, b, k0, kh)
                    live = _live(q0 + rows, k0 + rows, Sq, Skv, causal,
                                 window)
                    p = torch.where(live, torch.exp2(
                        (Q @ K.T) * sl2 - Lr[:, None]), 0.0)
                    ds = p * ((dO @ V.T) - Dr[:, None])
                    adq += _bf16(ds) @ K
                n = min(TILE, Sq - q0)
                dq[b, q0:q0 + n, h] = (adq * scale)[:n]
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


def _inputs(seed, B, S, KH, G, Dh):
    """q, k, v, dout drawn with numpy and rounded to bf16 (the card's
    inputs), as f32 numpy arrays holding those values."""
    rng = np.random.default_rng(seed)
    shapes = ((B, S, KH * G, Dh), (B, S, KH, Dh), (B, S, KH, Dh),
              (B, S, KH * G, Dh))
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32))
            .bfloat16().float().numpy() for s in shapes]


@functools.lru_cache(maxsize=None)
def _jax_grads(case):
    B, S, KH, G, Dh, causal, window = case
    q, k, v, g = _inputs(sum(case[:5]), B, S, KH, G, Dh)
    fn = functools.partial(jref.flash_attention_jnp, causal=causal,
                           window=window)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return (q, k, v, g), [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_emulated_bf16_backward_meets_the_gate(case):
    """The emulation, fed the forward's bf16 out and its lse, against
    ``jax.vjp`` of the reference's jnp route in f32 on the same values."""
    B, S, KH, G, Dh, causal, window = case
    (q, k, v, g), want = _jax_grads(case)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    out, lse = ref.flash_attention_blockwise(tq, tk, tv, causal=causal,
                                             window=window, return_lse=True)
    got = emulate_bwd_wgmma(tq, tk, tv, out, lse, tg, causal=causal,
                            window=window)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(a.float().numpy() - w).max())
        assert err <= TOL_OF_MAX * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_emulation_tracks_the_plain_version(case):
    """The emulation differs from the plain version (which the card is
    held to) only by the bf16 rounding of P^T and dS: far inside the gate,
    and the plain version itself on f32 values of the same numbers."""
    B, S, KH, G, Dh, causal, window = case
    q, k, v, g = _inputs(sum(case[:5]) + 1, B, S, KH, G, Dh)
    tq, tk, tv, tg = (torch.from_numpy(x).bfloat16() for x in (q, k, v, g))
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_blockwise(tq, tk, tv, return_lse=True,
                                             **kw)
    got = emulate_bwd_wgmma(tq, tk, tv, out, lse, tg, **kw)
    want = ref.flash_attention_bwd_plain(tq, tk, tv, out, lse, tg, **kw)
    for a, w in zip(got, want):
        scale = float(w.float().abs().max())
        assert float((a.float() - w.float()).abs().max()) <= \
            TOL_OF_MAX / 2 * scale


@pytest.mark.parametrize("S,G,causal,window", [
    (65, 1, True, 0), (200, 3, True, 0), (130, 2, False, 0),
    (130, 3, False, 16), (256, 2, True, 96), (1000, 3, True, 96),
    (2048, 3, True, 0)])
def test_tiles_cover_every_live_pair_once(S, G, causal, window):
    """Over a KV head, the dK/dV CTAs' items and the dQ CTAs' key blocks
    each visit every (head, key block, query block) tile that holds a live
    pair exactly once, and no tile without one."""
    n = -(-S // TILE)
    pos = np.arange(S)
    live = _live(torch.from_numpy(pos), torch.from_numpy(pos), S, S, causal,
                 window).numpy()
    want = {(hg, kb, qb) for hg in range(G) for kb in range(n)
            for qb in range(n)
            if live[qb * TILE:(qb + 1) * TILE, kb * TILE:(kb + 1) * TILE]
            .any()}
    by_keys = [(hg, kb, qb) for kb in range(n)
               for hg, qb in dkdv_items(kb * TILE, min(TILE, S - kb * TILE),
                                        S, G, causal, window)]
    ctas = dq_ctas(S, S, G, causal, window)
    by_rows = [(hg, kb, qb) for pair, _ in ctas for hg, qb, tiles in pair
               for kb in tiles]
    for seen in (by_keys, by_rows):
        assert len(seen) == len(set(seen)) and set(seen) == want
    # every dQ CTA but the last holds two units, and streams each unit's
    # key blocks (its hull has no block that neither unit reads)
    assert all(len(pair) == 2 for pair, _ in ctas[:-1])
    for pair, hull in ctas:
        assert set(hull) == {kb for _, _, t in pair for kb in t}


@pytest.mark.parametrize("S,G,causal,window", [(130, 3, True, 96),
                                               (4096, 16, True, 2048)])
def test_head_dim_256_dq_ctas_take_one_unit_each(S, G, causal, window):
    """At head dim 256 a dQ CTA holds one unit (its Q and dO are 64 KB):
    the CTAs are the units, each streams exactly its own key blocks, and
    together they visit every live (head, key block, query block) tile
    once."""
    n = -(-S // TILE)
    ctas = dq_ctas(S, S, G, causal, window, per_cta=1)
    assert len(ctas) == n * G and all(len(pair) == 1 for pair, _ in ctas)
    assert all(hull == pair[0][2] for pair, hull in ctas)
    seen = [(hg, kb, qb) for pair, _ in ctas for hg, qb, tiles in pair
            for kb in tiles]
    by_keys = [(hg, kb, qb) for kb in range(n)
               for hg, qb in dkdv_items(kb * TILE, min(TILE, S - kb * TILE),
                                        S, G, causal, window)]
    assert len(seen) == len(set(seen)) and set(seen) == set(by_keys)
