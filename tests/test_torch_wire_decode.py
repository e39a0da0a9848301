"""The gossip's decode-and-mix and row encode, plain versions, on the CPU.

``wire_pack.decode_mix_plain`` (what ``ops.wire_decode_mix`` runs on the
CPU, and what the card's decode-and-mix kernel is held to bit for bit) is
held bit for bit (``torch.equal`` on int32 views, so -0 and +0 differ) to
the chain the gossip ran before it, written out here from ``wire_decode``,
``torch.roll`` and the zero fill of a partial rotation: every wire dtype,
u8 and p4 offsets, wire blocks 128, 1000, 1024 and 2048, k_b 1 and wb,
partial senders and dense plans, ring, complete and erdos_renyi
backhauls, more steps than a kernel launch takes, and y holding -0.
``encode_rows_plain`` is held to ``index_select``, the zero pad and
``encode_blocks_plain``, the ragged last block and wb = L < 32 included.
Plain torch only: nothing here compiles JAX.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core import wire_format as wf
from repro_torch.dist import collectives as tcol
from repro_torch.kernels import ops, ref
from repro_torch.kernels import wire_pack as twp

ALL = ("f32", "bf16", "int8", "int4", "fp8")
# (hkind, C, wb, L, per-cluster levels, dense rows' type): partial
# senders in every case, a dense plan where a level reaches the dense row
CASES = {
    "ring2": ("ring", 2, 1024, 3000, (0.1, 0.6), torch.bfloat16),
    "ring4_dense": ("ring", 4, 1000, 2600, (0.05, 1.0, 0.25, 0.05),
                    torch.float32),
    "complete4": ("complete", 4, 2048, 5000, (1e-4, 1.0, 0.3, 1e-4),
                  torch.bfloat16),
    "erdos8_u8": ("erdos_renyi", 8, 128, 700,
                  (0.02, 0.5, 0.02, 0.03, 0.5, 1.0, 0.02, 0.3),
                  torch.bfloat16),
}


def bits(t):
    return t.contiguous().view(torch.int32)


def cluster_means(seed, C, L):
    """(C, L) f32 with exact zeros of both signs and tied magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, L)).astype(np.float32)
    x[:, ::7] = np.float32(-0.0)
    x[:, 3::11] = np.float32(0.0)
    x[:, 5::13] = np.sign(x[:, 5::13]) * np.float32(0.75)
    return torch.from_numpy(x)


def gossip(case, wd, seed=0):
    """(means, layout, payloads, steps, wb) of one chunk's gossip: the
    plans encoded with the kernels' plain route, as the gossip builds
    them."""
    hkind, C, wbk, L, levels, dense = case
    wb = wf.wire_block_of(L, wbk)
    plans = tcol._wire_plans(levels, L, wbk, wd,
                             torch.empty((), dtype=dense).element_size())
    layout = tcol._gossip_layout(hkind, C, 0.4, 0, tuple(plans))
    means = cluster_means(seed, C, L)
    payloads = []
    for key, rows, _ in layout.plans:
        if key[0] == "dense":
            sub = means if rows is None else means[list(rows)]
            payloads.append(((sub.to(dense).contiguous(),), None, rows))
        else:
            payloads.append((tuple(tcol._encode(means, rows, key[1], wb,
                                                wd)), key[1], rows))
    steps = [twp.MixStep(o, tuple(coef), p, k_b, senders)
             for o, coef in layout.bands
             for (p, k_b, _), (_, _, senders) in zip(payloads,
                                                     layout.plans)]
    return means, layout, payloads, steps, wb


def old_chain(y, layout, payloads, wb, wd):
    """The gossip's band loop as it ran before the decode-and-mix: per
    band and plan, the senders' rows zero-filled to C rows, rolled by the
    band offset, decoded with ``wire_decode`` and added times the band's
    coefficients."""
    C, L = y.shape
    col = lambda v: torch.as_tensor(v, dtype=torch.float32)[:, None]
    for o, coef in layout.bands:
        for payload, k_b, rows in payloads:
            if rows is not None:
                idx = torch.as_tensor(rows, dtype=torch.long)
                payload = tuple(None if p is None else torch.zeros(
                    (C,) + tuple(p.shape[1:]), dtype=p.dtype).index_copy_(
                        0, idx, p) for p in payload)
            rolled = tuple(None if p is None else torch.roll(p, o, dims=0)
                           for p in payload)
            if k_b is None:
                dec = rolled[0].float()
            else:
                dec = tcol.wire_decode(tcol.Wire(*rolled), L, wire_block=wb,
                                       wire_dtype=wd, k_b=k_b)
            y = y + col(coef) * dec
    return y


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_mix_plain_is_the_old_chain(name, wd):
    means, layout, payloads, steps, wb = gossip(CASES[name], wd)
    assert any(s < 0 for *_, senders in layout.plans for s in senders)
    want = old_chain(torch.as_tensor(layout.diag, dtype=torch.float32)
                     [:, None] * means, layout, payloads, wb, wd)
    got = twp.decode_mix_plain(means, steps, wb=wb, wire_dtype=wd,
                               diag=layout.diag)
    assert torch.equal(bits(got), bits(want))
    # ops routes the CPU tensor to the plain version
    assert torch.equal(bits(ops.wire_decode_mix(
        means, steps, wb=wb, wire_dtype=wd, diag=layout.diag)), bits(want))
    # without diag, y is mixed as it is, -0 entries included
    assert (torch.signbit(means) & (means == 0)).any()
    assert torch.equal(
        bits(twp.decode_mix_plain(means, steps, wb=wb, wire_dtype=wd)),
        bits(old_chain(means, layout, payloads, wb, wd)))


def test_the_grid_covers_every_offset_mode_and_plan_kind():
    seen = set()
    for wd in ALL:
        for case in CASES.values():
            _, layout, _, steps, wb = gossip(case, wd)
            for key, _, _ in layout.plans:
                seen.add("dense" if key[0] == "dense"
                         else wf.offset_mode(wb, key[1], wd))
                if key[0] == "wire":
                    seen.add(("k_b", "1" if key[1] == 1 else
                              "wb" if key[1] == wb else "mid"))
            if len(steps) > twp.MIX_STEPS:
                seen.add("split")
    assert seen >= {"dense", "i32", "i16", "u8", "p4", ("k_b", "1"),
                    ("k_b", "wb"), ("k_b", "mid"), "split"}, seen


@pytest.mark.parametrize("wd", ("int8", "int4"))
@pytest.mark.parametrize("name", ("complete4", "erdos8_u8"))
def test_more_steps_than_a_launch_split_over_calls(name, wd):
    """The kernel takes MIX_STEPS steps a launch and runs the rest over
    the first launch's result; so does the plain version, call by call."""
    means, layout, _, steps, wb = gossip(CASES[name], wd, seed=1)
    assert len(steps) > twp.MIX_STEPS
    whole = twp.decode_mix_plain(means, steps, wb=wb, wire_dtype=wd,
                                 diag=layout.diag)
    y = twp.decode_mix_plain(means, steps[:twp.MIX_STEPS], wb=wb,
                             wire_dtype=wd, diag=layout.diag)
    for s0 in range(twp.MIX_STEPS, len(steps), twp.MIX_STEPS):
        y = twp.decode_mix_plain(y, steps[s0:s0 + twp.MIX_STEPS], wb=wb,
                                 wire_dtype=wd)
    assert torch.equal(bits(y), bits(whole))


def test_zero_payload_turns_minus_zero_into_plus_zero():
    """A zero payload still adds coef * (+0) to every entry, as the dense
    add does: a -0 in y leaves as +0."""
    means, layout, _, steps, wb = gossip(CASES["ring2"], "int4")
    y = torch.full_like(means, -0.0)
    got = twp.decode_mix_plain(y, steps, wb=wb, wire_dtype="int4")
    assert not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("L,wbk,rows", [(2500, 1024, (0, 2)),
                                        (2500, 1024, None),
                                        (20, 1024, (1,)),
                                        (31, 1024, (0, 1, 2)),
                                        (4096, 1000, (2, 0))])
def test_encode_rows_plain_is_select_pad_encode(L, wbk, rows, wd):
    wb = wf.wire_block_of(L, wbk)
    x = cluster_means(2, 3, L)
    for k_b in sorted({1, max(1, wb // 10), wb}):
        sub = x if rows is None else x.index_select(
            0, torch.as_tensor(rows, dtype=torch.long))
        xb = F.pad(sub, (0, (-L) % wb)).reshape(sub.shape[0], -1, wb)
        want = twp.encode_blocks_plain(xb, k_b, wire_dtype=wd)
        got = twp.encode_rows_plain(x, rows, k_b, wb=wb, wire_dtype=wd)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for g, w in zip(ops.encode_rows(x, rows, k_b, wb=wb, wire_dtype=wd),
                        want):
            assert torch.equal(g, w)
        for g, w in zip(ops.encode_rows(x, rows, k_b, wb=wb, wire_dtype=wd,
                                        impl="ref"),
                        ref.encode_blocks_topk(xb, k_b, wire_dtype=wd)):
            assert torch.equal(g, w)


def test_encode_routes_by_shape():
    assert [twp.encode_route(wb) for wb in (1, 31, 33, 1000, 1024, 1025,
                                            2048)] == \
        ["warp"] * 5 + ["block"] * 2


def conn_masks(C):
    """Each cluster's link cut alone, and every link but cluster 0's."""
    return [1 - np.eye(C)[c] for c in range(C)] + [np.eye(C)[0]]


def masked_chain(means, layout, payloads, wb, wd, conn):
    """The reference's masked band loop (``_sparse_mix_rows``,
    collectives.py:1241-1282) in torch: coef * (c_o * dec) with c_o the
    band's source link, the lost weight added to the receiver's own mean
    where it lost any, a partitioned receiver's own mean."""
    C, L = means.shape
    col = lambda v: torch.as_tensor(np.asarray(v, np.float32))[:, None]
    cw = np.asarray(conn, np.float32)
    y = col(layout.diag) * means
    absorbed = np.zeros(C, np.float32)
    for o, coef in layout.bands:
        c_o = cw[(np.arange(C) - o) % C]
        for payload, k_b, rows in payloads:
            dec = old_chain(torch.zeros_like(means), layout._replace(
                bands=((o, (1.0,) * C),)), [(payload, k_b, rows)], wb, wd)
            y = y + col(coef) * (col(c_o) * dec)
        absorbed = absorbed + np.asarray(coef, np.float32) * (1 - c_o)
    ab = col(absorbed)
    y = torch.where(ab > 0, y + ab * means, y)
    return torch.where(col(cw) > 0, y, means)


def nan_payloads(payloads):
    """A NaN in the first payload row of every plan: in the values of the
    float wires and dense plans, in the scale of the others."""
    out = []
    for payload, k_b, rows in payloads:
        payload = tuple(None if p is None else p.clone() for p in payload)
        if len(payload) == 3 and payload[2] is not None:
            payload[2][0, 0] = float("nan")
        elif payload[0].is_floating_point():
            payload[0].view(-1)[0] = float("nan")
        out.append((payload, k_b, rows))
    return out


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("name", sorted(CASES))
def test_conn_folded_coefficients_are_the_masked_chain(name, wd):
    """conn folded into the decode-and-mix's coefficients, (coef * c) *
    dec, and the two passes after it are bit for bit the reference's
    order, coef * (c * dec), for c in {0, 1}: -0 entries, NaN payloads
    and partitioned senders with NaN in their rows included."""
    means, layout, payloads, _, wb = gossip(CASES[name], wd, seed=2)
    C = means.shape[0]
    for nan in (False, True):
        pl = nan_payloads(payloads) if nan else payloads
        for conn in conn_masks(C):
            bands, absorbed = tcol._conn_fold(layout, conn)
            steps = [twp.MixStep(o, coef, p, k_b, senders)
                     for o, coef in bands
                     for (p, k_b, _), (_, _, senders) in zip(pl,
                                                             layout.plans)]
            y = twp.decode_mix_plain(means, steps, wb=wb, wire_dtype=wd,
                                     diag=layout.diag)
            ab = torch.as_tensor(absorbed)[:, None]
            got = torch.where(ab > 0, y + ab * means, y)
            got = torch.where(torch.as_tensor(conn > 0)[:, None], got,
                              means)
            want = masked_chain(means, layout, pl, wb, wd, conn)
            assert torch.equal(bits(got), bits(want)), (conn, nan)
            if nan:
                assert torch.isnan(want).any()


@pytest.mark.parametrize("wd", ("int4", "f32"))
def test_masked_sparse_mix_rows_is_the_masked_chain(wd):
    """``_sparse_mix_rows(..., conn=)`` end to end on its own encode:
    the partitioned rows keep their means, the rest the masked chain."""
    means, layout, payloads, _, wb = gossip(CASES["ring4_dense"], wd,
                                            seed=3)
    for conn in conn_masks(4):
        got = tcol._sparse_mix_rows(means, layout, wb=wb, wire_dtype=wd,
                                    dense_dtype=torch.float32, conn=conn)
        want = masked_chain(means, layout, payloads, wb, wd, conn)
        assert torch.equal(bits(got), bits(want))
        cut = np.flatnonzero(conn == 0)
        assert torch.equal(bits(got[cut]), bits(means[cut]))
    with pytest.raises(ValueError, match="wire_ef"):
        tcol._sparse_mix_rows(means, layout, wb=wb, wire_dtype=wd,
                              dense_dtype=torch.float32, conn=conn,
                              wire_ef=(means, means))
