"""The wire EF's own decode inside the decode-and-mix, on the CPU.

``dist.collectives._sparse_mix_rows`` with ``wire_ef`` advances the CHOCO
estimates with two ``ops.wire_decode_mix`` calls (a step at band offset 0
for each plan, coefficient 1 for est_self, diag for est_wsum before the
bands' steps).  Here it is held bit for bit (``torch.equal`` on int32
views, so -0 and +0 differ) to the chain it replaced, written out below:
each plan's payload decoded on its own (``_decode``), summed from +0 with
``index_add_``, est_self + dec_self, est_wsum + diag * dec_self and then
the decode-and-mix of the bands.  The grid is
``test_torch_wire_decode.py``'s (partial senders, a dense plan, u8
offsets, more steps than a launch on erdos8_u8) in every wire dtype, a
backhaul of more clusters than a launch covers, one-plan chunks, and
estimates holding -0 where a payload decodes to -0.  Plain torch only.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import wire_format as wf
from repro_torch.dist import collectives as tcol
from repro_torch.kernels import ops
from repro_torch.kernels import wire_pack as twp
from test_torch_wire_decode import ALL, CASES, bits, cluster_means

CASES = dict(CASES, **{
    # more clusters than a decode-and-mix launch covers (MIX_ROWS)
    "ring33": ("ring", 33, 256, 600,
               tuple((0.05, 0.3, 1.0)[c % 3] for c in range(33)),
               torch.bfloat16),
    # one plan: the zero payload's step stands in for the other plans
    "ring4_one_wire": ("ring", 4, 1024, 2600, (0.3,) * 4, torch.bfloat16),
    "ring2_one_dense": ("ring", 2, 1024, 3000, (1.0, 1.0), torch.float32),
})
GAMMA = 0.75


def estimates(seed, means):
    """(est_self, est_wsum), (C, L) f32: est_self +0 where the means are
    -0 (so the payload, means - est_self, is -0 there), est_wsum -0
    there; both -0 at some other entries."""
    rng = np.random.default_rng(seed)
    es = torch.from_numpy(rng.standard_normal(means.shape).astype(
        np.float32)) * 0.5
    ew = torch.from_numpy(rng.standard_normal(means.shape).astype(
        np.float32))
    neg0 = (means == 0) & torch.signbit(means)
    es[neg0] = 0.0
    ew[neg0] = -0.0
    es[:, 1::9] = -0.0
    ew[:, 2::9] = -0.0
    return es, ew


def setup(case, wd, seed=0):
    hkind, C, wbk, L, levels, dense = case
    wb = wf.wire_block_of(L, wbk)
    plans = tcol._wire_plans(levels, L, wbk, wd,
                             torch.empty((), dtype=dense).element_size())
    layout = tcol._gossip_layout(hkind, C, 0.4, 0, tuple(plans))
    means = cluster_means(seed, C, L)
    return means, estimates(seed + 1, means), layout, wb, dense


def old_chain(means, wire_ef, layout, wb, wd, dense):
    """The wire EF as ``_sparse_mix_rows`` ran it before: the payloads of
    means - est_self, each plan decoded on its own into dec_self (from
    +0), then the estimates and y.  Returns (y, est_self+, est_wsum+,
    dec_self)."""
    C, L = means.shape
    send = means - wire_ef[0]
    payloads = []
    for key, rows, _ in layout.plans:
        if key[0] == "dense":
            sub = send if rows is None else send[list(rows)]
            payloads.append(((sub.to(dense).contiguous(),), None, rows))
        else:
            payloads.append((tuple(tcol._encode(send, rows, key[1], wb,
                                                wd)), key[1], rows))
    dec_self = torch.zeros_like(means)
    for payload, k_b, rows in payloads:
        d = tcol._decode(payload, L, wb, wd, k_b)
        if rows is None:
            dec_self = dec_self + d
        else:
            dec_self.index_add_(0, torch.as_tensor(rows), d)
    est_self = wire_ef[0] + dec_self
    diag = torch.as_tensor(tuple(layout.diag.tolist()),
                           dtype=torch.float32)
    steps = [twp.MixStep(o, tuple(coef), p, k_b, senders)
             for o, coef in layout.bands
             for (p, k_b, _), (_, _, senders) in zip(payloads, layout.plans)]
    y = twp.decode_mix_plain(wire_ef[1] + diag[:, None] * dec_self, steps,
                             wb=wb, wire_dtype=wd)
    return means + GAMMA * (y - est_self), est_self, y, dec_self


def fused(means, wire_ef, layout, wb, wd, dense):
    return tcol._sparse_mix_rows(means, layout, wb=wb, wire_dtype=wd,
                                 dense_dtype=dense, wire_ef=wire_ef,
                                 wire_ef_gamma=GAMMA)


@pytest.mark.parametrize("wd", ALL)
@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_wire_ef_is_the_old_chain(name, wd, monkeypatch):
    means, ef, layout, wb, dense = setup(CASES[name], wd)
    want = old_chain(means, ef, layout, wb, wd, dense)
    calls = []
    wire_decode_mix = ops.wire_decode_mix

    def mix(*a, **kw):
        calls.append(len(a[1]))
        return wire_decode_mix(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the fused wire EF decoded a payload alone")

    monkeypatch.setattr(tcol.ops, "wire_decode_mix", mix)
    monkeypatch.setattr(tcol, "_decode", refuse)
    monkeypatch.setattr(tcol.ops, "unpack_offsets", refuse)
    got = fused(means, ef, layout, wb, wd, dense)
    for g, w in zip(got, want[:3]):
        assert torch.equal(bits(g), bits(w))
    # two calls: est_self's own steps; est_wsum's own and the bands'
    P = len(layout.plans)
    own = P + (P == 1)
    assert calls == [own, own + len(layout.bands) * P]
    # the inputs are read, not written
    assert torch.equal(bits(ef[0]), bits(setup(CASES[name], wd)[1][0]))


def test_grid_has_what_it_claims():
    seen = set()
    for name, case in CASES.items():
        for wd in ALL:
            means, ef, layout, wb, dense = setup(case, wd)
            P = len(layout.plans)
            seen.add(("plans", min(P, 2)))
            if case[1] > twp.MIX_ROWS:
                seen.add("rows")
            if P * (1 + len(layout.bands)) > twp.MIX_STEPS:
                seen.add("split")
            for key, _, _ in layout.plans:
                seen.add("dense" if key[0] == "dense"
                         else wf.offset_mode(wb, key[1], wd))
            *_, d = old_chain(means, ef, layout, wb, wd, dense)
            # est_wsum holds -0 where the own payload decodes to -0
            if ((ef[1] == 0) & torch.signbit(ef[1]) & (d == 0)).any():
                seen.add("-0")
    assert seen >= {("plans", 1), ("plans", 2), "rows", "split", "dense",
                    "u8", "p4", "i32", "i16", "-0"}, seen


@pytest.mark.parametrize("wd", ("f32", "bf16"))
def test_one_plan_needs_its_zero_step(wd):
    """With one plan no other plan's rows add +0: without the zero
    payload's step a -0 in est_wsum plus diag times a -0 decode would stay
    -0, where the old chain's sum from +0 gives +0."""
    means, ef, layout, wb, dense = setup(CASES["ring2_one_dense"], wd)
    assert len(layout.plans) == 1 and layout.plans[0][0] == ("dense",)
    payload = ((means - ef[0]).to(dense).contiguous(),)
    own = [twp.MixStep(0, tuple(layout.diag.tolist()), payload, None,
                       layout.plans[0][2])]
    diag = torch.as_tensor(tuple(layout.diag.tolist()), dtype=torch.float32)
    old = ef[1] + diag[:, None] * (torch.zeros_like(means) +
                                   payload[0].float())
    with_zero = twp.decode_mix_plain(
        ef[1], own + [own[0]._replace(senders=(-1, -1))], wb=wb,
        wire_dtype=wd)
    assert torch.equal(bits(with_zero), bits(old))
    bare = twp.decode_mix_plain(ef[1], own, wb=wb, wire_dtype=wd)
    assert not torch.equal(bits(bare), bits(old))
