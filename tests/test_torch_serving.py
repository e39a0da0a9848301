"""The port's serving path: its copies of the page manager and scheduler
pass the reference's scenarios, and its continuous-batching engine emits
the JAX engine's greedy tokens for the same requests and weights."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_model
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm
from repro_torch.serving.engine import Engine, PagedConfig, ServeConfig
from repro_torch.serving.page_manager import (NULL_PAGE, PageError,
                                              PageManager, pages_for)
from repro_torch.serving.scheduler import Request, Scheduler


@pytest.fixture(scope="module")
def smol():
    cfg = smoke_model(get_config("smollm_135m").model)
    return cfg, lm.init(cfg, seed=0, device="cpu")


def _engine(cfg, params, *, batch=4, temperature=0.0, eos=-1, page_size=8,
            seed=0, num_pages=0):
    return Engine(cfg, params, device="cpu",
                  serve=ServeConfig(temperature=temperature, eos_id=eos,
                                    seed=seed),
                  paged=PagedConfig(page_size=page_size, max_slots=batch,
                                    num_pages=num_pages))


def _reqs(vocab, spec, seed=0, cls=Request):
    """spec: [(rid, prompt_len, max_new), ...] -> deterministic requests."""
    out = []
    for rid, plen, mnt in spec:
        rng = np.random.default_rng(seed + rid)  # prompt depends on rid only
        out.append(cls(rid=rid, prompt=rng.integers(0, vocab, plen)
                       .astype(np.int32), max_new_tokens=mnt))
    return out


# ---------------------------------------------------------------------------
# page manager (the scenarios of tests/test_serving.py::TestPageManager)
# ---------------------------------------------------------------------------

class TestPageManager:
    def test_alloc_release_no_leaks(self):
        pm = PageManager(num_pages=9, page_size=8)
        a = pm.alloc(1, 20)           # 3 pages
        b = pm.alloc(2, 8)            # 1 page
        assert len(a) == 3 and len(b) == 1
        assert NULL_PAGE not in a + b
        assert pm.free_pages == 8 - 4
        pm.check_invariants()
        pm.release(1)
        pm.release(2)
        assert pm.free_pages == 8 and pm.live_requests == 0
        pm.check_invariants()

    def test_oom_is_all_or_nothing(self):
        pm = PageManager(num_pages=5, page_size=8)  # 4 allocatable
        pm.alloc(1, 24)               # 3 pages
        free_before = pm.free_pages
        with pytest.raises(PageError):
            pm.alloc(2, 16)           # needs 2, only 1 free
        assert pm.free_pages == free_before
        assert pm.live_requests == 1
        pm.check_invariants()

    def test_extend_all_or_nothing(self):
        pm = PageManager(num_pages=5, page_size=8)
        pm.alloc(1, 8)
        assert pm.extend(1, 8) == []
        assert len(pm.extend(1, 17)) == 2
        with pytest.raises(PageError):
            pm.extend(1, 100)
        assert len(pm.pages_of(1)) == 3
        pm.check_invariants()

    def test_table_row_null_padded(self):
        pm = PageManager(num_pages=9, page_size=8)
        pm.alloc(7, 10)
        row = pm.table_row(7, 5)
        assert row.dtype == np.int32 and row.shape == (5,)
        assert list(row[2:]) == [NULL_PAGE] * 3
        assert list(row[:2]) == pm.pages_of(7)
        with pytest.raises(ValueError):
            pm.table_row(7, 1)

    def test_null_page_reserved(self):
        pm = PageManager(num_pages=9, page_size=8)
        got = [p for r in range(4) for p in pm.alloc(r, 16)]
        assert NULL_PAGE not in got and sorted(got) == list(range(1, 9))
        with pytest.raises(ValueError):
            PageManager(num_pages=1, page_size=8)

    def test_pages_for(self):
        assert pages_for(1, 8) == 1
        assert pages_for(8, 8) == 1
        assert pages_for(9, 8) == 2
        assert pages_for(0, 8) == 1


# ---------------------------------------------------------------------------
# scheduler (the scenarios of tests/test_serving.py::TestScheduler)
# ---------------------------------------------------------------------------

class TestScheduler:
    def _sched(self, *, slots=2, num_pages=9, ps=8, width=4):
        pm = PageManager(num_pages, ps)
        return Scheduler(max_slots=slots, page_manager=pm, table_width=width,
                         clock=lambda: 0.0), pm

    def test_admit_full_reservation_fifo(self):
        sched, pm = self._sched(slots=2, num_pages=9)
        sched.submit(Request(rid=0, prompt=np.zeros(24, np.int32),
                             max_new_tokens=8))
        sched.submit(Request(rid=1, prompt=np.zeros(24, np.int32),
                             max_new_tokens=8))
        sched.submit(Request(rid=2, prompt=np.zeros(4, np.int32),
                             max_new_tokens=2))
        assert sched.admit(0.0) == [0, 1]
        assert pm.free_pages == 0
        assert sched.admit(0.0) == []
        for _ in range(8):
            live = sched.record_token(0, 5, -1, now=0.0)
        assert not live and sched.finished[0].finish_reason == "length"
        assert sched.admit(0.0) == [0]
        assert sched.slots[0].request.rid == 2

    def test_eos_retires_and_releases(self):
        sched, pm = self._sched()
        sched.submit(Request(rid=3, prompt=np.zeros(8, np.int32),
                             max_new_tokens=8))
        sched.admit(0.0)
        assert sched.record_token(0, 41, eos_id=99, now=0.0)
        assert not sched.record_token(0, 99, eos_id=99, now=0.0)
        out = sched.finished[3]
        assert out.finish_reason == "eos" and out.tokens == [41, 99]
        assert pm.live_requests == 0
        pm.check_invariants()

    def test_table_and_kv_lens_mask_empty_slots(self):
        sched, pm = self._sched(slots=3)
        sched.submit(Request(rid=0, prompt=np.zeros(10, np.int32),
                             max_new_tokens=4))
        sched.admit(0.0)
        t, kl = sched.table(), sched.kv_lens()
        assert t.shape == (3, 4) and kl.tolist() == [10, 0, 0]
        assert (t[1:] == NULL_PAGE).all()

    def test_arrival_gating(self):
        sched, _ = self._sched()
        sched.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                             max_new_tokens=2, arrival=5.0))
        assert sched.admit(1.0) == []
        assert sched.admit(5.0) == [0]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

# Greedy parity needs every emitted token to be decided by a clear margin:
# the two packages' logits differ by up to 1e-4 (tests/test_torch_lm.py),
# so a top-1/top-2 gap above this keeps equal ids from being luck.
MARGIN = 1e-3
PARITY_SPEC = [(0, 8, 6), (1, 13, 5), (2, 5, 7), (3, 16, 4), (4, 3, 6)]


def test_greedy_serve_matches_jax_serve():
    """Held to the reference's ``Engine.serve`` as it runs, including its
    decode-position offset (ROADMAP.md §3): the scheduler counts the token
    a decode step is fed as already cached, so decode ropes it one position
    late and attends the stale slot before it.  ``Engine.generate`` and a
    teacher-forced ``forward`` give other tokens; the port copies the
    scheduler and so gives the reference's."""
    _serve_parity("smollm_135m")


def test_greedy_moe_serve_matches_jax_serve():
    """The same on the smoke granite-moe-1b-a400m: each prefill (B = 1,
    padded to the page size) routes its pad positions too, after the real
    tokens of each expert, and each decode step routes every slot alone."""
    _serve_parity("granite_moe_1b_a400m")


def _serve_parity(arch):
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.configs import smoke_model as j_smoke
    from repro.models import lm as jlm
    from repro.serving.engine import Engine as JEngine
    from repro.serving.engine import PagedConfig as JPaged
    from repro.serving.engine import ServeConfig as JServe
    from repro.serving.scheduler import Request as JRequest
    from repro_torch.convert import params_from_jax

    jcfg = j_smoke(j_get_config(arch).model)
    # weights at std 0.2 (not init's 0.02), so greedy decoding does not
    # collapse into repeating one token per request
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "ln" in str(path) or "norm" in str(path)
        else a * 10.0, jlm.init(jcfg, jax.random.PRNGKey(3)))
    cfg = smoke_model(get_config(arch).model)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")

    emitted = []  # the reference's logits of every row that emits a token

    class Spy:
        """The reference's model module, reporting the logits of each call
        its serve makes from inside the jitted programs."""
        init_paged_cache = staticmethod(jlm.init_paged_cache)

        @staticmethod
        def prefill_paged(*a, **kw):
            logits, cache = jlm.prefill_paged(*a, **kw)
            jax.debug.callback(
                lambda lg: emitted.extend(np.asarray(lg)[:, 0]), logits)
            return logits, cache

        @staticmethod
        def decode_step_paged(cfg_, p, cache, tokens, table, kv_len, *a,
                              **kw):
            logits, cache = jlm.decode_step_paged(cfg_, p, cache, tokens,
                                                  table, kv_len, *a, **kw)
            jax.debug.callback(  # live slots are the rows with kv_len > 0
                lambda lg, kl: emitted.extend(
                    np.asarray(lg)[np.asarray(kl) > 0, 0]), logits, kv_len)
            return logits, cache

    jeng = JEngine(jcfg, jparams, max_len=32, batch_size=2,
                   serve=JServe(max_new_tokens=8),
                   paged=JPaged(page_size=8, max_slots=2))
    jeng.model = Spy
    theirs = jeng.serve(_reqs(jcfg.vocab_size, PARITY_SPEC, cls=JRequest))
    jax.effects_barrier()
    ours = _engine(cfg, params, batch=2).serve(
        _reqs(cfg.vocab_size, PARITY_SPEC))

    assert len(emitted) == sum(len(o.tokens) for o in theirs.values())
    top2 = np.sort(np.stack(emitted), axis=-1)[:, -2:]
    margins = top2[:, 1] - top2[:, 0]
    assert (margins > MARGIN).all(), f"near-tie: margins {np.sort(margins)}"
    assert sorted(ours) == sorted(theirs) == [r for r, _, _ in PARITY_SPEC]
    assert len({t for o in theirs.values() for t in o.tokens}) > 15
    for rid in theirs:
        assert ours[rid].tokens == theirs[rid].tokens, rid
        assert ours[rid].finish_reason == theirs[rid].finish_reason


def test_per_request_budgets_and_slot_refill(smol):
    cfg, params = smol
    spec = [(i, 4 + 4 * (i % 2), 2 + 3 * (i % 3)) for i in range(5)]
    outs = _engine(cfg, params, batch=2).serve(_reqs(cfg.vocab_size, spec))
    assert sorted(outs) == [0, 1, 2, 3, 4]
    for rid, _, mnt in spec:
        assert len(outs[rid].tokens) == mnt
        assert outs[rid].t_first_token >= outs[rid].t_arrival


def test_sampling_deterministic_and_independent_of_batch(smol):
    cfg, params = smol
    spec_alone = [(7, 8, 5)]
    spec_crowd = [(i, 8, 5) for i in range(6)] + spec_alone
    eng = _engine(cfg, params, batch=4, temperature=0.7)
    alone = eng.serve(_reqs(cfg.vocab_size, spec_alone))[7].tokens
    crowd = eng.serve(_reqs(cfg.vocab_size, spec_crowd))[7].tokens
    again = _engine(cfg, params, batch=2, temperature=0.7).serve(
        _reqs(cfg.vocab_size, spec_crowd))[7].tokens
    assert alone == crowd == again  # keyed by (seed, rid, token_idx)
    greedy = _engine(cfg, params, batch=4).serve(
        _reqs(cfg.vocab_size, spec_alone))[7].tokens
    other_seed = _engine(cfg, params, batch=4, temperature=0.7,
                         seed=1).serve(_reqs(cfg.vocab_size, spec_alone))
    assert alone != greedy
    assert alone != other_seed[7].tokens  # the seed reaches the draws


def test_serve_eos_stops_early(smol):
    cfg, params = smol
    free = _engine(cfg, params, batch=2).serve(
        _reqs(cfg.vocab_size, [(0, 8, 8)]))[0].tokens
    eos = free[2]
    out = _engine(cfg, params, batch=2, eos=eos).serve(
        _reqs(cfg.vocab_size, [(0, 8, 8)]))[0]
    assert out.finish_reason == "eos"
    stop = free.index(eos)  # stops at the FIRST occurrence of EOS
    assert out.tokens == free[:stop + 1]


def test_request_too_big_for_pool_raises(smol):
    cfg, params = smol
    eng = _engine(cfg, params, batch=2, num_pages=3)  # 2 allocatable pages
    with pytest.raises(ValueError):
        eng.serve(_reqs(cfg.vocab_size, [(0, 24, 8)]))  # needs 4 pages


def test_engine_needs_the_card_unless_cpu_is_asked(smol):
    cfg, params = smol
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Engine(cfg, params)
    with pytest.raises(RuntimeError):
        lm.init(cfg, seed=0)


def test_launcher_serves_on_cpu(capsys):
    launch_serve.main(["--continuous", "--device", "cpu", "--arch",
                       "smollm_135m", "--requests", "3", "--rate", "1000"])
    out = capsys.readouterr().out
    assert "continuous: 3 requests" in out and "on cpu" in out
    launch_serve.main(["--device", "cpu"])  # the static path: generate
    assert "generated 64 tokens" in capsys.readouterr().out
