"""Serving engine (port of ``repro/serving/engine.py``; DESIGN.md §Serving
contract).  Two paths:

  * ``Engine.serve(requests)``, continuous batching over a paged KV pool.
    A ``Scheduler`` admits requests from a queue into a fixed set of
    decode slots (per-decode-step admit/retire: a finished request's
    pages are released and its slot refilled by a waiting prefill the
    same step).  Each admitted request is prefilled alone (B=1, padded to
    the page size); then one batched decode step runs over all slots,
    empty ones included.  ``PagedConfig.kv_dtype="int8"`` stores the pool
    block-quantized.  ``PagedConfig.contiguous`` is refused
    (``CONTIGUOUS_NOT_SERVED``).  The paged families only
    (``PAGED_FAMILIES``), and no frontend: the reference's serve feeds
    tokens alone to prefill.
  * ``Engine.generate(prompts)``, the static batch (a dense cache, one
    shared ``pos``) of every family: ``lm`` (dense, moe, the ViT stub and
    the encoder-decoder, whose stand-ins come in ``extra_inputs``),
    ``mamba2`` and ``griffin``.  Partial batches are padded with copies
    of the last row; larger ones are served in chunks of ``batch_size``;
    rows that hit EOS emit ``pad_id`` while the rest of the batch drains.

On the card each paged decode step replays every layer's work but the
pool's read and write as two CUDA graphs (``lm.DecodeGraphs``, captured
in the first decode step); the attention kernels run, and are counted,
as launched.  The static decode
step is eager.

Sampling: greedy is argmax, as in the reference.  A temperature draw of
``serve`` comes from a ``torch.Generator`` seeded with (seed, rid, t), so
outputs do not depend on batch composition or admission order; one of
``generate`` from a generator seeded with (seed, step) for the batch.
Neither is the reference's bits (``jax.random`` keys cannot be
reproduced).  ``eos_id=-1`` never stops early.

Held to the reference's ``serve`` as it runs, this keeps its decode
positions: the scheduler counts a sampled token in ``kv_len`` before the
decode step that is fed it has written it, so that step ropes and writes
it one position late and attends the slot before it (ROADMAP.md §3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.models.common import layer_list
from repro_torch.models.registry import get_model
from repro_torch.serving.page_manager import PageManager, pages_for
from repro_torch.serving.scheduler import Request, RequestOutput, Scheduler

PAGED_FAMILIES = ("dense", "moe")  # families with a self-attention KV cache
FRONTEND_NOT_PAGED = (
    "Engine.serve feeds tokens alone to prefill_paged, as the reference's "
    "serve does (engine.py:194-196), so a frontend's stand-ins have no "
    "way in; serve it through Engine.generate")
CONTIGUOUS_NOT_SERVED = (
    "PagedConfig.contiguous makes decode_step_paged read slot b's pages as "
    "[1 + b P, 1 + (b + 1) P), but the page manager hands out pages in "
    "free-list order, so the serve would attend other requests' K/V "
    "(ROADMAP.md §3); the contiguous layout is decode_step_paged's "
    "contiguous=True over an identity page table")


@dataclass
class ServeConfig:
    max_new_tokens: int = 32  # generate's tokens a row
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => explicit "never stops early" sentinel
    pad_id: int = 0   # padding, and generate's token of finished rows
    seed: int = 0


@dataclass
class PagedConfig:
    """Continuous-batching knobs. ``num_pages=0`` sizes the pool to the
    full worst case (max_slots concurrent requests at their whole
    prompt+max_new budget) + the null page; smaller pools make admission
    wait for pages instead."""
    page_size: int = 16
    num_pages: int = 0
    max_slots: int = 8
    kv_dtype: Optional[str] = None  # None => compute dtype; "int8" quantized
    # the reference's static identity page layout; serve refuses it
    # (CONTIGUOUS_NOT_SERVED)
    contiguous: bool = False


def _align(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def _row_seed(seed: int, rid: int, tok_idx: int) -> int:
    """Seed of the generator that draws token ``tok_idx`` of ``rid``."""
    ss = np.random.SeedSequence([int(seed), int(rid), int(tok_idx)])
    return int(ss.generate_state(1, np.uint64)[0])


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, max_len: int = None,
                 batch_size: int = None, serve: ServeConfig = None,
                 paged: PagedConfig = None, device=None):
        """``max_len`` (cache positions) and ``batch_size`` size
        ``generate``'s static cache; ``serve`` needs neither."""
        self.cfg = cfg
        self.model = get_model(cfg)
        self.serve_cfg = serve or ServeConfig()
        self.paged = paged or PagedConfig()
        self.max_len = max_len
        self.batch_size = batch_size
        self.device = resolve(device)
        emb = params["emb"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine device "
                             f"is {self.device}")
        # lm's layer views taken once, not in every decode step (mamba2's
        # and griffin's stacks are not lm's layout)
        self.params = (dict(params, layers=layer_list(params))
                       if self.model is lm else params)
        # on the card the paged decode step replays each layer's work
        # around the pool as CUDA graphs (the paged families' model, lm)
        self._graphs = (self.model.DecodeGraphs()
                        if self.device.type == "cuda"
                        and cfg.family in PAGED_FAMILIES else None)

    def _tensor(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=self.device)

    def _sample_rows(self, logits, rids, tok_idx) -> np.ndarray:
        """logits (B, 1, V) -> tokens (B,) int32, per-request deterministic."""
        lg = logits[:, -1, :]
        sc = self.serve_cfg
        if sc.temperature <= 0:
            return torch.argmax(lg, dim=-1).to(torch.int32).cpu().numpy()
        out = np.empty(lg.shape[0], np.int32)
        for i, (rid, t) in enumerate(zip(rids, tok_idx)):
            gen = torch.Generator(device=lg.device)
            gen.manual_seed(_row_seed(sc.seed, rid, t))
            probs = torch.softmax(lg[i].float() / sc.temperature, dim=-1)
            out[i] = int(torch.multinomial(probs, 1, generator=gen)[0])
        return out

    def _sample(self, logits, step) -> np.ndarray:
        """logits (B, 1, V) -> generate's tokens (B,) int64: argmax, or at
        a temperature one draw a row from a generator seeded with (seed,
        step)."""
        lg = logits[:, -1, :]
        sc = self.serve_cfg
        if sc.temperature <= 0:
            return torch.argmax(lg, dim=-1).cpu().numpy()
        gen = torch.Generator(device=lg.device)
        ss = np.random.SeedSequence([int(sc.seed), int(step)])
        gen.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
        probs = torch.softmax(lg.float() / sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].cpu().numpy()

    # ------------------------------------------------------------------
    # static-batch path
    # ------------------------------------------------------------------

    def generate(self, prompts: np.ndarray,
                 extra_inputs: Optional[dict] = None) -> np.ndarray:
        """prompts: (B, S_prompt) int, any B >= 1; ``extra_inputs``: the
        frontend's arrays by batch key (``patch_embeds``, ``frames``), B
        rows each.  Returns (B, max_new_tokens) int64; rows finish at EOS
        and hold ``pad_id`` afterwards.  B < batch_size is padded with
        copies of the last row; B > batch_size is served in consecutive
        chunks."""
        if self.batch_size is None or self.max_len is None:
            raise ValueError("generate needs Engine(..., batch_size=, "
                             "max_len=)")
        B = prompts.shape[0]
        bs = self.batch_size
        if B > bs:
            return np.concatenate([self.generate(
                prompts[i:i + bs], None if extra_inputs is None else
                {k: v[i:i + bs] for k, v in extra_inputs.items()})
                for i in range(0, B, bs)], axis=0)
        pad_rows = bs - B
        if pad_rows:
            fill = lambda a: np.concatenate(  # noqa: E731
                [a, np.repeat(a[-1:], pad_rows, axis=0)], axis=0)
            prompts = fill(prompts)
            if extra_inputs:
                extra_inputs = {k: fill(v) for k, v in extra_inputs.items()}
        return self._generate_full(prompts, extra_inputs)[:B]

    @torch.inference_mode()
    def _generate_full(self, prompts, extra_inputs):
        cfg, sc = self.cfg, self.serve_cfg
        B, S = prompts.shape
        if B != self.batch_size:
            raise ValueError(f"{B} rows for a batch of {self.batch_size}")
        batch = {"tokens": self._tensor(prompts, torch.int64)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = self._tensor(v, torch.float32)
        enc_len = batch["frames"].shape[1] if cfg.enc_layers else 0
        cache = self.model.init_cache(cfg, B, self.max_len, enc_len=enc_len,
                                      device=self.device)
        logits, cache = self.model.prefill(cfg, self.params, batch, cache)
        out = []
        done = np.zeros(B, bool)
        pad = np.full(B, sc.pad_id, np.int64)
        tok = self._sample(logits, 0)
        for step in range(1, sc.max_new_tokens + 1):
            out.append(np.where(done, pad, tok))  # done rows emit pad only
            # eos_id=-1 sentinel: no token id is negative => never done
            done |= (sc.eos_id >= 0) & (tok == sc.eos_id)
            if done.all() or step == sc.max_new_tokens:
                break
            logits, cache = self.model.decode_step(
                cfg, self.params, cache,
                self._tensor(tok[:, None], torch.int64))
            tok = self._sample(logits, step)
        res = np.stack(out, axis=1)
        if res.shape[1] < sc.max_new_tokens:  # early exit: pad to contract
            res = np.concatenate([res, np.full(
                (B, sc.max_new_tokens - res.shape[1]), sc.pad_id,
                res.dtype)], axis=1)
        return res

    # ------------------------------------------------------------------
    # continuous-batching path
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def serve(self, requests: Sequence[Request],
              clock=time.perf_counter) -> Dict[int, RequestOutput]:
        """Continuous batching: admit/retire per decode step.

        ``requests`` carry per-request prompts (any lengths), per-request
        ``max_new_tokens`` and arrival times (seconds, relative to the
        call).  Returns {rid: RequestOutput} with tokens + TTFT/TPOT
        timestamps against the same clock.
        """
        cfg, pc, sc = self.cfg, self.paged, self.serve_cfg
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        if not reqs:
            return {}
        if cfg.family not in PAGED_FAMILIES:
            raise ValueError(
                f"continuous batching needs a KV-cache family "
                f"{PAGED_FAMILIES}, got {cfg.family!r}")
        if cfg.frontend:
            raise ValueError(f"{cfg.name}: {FRONTEND_NOT_PAGED}")
        if pc.contiguous:
            raise ValueError(CONTIGUOUS_NOT_SERVED)
        S_pad = _align(max(len(r.prompt) for r in reqs), pc.page_size)
        budget = S_pad + max(r.max_new_tokens for r in reqs)
        width = pages_for(budget, pc.page_size)
        num_pages = pc.num_pages or 1 + pc.max_slots * width
        if width > num_pages - 1:
            raise ValueError(
                f"a request's worst-case footprint ({width} pages) exceeds "
                f"the pool ({num_pages - 1} allocatable pages)")
        pm = PageManager(num_pages, pc.page_size)
        sched = Scheduler(max_slots=pc.max_slots, page_manager=pm,
                          table_width=width, clock=clock)
        for r in reqs:
            sched.submit(r)
        cache = self.model.init_paged_cache(cfg, num_pages, pc.page_size,
                                            kv_dtype=pc.kv_dtype,
                                            device=self.device)

        t0 = clock()
        now = lambda: clock() - t0  # noqa: E731 — engine-relative clock
        slot_rid = np.zeros(pc.max_slots, np.int32)
        slot_tok = np.full(pc.max_slots, sc.pad_id, np.int32)
        while sched.has_work:
            admitted = sched.admit(now())
            for i in admitted:
                req = sched.slots[i].request
                toks = np.full((1, S_pad), sc.pad_id, np.int64)
                toks[0, :len(req.prompt)] = req.prompt
                pt_row = pm.table_row(req.rid, width)[None]
                logits, cache = self.model.prefill_paged(
                    cfg, self.params, {"tokens": self._tensor(toks,
                                                              torch.int64)},
                    cache, self._tensor(pt_row, torch.int32),
                    self._tensor([len(req.prompt)], torch.int32))
                slot_rid[i] = req.rid
                slot_tok[i] = self._sample_rows(logits, [req.rid], [0])[0]
                sched.record_token(i, slot_tok[i], sc.eos_id, now())
            if sched.num_active == 0:
                if sched.waiting:  # idle until the next arrival
                    wait = sched.waiting[0].arrival - now()
                    if wait > 0:
                        time.sleep(min(wait, 0.01))
                    continue
                break
            tok_idx = [0 if s is None else s.produced for s in sched.slots]
            logits, cache = self.model.decode_step_paged(
                cfg, self.params, cache,
                self._tensor(slot_tok[:, None], torch.int64),
                self._tensor(sched.table(), torch.int32),
                self._tensor(sched.kv_lens(), torch.int32),
                graphs=self._graphs)
            tok_np = self._sample_rows(logits, slot_rid, tok_idx)
            t = now()
            for i, s in enumerate(sched.slots):
                if s is None:
                    continue
                if sched.record_token(i, tok_np[i], sc.eos_id, t):
                    slot_tok[i] = tok_np[i]
        pm.check_invariants()
        if pm.live_requests:
            raise AssertionError("pages leaked past retirement")
        return sched.finished
