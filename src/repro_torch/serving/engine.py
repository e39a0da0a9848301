"""Serving engine: continuous batching over a paged KV cache (port of the
``Engine.serve`` path of ``repro/serving/engine.py``; DESIGN.md §Serving
contract).

A ``Scheduler`` admits requests from a queue into a fixed set of decode
slots (per-decode-step admit/retire: a finished request's pages are
released and its slot refilled by a waiting prefill the same step).  Each
admitted request is prefilled alone (B=1, padded to the page size); then
one batched decode step runs over all slots, empty ones included.

On the card each decode step replays every layer's FFN half as a CUDA
graph (``lm.DecodeGraphs``, captured in the first decode step); the
attention kernels run, and are counted, as launched.

Sampling is deterministic per request: token t of request rid draws from a
``torch.Generator`` seeded with (seed, rid, t), so outputs do not depend on
batch composition or admission order.  The draws are not the reference's
(``jax.random.fold_in`` bits cannot be reproduced); greedy decoding is
argmax, as in the reference.  ``eos_id=-1`` never stops early.

Held to the reference's ``serve`` as it runs, this keeps its decode
positions: the scheduler counts a sampled token in ``kv_len`` before the
decode step that is fed it has written it, so that step ropes and writes
it one position late and attends the slot before it (ROADMAP.md §3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Sequence

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


@dataclass
class ServeConfig:
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => explicit "never stops early" sentinel
    pad_id: int = 0   # prompt padding and the token of empty decode slots
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


def _align(n: int, m: int) -> int:
    return -(-int(n) // int(m)) * int(m)


def _row_seed(seed: int, rid: int, tok_idx: int) -> int:
    """Seed of the generator that draws token ``tok_idx`` of ``rid``."""
    ss = np.random.SeedSequence([int(seed), int(rid), int(tok_idx)])
    return int(ss.generate_state(1, np.uint64)[0])


class Engine:
    def __init__(self, cfg: ModelConfig, params, *, serve: ServeConfig = None,
                 paged: PagedConfig = None, device=None):
        self.cfg = cfg
        self.model = get_model(cfg)
        if self.model is lm:  # no frontend, no encoder: item 4
            lm.check_config(cfg, serving=True)
        self.serve_cfg = serve or ServeConfig()
        self.paged = paged or PagedConfig()
        self.device = resolve(device)
        emb = params["emb"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, engine device "
                             f"is {self.device}")
        # each layer's views taken once, not in every decode step
        self.params = dict(params, layers=layer_list(params))
        # on the card the decode step replays each layer's FFN half as a
        # CUDA graph (the paged families' model, ``lm``)
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
