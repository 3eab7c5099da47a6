"""Batched decode engine with continuous batching.

The port of the JAX package's ``serve/engine.py``, with the same admit,
prefill-insert, step and finish logic.  A fixed pool of B slots shares one
cache tree; per-slot sequence lengths (the decode step takes a (B,)
``cache_len``).  A request is admitted into an idle slot by a
single-sequence prefill whose caches are copied in at the slot's batch
index; a finished slot frees at once — the decode step never waits for the
longest request.  As in the reference, a slot's length is not reset when it
frees, and idle slots still run in the decode batch (their tokens are
dropped).

There is no ``jit``: prefill and decode run eagerly on ``device`` (default
the card), and the caches are updated in place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import model as M
from ..sharding.rules import tree_leaves


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                      # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False


def _insert_cache(caches, slot_caches, b: int) -> None:
    """Copy a single-sequence cache tree into batch index ``b``.  Every leaf
    holds the batch first, so a slot's KV rows and its recurrent states
    (Mamba's ``h`` and ``conv``, xLSTM's ``C/n/m/conv`` and ``c/n/h/m``) are
    replaced whole."""
    for full, one in zip(tree_leaves(caches), tree_leaves(slot_caches),
                         strict=True):
        full[b].copy_(one[0])


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, max_batch: int = 4,
                 max_len: int = 256, dtype=torch.float32,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.B = max_batch
        self.max_len = max_len
        self.dtype = dtype
        self.caches = M.init_caches(cfg, max_batch, max_len, dtype,
                                    self.device)
        self.lengths = np.zeros(max_batch, np.int32)
        self.active: List[Optional[Request]] = [None] * max_batch
        self.last_tokens = np.zeros((max_batch, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    # -- request lifecycle ----------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int = 16,
               eos_id: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=np.asarray(
            prompt, np.int32), max_new_tokens=max_new_tokens, eos_id=eos_id))
        return rid

    @torch.no_grad()
    def _admit(self) -> None:
        for b in range(self.B):
            if self.active[b] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            S = len(req.prompt)
            one_caches = M.init_caches(self.cfg, 1, self.max_len, self.dtype,
                                       self.device)
            batch = {"tokens": torch.from_numpy(req.prompt[None, :]).long()
                     .to(self.device)}
            if self.cfg.frontend:
                batch["frontend_embeds"] = torch.zeros(
                    (1, self.cfg.frontend_len, self.cfg.d_model),
                    dtype=torch.float32, device=self.device)
            logits, one_caches = M.prefill(self.params, batch, one_caches,
                                           self.cfg)
            first = int(torch.argmax(logits[0, -1]))
            _insert_cache(self.caches, one_caches, b)
            self.active[b] = req
            self.lengths[b] = S + (self.cfg.frontend_len
                                   if self.cfg.frontend else 0)
            req.generated.append(first)
            self.last_tokens[b, 0] = first
            self._maybe_finish(b)

    def _maybe_finish(self, b: int) -> None:
        req = self.active[b]
        if req is None:
            return
        if (len(req.generated) >= req.max_new_tokens or
                (req.eos_id is not None and req.generated and
                 req.generated[-1] == req.eos_id) or
                int(self.lengths[b]) >= self.max_len - 1):
            req.done = True
            self.finished[req.rid] = req
            self.active[b] = None

    # -- one decode step for the whole pool ------------------------------------
    @torch.no_grad()
    def step(self) -> int:
        self._admit()
        if not any(r is not None for r in self.active):
            return 0
        logits, self.caches = M.decode_step(
            self.params,
            torch.from_numpy(self.last_tokens).long().to(self.device),
            self.caches, torch.from_numpy(self.lengths).to(self.device),
            self.cfg)
        next_tokens = torch.argmax(logits[:, 0, :], dim=-1).cpu().numpy()
        n_active = 0
        for b in range(self.B):
            req = self.active[b]
            if req is None:
                continue
            self.lengths[b] += 1
            tok = int(next_tokens[b])
            req.generated.append(tok)
            self.last_tokens[b, 0] = tok
            n_active += 1
            self._maybe_finish(b)
        return n_active

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.finished


__all__ = ["ServeEngine", "Request"]
