"""Serving: slot-based batched decoding (port of ``repro/serve/engine.py``
``Request`` and ``BatchedDecoder``).

BatchedDecoder — a continuous-batching slot engine around an arch's
(prefill, decode) pair, with the JAX package's slot semantics:

  * fixed B decode slots (every decode step runs the whole slot batch);
  * a request prefills alone (batch 1) and its cache is spliced into a
    free slot on the batch axis; decode advances every live slot in one
    step, attention through the ``flash_decode`` kernel on a card;
  * the finish condition is checked at admission: the prefill argmax is
    generated token 1, so a ``max_new == 1`` request never takes a slot;
  * finished slots are reusable at once (slot state is cache rows and a
    position), and :meth:`BatchedDecoder.evict_all` drops every resident
    request without decoding further.

A row's decode output does not depend on the other slots (the kernel's
split count depends on the cache length only), so batched ≡ sequential
holds bitwise.  Not ported yet: the ``serve.decode`` fault point (it
waits for ``core/faults.py``, ROADMAP queue A item 4) and
``RetrievalAugmentedEngine`` (queue A item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import arch as A
from ..index.base import resolve_device


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                    # [S] int32 — NEVER mutated by serving
    max_new: int = 16
    rid: int = -1
    # filled by the engine
    generated: list[int] = dataclasses.field(default_factory=list)


class BatchedDecoder:
    """Slot-based greedy batched decoding for one architecture, on ``device``
    (the parameters' device; decode attention through the ``flash_decode``
    kernel on a card, its plain version on the CPU).  ``steps`` counts
    decode dispatches."""

    def __init__(self, spec: A.ArchSpec, params, batch_slots: int,
                 max_len: int, *, device="cuda"):
        self.spec = spec
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.vocab = spec.cfg.vocab
        self.device = resolve_device(device)
        self._prefill1 = A.make_prefill(spec, max_len)
        self._decode = A.make_decode(spec)
        self.cache = A.init_caches(spec, batch_slots, max_len, self.device)
        self.positions = np.zeros(batch_slots, np.int32)
        self.last_token = np.zeros(batch_slots, np.int32)
        self.live = np.zeros(batch_slots, bool)
        self.slot_req: list[Request | None] = [None] * batch_slots
        # requests whose finish condition was already met at admission;
        # they never occupy a slot and are drained by the next step()
        self._admit_done: list[Request] = []
        self.steps = 0

    @property
    def free_slots(self) -> int:
        return int((~self.live).sum())

    # -- slot management -------------------------------------------------------
    def _splice(self, cache_b, slot: int) -> None:
        """Write a batch-1 cache into slot ``slot`` of the slot cache, in
        place."""
        for full, piece in zip(self.cache, cache_b, strict=True):
            for name, t in full.items():
                t[slot] = piece[name][0].to(t.dtype)

    def admit(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot.  False if the engine is full.
        A request whose finish condition holds after its prefill token
        (``max_new == 1``, or no room left) never takes a slot and
        surfaces from the next :meth:`step`; ``generated`` is reset first,
        so re-serving a Request yields exactly ``max_new`` tokens."""
        free = np.flatnonzero(~self.live)
        if free.size == 0:
            return False
        slot = int(free[0])
        req.generated = []
        S = req.prompt.shape[0]
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=self.device)[None]
        logits, cache_b = self._prefill1(self.params,
                                         {"tokens": tokens,
                                          "positions": positions})
        tok = int(torch.argmax(logits[0]))
        req.generated.append(tok)
        if len(req.generated) >= req.max_new or S + 1 >= self.max_len:
            self._admit_done.append(req)
            return True
        self._splice(cache_b, slot)
        self.positions[slot] = S
        self.last_token[slot] = tok
        self.live[slot] = True
        self.slot_req[slot] = req
        return True

    def evict_all(self) -> list[Request]:
        """Evict every resident request (live slots and admission-finished
        stragglers) without decoding further.  Slot caches need no
        scrubbing: admission overwrites a slot's cache rows wholesale."""
        evicted: list[Request] = []
        for slot in np.flatnonzero(self.live):
            evicted.append(self.slot_req[slot])
            self.slot_req[slot] = None
        self.live[:] = False
        evicted.extend(self._admit_done)
        self._admit_done = []
        return evicted

    def decode_batch(self) -> dict:
        """The next decode step's inputs for every slot, on the device."""
        return {"token": torch.as_tensor(self.last_token,
                                         device=self.device),
                "position": torch.as_tensor(self.positions,
                                            device=self.device)}

    def step(self) -> list[Request]:
        """One decode step for all live slots; returns finished requests
        (including any that finished at admission since the last step)."""
        if not self.live.any():
            done, self._admit_done = self._admit_done, []
            return done
        logits, self.cache = self._decode(self.params, self.cache,
                                          self.decode_batch())
        self.steps += 1
        next_tok = torch.argmax(logits, dim=-1).cpu().numpy().astype(
            np.int32)
        done, self._admit_done = self._admit_done, []
        for slot in np.flatnonzero(self.live):
            req = self.slot_req[slot]
            req.generated.append(int(next_tok[slot]))
            self.positions[slot] += 1
            self.last_token[slot] = next_tok[slot]
            finished = (len(req.generated) >= req.max_new
                        or self.positions[slot] + 1 >= self.max_len)
            if finished:
                self.live[slot] = False
                self.slot_req[slot] = None
                done.append(req)
        return done

    def run(self, requests: Sequence[Request]) -> list[Request]:
        """Serve a request list to completion (admission + decode loop)."""
        pending = list(requests)[::-1]
        finished: list[Request] = []
        while pending or self.live.any() or self._admit_done:
            while pending and self.admit(pending[-1]):
                pending.pop()
            finished.extend(self.step())
        return finished
