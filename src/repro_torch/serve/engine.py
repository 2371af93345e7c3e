"""Continuous-batching serve engine (port of ``repro/serve/engine.py``).

* :class:`Scheduler` — host-side bookkeeping only: a bounded pending queue
  with priority-with-aging admission, and a slot table.
* :class:`ServeEngine` — per-slot device state (last token, position,
  active flag, remaining budget) plus ONE packed decode-cache allocation
  (``Runtime.slot_caches``).  A request's prefill caches are written into
  its batch slot (``Runtime.write_slot``), so admission is a slot write.
* The decode chunk is a Python loop of ``chunk`` decode steps over all
  slots.  Inactive slots still flow through the model, but their position
  is frozen and their emission set to ``pad_id``; the KV row they write at
  the frozen position is overwritten by the next occupant before it is read
  and masked out of attention until then.  The host reads the chunk's
  tokens once, at its end.

Under a sparse runtime the LM-head plan is built at the first prefill (one
plan-cache miss) and replayed on every later prefill and decode step (hits).

Sampling: greedy (``temperature == 0``) or temperature sampling with one
``torch.Generator`` per request, seeded from ``(seed, rid)``, advanced only
when that request samples.  These streams do not reproduce the JAX engine's
``jax.random`` streams: token parity with the JAX package holds for greedy
decoding only.

The JAX engine's resilience hooks (fault injection, the ``isfinite``
watchdog, TTL deadlines, work-budget shedding and slot halving on a failed
allocation) wait for the resilience slice (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any

import torch

from repro_torch import runtime as rtm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

__all__ = ["Request", "Scheduler", "ServeEngine", "QueueFull", "generate"]


class QueueFull(RuntimeError):
    """The bounded pending queue is at capacity (retry with backoff)."""


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: Any  # int [s] tensor on the host
    max_new: int
    arrival: float = 0.0  # traffic-replay timestamp (seconds, engine clock)
    priority: int = 0  # higher admits first (aged so low never starves)
    tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None  # "eos" | "length"
    slot: int | None = None
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # first token (produced at admission, from prefill)
    t_finish: float = 0.0

    @property
    def ok(self) -> bool:
        return self.finished and self.finish_reason in ("eos", "length")


class Scheduler:
    """Slot table + bounded priority admission.  Pure host-side bookkeeping.

    ``admit(now)`` fills free slots by effective priority ``priority +
    age_boost * (now - t_submit)``; ties break in submission order, so with
    the default ``priority=0`` admission is FIFO.
    """

    def __init__(self, slots: int, *, max_pending: int | None = None,
                 age_boost: float = 0.1):
        self.num_slots = slots
        self.max_pending = max_pending
        self.age_boost = float(age_boost)
        self.pending: collections.deque[Request] = collections.deque()
        self.table: list[Request | None] = [None] * slots

    def submit(self, req: Request) -> None:
        if self.max_pending is not None and len(self.pending) >= self.max_pending:
            raise QueueFull(f"pending queue at capacity ({self.max_pending}); retry with backoff")
        self.pending.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.table)

    def occupied(self) -> list[tuple[int, Request]]:
        return [(i, r) for i, r in enumerate(self.table) if r is not None]

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.table) if r is None]

    def effective_priority(self, req: Request, now: float) -> float:
        return req.priority + self.age_boost * max(now - req.t_submit, 0.0)

    def admit(self, now: float = 0.0) -> list[tuple[int, Request]]:
        placed = []
        for slot in self.free_slots():
            if not self.pending:
                break
            best = max(
                range(len(self.pending)),
                key=lambda i: (self.effective_priority(self.pending[i], now), -i),
            )
            req = self.pending[best]
            del self.pending[best]
            req.slot = slot
            self.table[slot] = req
            placed.append((slot, req))
        return placed

    def evict(self, slot: int) -> Request:
        req = self.table[slot]
        if req is None:
            raise ValueError(f"evicting empty slot {slot}")
        self.table[slot] = None
        req.slot = None
        return req


class ServeEngine:
    """Continuous-batching generation over a fixed-capacity slot array.

    One engine owns one packed cache allocation on ``rt.device`` and one
    plan cache (the runtime's).  ``chunk`` decode steps run per
    :meth:`step` between admissions.
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 256, rt: "rtm.Runtime | None" = None,
                 temperature: float = 0.0, eos_id: int | None = None,
                 pad_id: int = 0, seed: int = 0, chunk: int = 8,
                 max_pending: int | None = None, age_boost: float = 0.1):
        self.params = params
        self.cfg = cfg
        self.rt = rtm.resolve(rt)
        self.device = self.rt.device
        if self.rt._db is not None:
            # warm the TuningDB memo for the decode call sites (FFN gate and
            # w_down, LM head at slot-batch width) so the first decode step
            # resolves against warm probes
            d, d_ff, dtype = cfg.d_model, cfg.d_ff or cfg.d_model * 4, params["embed"].dtype
            for op, kdim, ndim in (("matmul_fused", d, d_ff), ("matmul", d_ff, d),
                                   ("matmul", d, cfg.vocab_size)):
                self.rt._policy(op, (slots, kdim), (kdim, ndim), dtype)
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.seed = int(seed)
        self.chunk = max(int(chunk), 1)
        self.sched = Scheduler(slots, max_pending=max_pending, age_boost=age_boost)
        self._rids = itertools.count()
        self._requests: dict[int, Request] = {}
        self._gens: dict[int, torch.Generator] = {}
        self._t0 = time.monotonic()
        with torch.inference_mode():
            self.caches = self.rt.slot_caches(cfg, slots, self.max_len)
            zeros = lambda dt: torch.zeros((slots,), dtype=dt, device=self.device)
            self.tok = zeros(torch.int64)
            self.pos = zeros(torch.int64)
            self.active = zeros(torch.bool)
            self.remaining = zeros(torch.int64)
        self.tokens_out = 0
        self.chunks_run = 0
        self.steps_run = 0

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new: int = 32, arrival: float = 0.0, *,
               priority: int = 0) -> int:
        """Queue one request; returns its rid.  ``prompt`` is int ``[s]``
        with ``s + max_new <= max_len``.  Raises :class:`QueueFull` when the
        bounded pending queue is at capacity."""
        prompt = torch.as_tensor(prompt, dtype=torch.int64).cpu()
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be rank-1, got {tuple(prompt.shape)}")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.shape[0] + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.shape[0]}) + max_new ({max_new}) exceeds "
                f"engine max_len ({self.max_len})"
            )
        now = self._now()
        req = Request(rid=next(self._rids), prompt=prompt, max_new=int(max_new),
                      arrival=float(arrival), priority=int(priority), t_submit=now)
        self.sched.submit(req)
        self._requests[req.rid] = req
        return req.rid

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def now(self) -> float:
        """Seconds on the engine clock (origin = engine construction)."""
        return self._now()

    # -- sampling ----------------------------------------------------------
    def _generator(self, rid: int) -> torch.Generator:
        gen = self._gens.get(rid)
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed * 1_000_003 + rid)
            self._gens[rid] = gen
        return gen

    def _sample(self, rows: torch.Tensor, rids: list[int | None]) -> torch.Tensor:
        """Next token per row of fp32 logits ``[B, V]``: argmax when greedy,
        else one draw per row with a live rid from that request's generator."""
        if self.temperature == 0.0:
            return torch.argmax(rows, dim=-1)
        out = torch.full((rows.shape[0],), self.pad_id, dtype=torch.int64, device=rows.device)
        probs = torch.softmax(rows / self.temperature, dim=-1)
        for i, rid in enumerate(rids):
            if rid is not None:
                out[i] = torch.multinomial(probs[i], 1, generator=self._generator(rid))[0]
        return out

    # -- admission: prefill into slots -------------------------------------
    def _admit_group(self, placements: list[tuple[int, Request]]) -> None:
        """Prefill one same-prompt-length group as one batch and write each
        request's caches into its slot."""
        g = len(placements)
        s = placements[0][1].prompt.shape[0]
        prompts = torch.stack([r.prompt for _, r in placements]).to(self.device)
        with self.rt.use():
            logits, caches = M.prefill(self.params, self.cfg, {"tokens": prompts})
        part = self.rt.grow_caches(self.cfg, caches, g, self.max_len)
        axes = rtm.cache_batch_axes(self.cfg)
        for j, (slot, _) in enumerate(placements):
            row = rtm.tree_map(lambda x, ax: x.narrow(ax, j, 1), part, axes)
            self.caches = self.rt.write_slot(self.cfg, self.caches, slot, row)
        firsts = self._sample(logits[:, -1].float(), [r.rid for _, r in placements]).tolist()
        now = self._now()
        for j, (slot, req) in enumerate(placements):
            first = int(firsts[j])
            req.t_admit = req.t_first = now
            req.tokens.append(first)
            self.tokens_out += 1
            is_eos = self.eos_id is not None and first == self.eos_id
            done = req.max_new <= 1 or is_eos
            self.tok[slot] = first
            self.pos[slot] = s
            self.remaining[slot] = req.max_new - 1
            self.active[slot] = not done
            if done:
                req.finish_reason = "eos" if is_eos else "length"

    def _admit_all(self) -> None:
        """Admit pending requests into free slots, batching same-length
        prompts into one prefill each."""
        by_len: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in self.sched.admit(self._now()):
            by_len.setdefault(req.prompt.shape[0], []).append((slot, req))
        for group in by_len.values():
            self._admit_group(group)

    def _retire_finished(self) -> list[Request]:
        """Evict every occupied slot whose device state went inactive."""
        active = self.active.tolist()
        out = []
        for slot, req in self.sched.occupied():
            if not active[slot]:
                req.finished = True
                req.t_finish = self._now()
                if req.finish_reason is None:
                    last = req.tokens[-1] if req.tokens else None
                    req.finish_reason = (
                        "eos" if self.eos_id is not None and last == self.eos_id else "length"
                    )
                out.append(self.sched.evict(slot))
        return out

    # -- the decode chunk --------------------------------------------------
    def _decode_chunk(self):
        """``chunk`` decode steps over the packed slot batch.  Returns
        ``(tokens [chunk, B], emitted [chunk, B])`` on the device."""
        rids = [r.rid if r is not None else None for r in self.sched.table]
        toks, emitted = [], []
        tok, pos, active, remaining = self.tok, self.pos, self.active, self.remaining
        with self.rt.use():
            for _ in range(self.chunk):
                logits, self.caches = M.decode_step(
                    self.params, self.cfg, self.caches, {"tokens": tok[:, None]}, pos
                )
                live_rids = rids if self.temperature == 0.0 else [
                    rid if a else None for rid, a in zip(rids, active.tolist())
                ]
                nxt = torch.where(active, self._sample(logits[:, -1].float(), live_rids), self.pad_id)
                live = active.long()
                pos = pos + live
                remaining = remaining - live
                done = remaining <= 0
                if self.eos_id is not None:
                    done = done | (nxt == self.eos_id)
                toks.append(nxt)
                emitted.append(active)
                active = active & ~done
                tok = nxt
        self.tok, self.pos, self.active, self.remaining = tok, pos, active, remaining
        return torch.stack(toks), torch.stack(emitted)

    # -- the serving loop --------------------------------------------------
    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Admit, run one decode chunk, retire finished.  Returns the
        requests that finished during this call."""
        self._admit_all()
        finished = self._retire_finished()  # requests done at admission
        # backfill slots freed by admission-time finishes before decoding
        self._admit_all()
        finished += self._retire_finished()
        if not bool(self.active.any()):
            return finished
        toks, emitted = self._decode_chunk()
        self.chunks_run += 1
        self.steps_run += self.chunk
        toks, emitted = toks.cpu(), emitted.cpu()
        for slot, req in self.sched.occupied():
            new = toks[emitted[:, slot], slot].tolist()
            req.tokens.extend(new)
            self.tokens_out += len(new)
        finished += self._retire_finished()
        return finished

    def run(self) -> dict[int, list[int]]:
        """Drain every submitted request; returns {rid: emitted tokens}."""
        while self.sched.has_work:
            self.step()
        return {rid: r.tokens for rid, r in self._requests.items()}

    def stats(self) -> dict:
        """Engine + plan-cache counters.  ``decode_chunks`` counts decode
        chunk calls (the JAX engine's trace counter has no counterpart:
        PyTorch runs eagerly)."""
        return {
            "tokens_out": self.tokens_out,
            "decode_chunks": self.chunks_run,
            "steps_run": self.steps_run,
            "slots": self.sched.num_slots,
            "plan_cache": self.rt.plan_cache.stats(),
        }


def generate(params, cfg: ModelConfig, prompt_tokens, *, max_new: int = 32,
             max_len: int | None = None, temperature: float = 0.0, seed: int = 0,
             rt: "rtm.Runtime | None" = None) -> torch.Tensor:
    """Batched generation: every row of ``prompt_tokens [B, S]`` becomes a
    request, slots equal the batch, one chunk covers the whole decode.
    Returns int ``[B, max_new]`` on the host."""
    prompt_tokens = torch.as_tensor(prompt_tokens, dtype=torch.int64)
    b, s = prompt_tokens.shape
    eng = ServeEngine(
        params, cfg, slots=b, max_len=max_len or (s + max_new), rt=rt,
        temperature=temperature, seed=seed, chunk=max(max_new - 1, 1),
    )
    rids = [eng.submit(prompt_tokens[i], max_new=max_new) for i in range(b)]
    out = eng.run()
    return torch.tensor([out[r] for r in rids], dtype=torch.int32)
