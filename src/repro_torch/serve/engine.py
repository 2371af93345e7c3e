"""Continuous-batching serve engine (port of ``repro/serve/engine.py``).

* :class:`Scheduler` — host-side bookkeeping only: a bounded pending queue
  with priority-with-aging admission, and a slot table.
* :class:`ServeEngine` — per-slot device state (last token, position,
  active flag, remaining budget, RNG key, poison code) in static buffers plus ONE
  packed decode-cache allocation (``Runtime.slot_caches``).  A request's
  prefill caches are written into its batch slot (``Runtime.write_slot``),
  so admission is a slot write; admission, expiry and retirement update the
  buffers in place, never rebind them.
* The decode chunk (:meth:`ServeEngine._chunk`) is ``chunk`` decode steps
  over all slots, reading and writing only those buffers and the caches.
  Inactive slots still flow through the model, but their position is frozen
  and their emission set to ``pad_id``; the KV row they write at the frozen
  position is overwritten by the next occupant before it is read and masked
  out of attention until then.  The host reads the chunk's tokens, emission
  flags and watchdog flags once, at its end.
* On a CUDA device, greedy or sampled, the chunk runs as one CUDA graph
  (:class:`_DecodeGraph`), the port's counterpart of the JAX engine's jitted
  ``lax.scan`` program: the first chunk runs eagerly on a side stream (the
  warm-up), the second is captured there, and every later chunk replays it.
  Admitting, finishing, expiring and faulting change the buffers' data,
  never the graph (``stats()["decode_graph_captures"]``).

Under a sparse runtime the LM-head plan is built at the first prefill (one
plan-cache miss) and replayed on every later prefill and eager decode step
(hits); the graph replays the plan it looked up at capture, as the JAX
program hoists the weight plan out of its scan.

Sampling: greedy (``temperature == 0``) or temperature sampling from the
JAX engine's own streams (:mod:`repro_torch.prng`, JAX's Threefry replayed
bit for bit): request ``rid`` draws from ``fold_in(PRNGKey(seed), rid)``,
split before its first token; each step splits a slot's key into ``(next,
sub)``, draws ``categorical(sub, row / temperature)`` and keeps ``next``,
and a slot that emits nothing (inactive, or retired by the watchdog) keeps
its key.  The keys live in a device buffer ``keys [slots, 2]``, and the
split and draw are one launch of the sampler kernel a step
(:func:`repro_torch.kernels.sample.sample_tokens`; its plain version on
the CPU), so a sampled chunk reads nothing on the host and is captured as a
greedy one is.  Sampled tokens equal the JAX engine's for the same seed,
rids and weights.

On a mesh (the runtime's ``sharding`` policy, or ``generate(mesh=...)``, as
JAX's ``generate(mesh=)`` installs a ``ShardingPolicy``) the model is
sharded (:mod:`repro_torch.models.transformer`): ``params`` holds this
rank's shards, and every rank runs the same scheduler on the same requests.
The packed caches are cut by their known layouts
(:func:`~repro_torch.parallel.sharding.rank_cache_pspecs`): the slots over
the data axes (when they divide; otherwise every data rank holds all of
them), the KV heads over ``model`` where head-parallel attention shards
them, and a Mamba2 layer's ``conv_x`` channels and state heads over
``model`` where its heads divide it; an MLA latent and the Mamba2
``conv_b``/``conv_c`` tails are held whole on every model rank (each
computes them whole), and a batch-1 cache's sequence is not split.  A
data rank prefills only the admitted prompts of the slots it holds (a rank
with none of a round's runs one stand-in prompt, so that every rank joins
the weights' gathers); a decode step runs the tensor-parallel bodies on
the rank's slots.  The last-position logits rows of both are gathered over
the data axes and every rank holds every slot's key, so every rank samples
the same tokens.  The
engine clock is rank 0's (broadcast at every reading) and the shedding cost
is summed over the mesh, so every rank takes the same decisions.  The
decode chunk of a mesh of several ranks runs eagerly: ``cuda_graph=True``
there is refused at construction (capturing the collectives is not ported).

Resilience (:mod:`repro_torch.resilience`), as in the JAX engine: a bounded
pending queue (``QueueFull``, typed), per-request TTL deadlines, shedding
against a work budget priced by the cached plans' ``total_work``, slot
halving when the cache allocation fails, admission requeue and retry after a
failed prefill allocation, and an ``isfinite`` watchdog inside the chunk
that retires a NaN/Inf-poisoned slot with an error status without
perturbing its batch-mates.  The watchdog is a device-side flag (no host
read per step), so the chunk stays capturable.  Every degradation lands in
the engine's :class:`~repro_torch.resilience.ResilienceLog`.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import time
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import prng
from repro_torch import runtime as rtm
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.sample import sample_tokens
from repro_torch.kernels.tensordash_spmm import holding
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.models.moe import expert_capacity
from repro_torch.parallel import sharding as S
from repro_torch.resilience import faults as rfaults
from repro_torch.resilience import log as rlog
from repro_torch.runtime.plan import _version

__all__ = [
    "Request", "Scheduler", "ServeEngine", "QueueFull",
    "prefill_step", "decode_one", "generate",
]


class QueueFull(RuntimeError):
    """The bounded pending queue is at capacity (retry with backoff).

    Distinct from shed-by-policy, which admits the submit and later finishes
    the victim with ``finish_reason="shed"``."""


def _decode_sites(cfg: ModelConfig, slots: int) -> list[tuple[str, tuple, tuple]]:
    """``(op, a_shape, b_shape)`` of the tuned call sites of one decode step
    over ``slots`` rows: the dense FFN's gate and ``w_down`` (a dense config,
    or a MoE config's dense blocks), each expert's ``w_down`` at the decode
    capacity of ``slots`` tokens, the LM head.  An SSM or hybrid config has
    no FFN on the runtime (the hybrid's shared MLP is plain ``@``): its only
    site is the LM head."""
    d = cfg.d_model
    sites = []
    if cfg.family == "dense" or (cfg.family == "moe" and cfg.first_dense_layers):
        d_ff = cfg.d_ff or d * 4
        sites += [("matmul_fused", (slots, d), (d, d_ff)), ("matmul", (slots, d_ff), (d_ff, d))]
    if cfg.family == "moe":
        cap = expert_capacity(cfg, slots)
        sites.append(("moe_expert", (cap, cfg.moe_d_ff), (cfg.moe_d_ff, d)))
    sites.append(("matmul", (slots, d), (d, cfg.vocab_size)))
    return sites


def prefill_step(params, cfg: ModelConfig, batch):
    """Prompt -> (last-position logits, filled caches)."""
    return M.prefill(params, cfg, batch)


def decode_one(params, cfg: ModelConfig, caches, step_batch, pos):
    """One token for every sequence in the batch (``pos`` scalar or [B])."""
    return M.decode_step(params, cfg, caches, step_batch, pos)


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: Any  # int [s] tensor on the host
    max_new: int
    arrival: float = 0.0  # traffic-replay timestamp (seconds, engine clock)
    priority: int = 0  # higher admits first (aged so low never starves)
    deadline: float | None = None  # absolute engine-clock TTL expiry
    tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str | None = None  # "eos"|"length"|"error"|"expired"|"shed"
    error: str | None = None  # detail for finish_reason == "error"
    slot: int | None = None
    retries: int = 0  # admission retries after transient (alloc) failures
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0  # first token (produced at admission, from prefill)
    t_finish: float = 0.0

    @property
    def ok(self) -> bool:
        """Finished by producing its output (EOS or budget), not degraded."""
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

    def expire_pending(self, now: float) -> list[Request]:
        """Drop (and return) pending requests whose deadline has passed."""
        expired = [r for r in self.pending if r.deadline is not None and r.deadline <= now]
        if expired:
            dead = set(id(r) for r in expired)
            self.pending = collections.deque(r for r in self.pending if id(r) not in dead)
        return expired

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


class _DecodeGraph:
    """One engine's decode chunk as a CUDA graph.

    :meth:`run` runs the chunk eagerly on :attr:`stream` the first time (the
    warm-up: it makes the memoized dense plans, the kernels' counter
    workspace of that stream, cuBLAS's workspace and loads the kernels, so
    none of them is first made inside the capture), captures it on the same
    stream the second time and replays the capture then and every later
    time.  The chunk reads and writes only the engine's static buffers and
    caches, so a replay sees the slots as admission left them.

    The LM-head plan is looked up once, at capture, and replayed.  The head
    tensor's identity and version are recorded then, as
    ``PlanCache.lookup`` checks them: when the head is replaced or modified
    in place, the graph is dropped, the next chunk warms up eagerly (and
    replans the head) and the one after recaptures.  :attr:`held` keeps
    what the captured launches read from caches outside the graph's pool
    (the plans, the dense-plan memo's tensors, the counter workspace), so
    an eviction from those caches cannot free memory under a replay.
    """

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out = None  # the captured chunk's static outputs
        self.warm = False
        self.head: tuple[torch.Tensor, int | None] | None = None
        self.held: list = []
        self.captures = 0
        self.replays = 0

    def run(self, chunk, head: torch.Tensor):
        if self.graph is not None and (head is not self.head[0] or _version(head) != self.head[1]):
            self.graph = self.out = self.head = None
            self.held, self.warm = [], False
        if self.graph is None:
            current = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(current)
            if not self.warm:
                with torch.cuda.stream(self.stream):
                    out = chunk()
                current.wait_stream(self.stream)
                self.warm = True
                return out
            self.capture(chunk, head)
        self.graph.replay()
        self.replays += 1
        return self.out

    def capture(self, chunk, head: torch.Tensor) -> None:
        """Record ``chunk`` into a new graph on :attr:`stream` (nothing runs
        until the first replay).  A failed capture raises.

        A CUDA graph destroyed while this one captures invalidates the
        capture, and an old engine's graph may wait in cyclic garbage: the
        collector stays off until the capture ends.  (Collecting first
        instead would charge the capture for freeing whatever the process
        left in cycles, seconds after a profiler session.)"""
        graph = torch.cuda.CUDAGraph()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with holding() as held, torch.cuda.graph(graph, stream=self.stream):
                out = chunk()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing the decode chunk as a CUDA graph failed ({e}); "
                "ServeEngine(cuda_graph=False) runs it eagerly") from e
        finally:
            if enabled:
                gc.enable()
        self.graph, self.out, self.held, self.head = graph, out, held, (head, _version(head))
        self.captures += 1


class ServeEngine:
    """Continuous-batching generation over a fixed-capacity slot array.

    One engine owns one packed cache allocation on ``rt.device`` and one
    plan cache (the runtime's).  ``chunk`` decode steps run per
    :meth:`step` between admissions.  ``cuda_graph`` (``None``: on a CUDA
    device, except on a mesh of several ranks) runs the chunk as one CUDA graph;
    ``True`` where that cannot hold raises ``ValueError``.  A frontend
    config (``inputs_embeds`` in place of tokens) is refused at
    construction: the engine, as JAX's, serves token prompts only.
    """

    #: admission retries before a transient-alloc-failed request is failed
    MAX_ADMIT_RETRIES = 3

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 8,
                 max_len: int = 256, rt: "rtm.Runtime | None" = None,
                 temperature: float = 0.0, eos_id: int | None = None,
                 pad_id: int = 0, seed: int = 0, chunk: int = 8,
                 max_pending: int | None = None, age_boost: float = 0.1,
                 work_budget: float | None = None, watchdog: bool = True,
                 fault_plan: "rfaults.FaultPlan | None" = None,
                 log: "rlog.ResilienceLog | None" = None,
                 cuda_graph: bool | None = None):
        if cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: the engine serves token prompts; a {cfg.frontend} frontend takes "
                "inputs_embeds, and JAX's ServeEngine serves tokens only")
        self.params = params
        self.cfg = cfg
        self.rt = rtm.resolve(rt)
        self.device = self.rt.device
        self.max_len = int(max_len)
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.pad_id = int(pad_id)
        self.seed = int(seed)
        self.chunk = max(int(chunk), 1)
        self.watchdog = bool(watchdog)
        self.work_budget = work_budget
        self.fault_plan = fault_plan
        self.log = log if log is not None else (rlog.ambient_log() or rlog.ResilienceLog())
        self._sh = tfm.shards_of(cfg, self.rt)  # None without a mesh
        self._multi = self._sh is not None and self._sh.world > 1
        self._cache_cfg = M.local_cache_config(cfg, self._sh.tp) if self._sh is not None else cfg
        graphable = self.device.type == "cuda" and not self._multi
        if cuda_graph and not graphable:
            if self._multi:
                raise ValueError(
                    f"cuda_graph=True on a mesh of {self._sh.world} ranks: capturing the sharded decode's "
                    "collectives is not ported; ServeEngine(cuda_graph=False) runs the chunk eagerly")
            raise ValueError(f"cuda_graph=True needs a CUDA device (device {self.device})")
        self.sched = Scheduler(slots, max_pending=max_pending, age_boost=age_boost)
        self._rids = itertools.count()
        self._requests: dict[int, Request] = {}
        self._base_key = prng.prng_key(self.seed)  # on the host: admission folds the rids in there
        self._t0 = time.monotonic()
        with torch.inference_mode():
            # a failed cache allocation degrades to half the slot count
            self.caches, slots = self._alloc_slot_caches(cfg, slots)
            self._slot0, self._local_slots = self._slot_range(slots)
            self._split = self._local_slots != slots  # the slots split over the data axes
            zeros = lambda dt: torch.zeros((slots,), dtype=dt, device=self.device)
            self.tok = zeros(torch.int64)
            self.pos = zeros(torch.int64)
            self.active = zeros(torch.bool)
            self.remaining = zeros(torch.int64)
            self.poison = zeros(torch.int32)  # 0 clean, 1 NaN, 2 Inf logits
            # each slot's JAX key; every rank holds every slot's
            self.keys = torch.zeros((slots, 2), dtype=torch.uint32, device=self.device)
        self.sched.num_slots = slots
        self.sched.table = self.sched.table[:slots]
        if self.rt._db is not None:
            # warm the TuningDB memo for the decode call sites (FFN gate and
            # w_down, each expert's w_down at its decode capacity, LM head at
            # slot-batch width) so the first decode step resolves against
            # warm probes
            for op, a_shape, b_shape in _decode_sites(cfg, slots):
                self.rt._policy(op, a_shape, b_shape, params["embed"].dtype)
        self._graph = _DecodeGraph(self.device) if (graphable if cuda_graph is None else cuda_graph) else None
        self.tokens_out = 0
        self.chunks_run = 0
        self.steps_run = 0

    def _cache_specs(self, slots: int):
        """``(global caches on the meta device, their spec tuples)``: each
        leaf cut by its layout (:func:`M.cache_splits` of the model), the
        slots over the data axes where they divide them."""
        sh = self._sh
        glob = M.init_cache(self.cfg, slots, self.max_len, device="meta")
        data_axes = sh.data_axes if slots % sh.n_data == 0 else ()
        return glob, S.rank_cache_pspecs(glob, data_axes, M.cache_splits(self.cfg, sh.tp))

    def _slot_range(self, slots: int) -> tuple[int, int]:
        """``(first, count)`` of the slots whose caches this rank holds: its
        share of the data axes' split where the slots divide it
        (``cache_pspecs``' batch rule), else all of them."""
        sh = self._sh
        if sh is None or slots % sh.n_data:
            return 0, slots
        n = slots // sh.n_data
        return sh.data_rank * n, n

    def _alloc_slot_caches(self, cfg, slots: int):
        """Allocate the packed decode caches, halving ``slots`` (down to 1)
        on allocation failure: serving degrades to reduced concurrency
        instead of dying at construction.  On a mesh, this rank's cut of
        them (:meth:`_cache_specs`), which must be what the sharded model's
        caches hold; a failed allocation there raises (the ranks would not
        agree on the halving)."""
        while True:
            try:
                rfaults.maybe_alloc_failure(self.fault_plan or rfaults.active(), "slot_caches")
                if self._sh is None:
                    return self.rt.slot_caches(cfg, slots, self.max_len), slots
                caches = self.rt.slot_caches(self._cache_cfg, self._slot_range(slots)[1], self.max_len)
                glob, specs = self._cache_specs(slots)
                want = S.map_specs(lambda x, sp: tuple(S.local_shard(x, sp, self._sh.policy).shape), glob, specs)
                got = S.map_specs(lambda x, sp: tuple(x.shape), caches, specs)
                if want != got:
                    raise AssertionError(f"the sharded model's caches {got} are not the cut {want}")
                return caches, slots
            except (rfaults.SimulatedAllocFailure, torch.cuda.OutOfMemoryError, MemoryError) as e:
                if slots <= 1 or self._multi:
                    raise
                self.log.record("alloc", "serve.slot_caches", "halve-slots", slots=slots, error=str(e))
                slots //= 2

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new: int = 32, arrival: float = 0.0, *,
               priority: int = 0, ttl: float | None = None) -> int:
        """Queue one request; returns its rid.  ``prompt`` is int ``[s]``
        with ``s + max_new <= max_len``.  ``ttl`` seconds bounds the
        request's whole lifetime (``finish_reason="expired"`` past it).
        Raises :class:`QueueFull` when the bounded pending queue is at
        capacity; under a work budget the engine may instead admit the
        submit and shed the cheapest-to-drop request (``"shed"``)."""
        # lint: allow-host-sync: prompts arrive from the host; a no-op for a host prompt
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
                      arrival=float(arrival), priority=int(priority),
                      deadline=None if ttl is None else now + float(ttl), t_submit=now)
        try:
            self.sched.submit(req)
        except QueueFull:
            self.log.record("queue", "serve.submit", "reject", rid=req.rid,
                            pending=len(self.sched.pending))
            raise
        self._requests[req.rid] = req
        self._shed_to_budget(now)
        return req.rid

    def _now(self) -> float:
        t = time.monotonic() - self._t0
        if not self._multi:
            return t
        # rank 0's clock on every rank: the scheduler's decisions must agree
        group = S.axis_group(self._sh.policy.mesh, tuple(S.axis_sizes(self._sh.policy.mesh)))[0]
        buf = torch.tensor([t], dtype=torch.float64, device=self.device)
        dist.broadcast(buf, src=dist.get_global_rank(group, 0), group=group)
        return float(buf[0])  # lint: allow-host-sync: the engine clock, read on the host

    def now(self) -> float:
        """Seconds on the engine clock (origin = engine construction)."""
        return self._now()

    # -- plan-aware load shedding ------------------------------------------
    def _plan_cost(self) -> float:
        """Per-token admission cost: the cached plans' ``total_work`` (the
        ragged-grid steps a decode step replays), or 1.0 when no plan is
        cached (dense runtime, cold cache)."""
        total = sum(ps["total_work"] for ps in self.rt.plan_cache.plan_stats())
        if self._multi:  # each rank caches its own shards' plans: their sum, on every rank
            total = float(S.mesh_all_reduce(torch.tensor(float(total), device=self.device), self._sh))
        return float(total) if total > 0 else 1.0

    def _outstanding_work(self) -> float:
        cost = self._plan_cost()
        work = sum(cost * r.max_new for r in self.sched.pending)
        return work + sum(cost * max(r.max_new - len(r.tokens), 0) for _, r in self.sched.occupied())

    def _shed_to_budget(self, now: float) -> list[Request]:
        """Shed pending requests (lowest effective priority first) until the
        outstanding work fits the budget; a policy decision recorded on the
        victim (``finish_reason="shed"``), not a :class:`QueueFull`."""
        if self.work_budget is None:
            return []
        shed: list[Request] = []
        while self.sched.pending and self._outstanding_work() > self.work_budget:
            victim = min(self.sched.pending,
                         key=lambda r: (self.sched.effective_priority(r, now), -r.rid))
            self.sched.pending.remove(victim)
            victim.finished = True
            victim.finish_reason = "shed"
            victim.t_finish = now
            self.log.record("queue", "serve.admission", "shed", rid=victim.rid,
                            priority=victim.priority, cost=self._plan_cost() * victim.max_new,
                            budget=self.work_budget)
            shed.append(victim)
        return shed

    # -- deadlines ---------------------------------------------------------
    def _expire(self, now: float) -> list[Request]:
        """TTL expiry: drop pending requests and evict running slots whose
        deadline passed (the slot's ``active`` lane is cleared in place; its
        cache rows are overwritten by the next occupant's slot write)."""
        out = []
        for req in self.sched.expire_pending(now):
            req.finished = True
            req.finish_reason = "expired"
            req.t_finish = now
            self.log.record("deadline", "serve.pending", "expire", rid=req.rid,
                            waited=now - req.t_submit)
            out.append(req)
        for slot, req in self.sched.occupied():
            if req.deadline is not None and req.deadline <= now:
                self.sched.evict(slot)
                self.active[slot] = False
                req.finished = True
                req.finish_reason = "expired"
                req.t_finish = now
                self.log.record("deadline", "serve.slot", "expire", rid=req.rid, slot=slot,
                                emitted=len(req.tokens))
                out.append(req)
        return out

    # -- sampling ----------------------------------------------------------
    def _sample(self, rows: torch.Tensor, keys: torch.Tensor | None, good: torch.Tensor, *,
                jitted: bool) -> torch.Tensor:
        """Next token per row of fp32 logits ``[B, V]`` (``pad_id`` where
        ``good`` is clear): the argmax when greedy (the keys untouched, and
        ``None`` at admission),
        else JAX's draw from each row's key, which advances in place where
        ``good``.  ``jitted``: the row is scaled as JAX's jitted decode step
        scales it (by the float32 reciprocal of the temperature), else as its
        eager admission does (divided)."""
        if self.temperature == 0.0:
            return torch.where(good, torch.argmax(rows, dim=-1), self.pad_id)
        return sample_tokens(rows, keys, self.temperature, good, self.pad_id, reciprocal=jitted)

    # -- admission: prefill into slots -------------------------------------
    def _by_owner(self, placements: list) -> list[list]:
        """``placements`` by the data rank holding each slot's caches (one
        list, every rank's, when the slots are not split over the data
        axes)."""
        if not self._split:
            return [placements]
        return [[p for p in placements if p[0] // self._local_slots == r] for r in range(self._sh.n_data)]

    def _rounds(self, groups: list) -> list[list]:
        """The prefill calls of one admission: the same-length groups, or,
        with the slots split over the data axes, rounds that give each data
        rank at most one same-length group of its own slots' requests (the
        ranks take as many calls as the rank with the most groups)."""
        if not self._split:
            return groups
        own = [[] for _ in range(self._sh.n_data)]
        for g in groups:
            for mine, part in zip(own, self._by_owner(g)):
                if part:
                    mine.append(part)
        return [[p for mine in own if k < len(mine) for p in mine[k]] for k in range(max(map(len, own), default=0))]

    def _admit_group(self, placements: list[tuple[int, Request]]) -> None:
        """Prefill one round (:meth:`_rounds`): this rank's same-length
        group as one batch, each request's caches written into its slot, and
        every request's first token sampled from the round's last-position
        logits (gathered over the data axes when the slots are split)."""
        rnd = self._by_owner(placements)
        mine = rnd[self._sh.data_rank] if self._split else rnd[0]
        # a rank with nothing of its own prefills one stand-in prompt: every
        # rank joins the weights' gathers
        run = mine or next(g for g in rnd if g)[:1]
        prompts = torch.stack([r.prompt for _, r in run]).to(self.device)
        with self.rt.use():
            logits, caches = M.prefill(self.params, self.cfg, {"tokens": prompts})
        rfaults.maybe_alloc_failure(self.fault_plan or rfaults.active(), "grow_caches")
        rows = logits[:, -1].float()
        if mine:
            part = self.rt.grow_caches(self._cache_cfg, caches, len(mine), self.max_len)
            axes = rtm.cache_batch_axes(self._cache_cfg)
            for j, (slot, _) in enumerate(mine):
                row = rtm.tree_map(lambda x, ax: x.narrow(ax, j, 1), part, axes)
                self.caches = self.rt.write_slot(self._cache_cfg, self.caches, slot - self._slot0, row)
        if self._split:  # every data rank's rows, padded to the longest group
            m = max(map(len, rnd))
            rows = torch.cat([rows[:len(mine)], rows.new_zeros((m - len(mine), rows.shape[1]))])
            every = S.all_gather_cat(rows, self._sh.data_group, 0)
            rows = torch.cat([every[r * m:r * m + len(g)] for r, g in enumerate(rnd)])
        placements = [p for g in rnd for p in g]  # the order of the gathered rows
        keys = None  # greedy decoding draws nothing: no stream is made
        if self.temperature > 0.0:
            # each request's stream: its rid folded into the seed's key, split
            # before the first token; the draw leaves the carried half in keys
            keys = prng.fold_in(self._base_key, torch.tensor([r.rid for _, r in placements])).to(self.device)
        firsts = self._sample(rows, keys, torch.ones(len(placements), dtype=torch.bool, device=self.device),
                              jitted=False).tolist()
        now = self._now()
        for j, (slot, req) in enumerate(placements):
            first = int(firsts[j])
            req.t_admit = req.t_first = now
            req.tokens.append(first)
            self.tokens_out += 1
            is_eos = self.eos_id is not None and first == self.eos_id
            done = req.max_new <= 1 or is_eos
            self.tok[slot] = first
            self.pos[slot] = req.prompt.shape[0]
            self.remaining[slot] = req.max_new - 1
            if keys is not None:
                self.keys[slot] = keys[j]
            self.active[slot] = not done
            if done:
                req.finish_reason = "eos" if is_eos else "length"

    def _admit_all(self) -> None:
        """Admit pending requests into free slots, batching same-length
        prompts (on a split mesh, of one data rank's slots) into one prefill
        each.  A failed allocation during a round's admission sends its
        requests back to the queue (at most
        :attr:`MAX_ADMIT_RETRIES` times, then ``finish_reason="error"``)."""
        by_len: dict[int, list[tuple[int, Request]]] = {}
        for slot, req in self.sched.admit(self._now()):
            by_len.setdefault(req.prompt.shape[0], []).append((slot, req))
        for group in self._rounds(list(by_len.values())):
            try:
                self._admit_group(group)
            except (rfaults.SimulatedAllocFailure, torch.cuda.OutOfMemoryError, MemoryError) as e:
                now = self._now()
                for slot, req in group:
                    self.sched.evict(slot)
                    req.retries += 1
                    if req.retries > self.MAX_ADMIT_RETRIES:
                        req.finished = True
                        req.finish_reason = "error"
                        req.error = f"admission failed: {e}"
                        req.t_finish = now
                        self.log.record("alloc", "serve.admit", "fail-request", rid=req.rid,
                                        retries=req.retries)
                    else:
                        self.sched.pending.appendleft(req)
                        self.log.record("alloc", "serve.admit", "requeue", rid=req.rid,
                                        retries=req.retries)

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
    def _chunk(self):
        """``chunk`` decode steps over the packed slot batch, carrying
        ``(tok, pos, active, remaining)`` from the static buffers and back
        into them in place, with ``poison`` read from its buffer.  Returns
        ``(toks [chunk, B], emitted [chunk, B], faulted [B])`` on the device.

        ``poison`` codes overwrite a slot's last-position fp32 logits row
        (1 NaN, 2 Inf).  With the watchdog a slot whose row is not finite is
        retired: it emits ``pad_id``, its position, budget and key freeze, it
        leaves ``active`` and ``faulted`` marks it; its row is zeroed before
        sampling.  The keys advance in their buffer in place.  No host read."""
        tok, pos, active, remaining, poison = self.tok, self.pos, self.active, self.remaining, self.poison
        faulted = torch.zeros_like(active)
        toks, emitted = [], []
        lo, hi = self._slot0, self._slot0 + self._local_slots
        for _ in range(self.chunk):
            logits, _ = M.decode_step(self.params, self.cfg, self.caches, {"tokens": tok[lo:hi, None]},
                                      pos[lo:hi])
            row = logits[:, -1].float()
            if self._split:  # every data rank's slots: their rows gathered
                row = S.all_gather_cat(row, self._sh.data_group, 0)
            if self.fault_plan is not None:  # without one the poison buffer stays zero
                row = row.masked_fill((poison == 1)[:, None], float("nan"))
                row = row.masked_fill((poison == 2)[:, None], float("inf"))
            if self.watchdog:
                finite = torch.isfinite(row).all(dim=-1)
                faulted = faulted | (active & ~finite)
                good = active & finite
                row = row.masked_fill(~good[:, None], 0.0)
            else:
                good = active
            nxt = self._sample(row, self.keys, good, jitted=True)
            live = good.long()
            pos = pos + live
            remaining = remaining - live
            done = remaining <= 0
            if self.eos_id is not None:
                done = done | (nxt == self.eos_id)
            toks.append(nxt)
            emitted.append(good)
            active = good & ~done
            tok = nxt
        out = torch.stack(toks), torch.stack(emitted), faulted
        for buf, val in ((self.tok, tok), (self.pos, pos), (self.active, active),
                         (self.remaining, remaining)):
            buf.copy_(val)
        return out

    def _decode(self):
        """One decode chunk: through the CUDA graph when the engine has one,
        else eagerly."""
        with self.rt.use():
            if self._graph is None:
                return self._chunk()
            return self._graph.run(self._chunk, self.params["lm_head"])

    def _chunk_poison(self) -> None:
        """Set the poison buffer for this chunk from the fault plan (with
        none it stays all zeros and nothing is uploaded)."""
        if self.fault_plan is not None:
            p = rfaults.poison_slots(self.fault_plan, self.fault_plan.tick("serve.decode_chunk"),
                                     self.sched.num_slots)
            self.poison.copy_(torch.from_numpy(p))

    # -- the serving loop --------------------------------------------------
    @torch.inference_mode()
    def step(self) -> list[Request]:
        """Stall (injected), expire, shed, admit, retire, admit (backfill),
        retire, run one decode chunk, retire.  Returns the requests that
        finished during this call, expired, shed and errored ones included."""
        now = self._now()
        if self.fault_plan is not None:
            rfaults.stall(self.fault_plan, "step_stall", self.fault_plan.tick("serve.step"))
        finished = self._expire(now)
        finished += self._shed_to_budget(now)
        self._admit_all()
        finished += self._retire_finished()  # requests done at admission
        # backfill slots freed by admission-time finishes before decoding
        self._admit_all()
        finished += self._retire_finished()
        if not bool(self.active.any()):
            return finished
        self._chunk_poison()
        toks, emitted, faulted = (t.cpu() for t in self._decode())
        self.chunks_run += 1
        self.steps_run += self.chunk
        for slot, req in self.sched.occupied():
            new = toks[emitted[:, slot], slot].tolist()
            req.tokens.extend(new)
            self.tokens_out += len(new)
            if faulted[slot]:
                # the watchdog retired this slot inside the chunk: record the
                # error before _retire_finished assigns a reason
                req.finish_reason = "error"
                req.error = "non-finite logits (watchdog)"
                self.log.record("nonfinite", "serve.decode.watchdog", "retire-slot", rid=req.rid,
                                slot=slot, chunk=self.chunks_run - 1, emitted=len(req.tokens))
        finished += self._retire_finished()
        return finished

    def run(self) -> dict[int, list[int]]:
        """Drain every submitted request; returns {rid: emitted tokens}."""
        while self.sched.has_work:
            self.step()
        return {rid: r.tokens for rid, r in self._requests.items()}

    def stats(self) -> dict:
        """Engine + plan-cache counters.  ``decode_graph_captures`` is the
        counterpart of the JAX engine's ``decode_traces``: one per engine
        under the CUDA graph (0 when the chunk runs eagerly)."""
        g = self._graph
        return {
            "tokens_out": self.tokens_out,
            "chunks_run": self.chunks_run,
            "steps_run": self.steps_run,
            "slots": self.sched.num_slots,
            "decode_graph_captures": g.captures if g else 0,
            "decode_graph_replays": g.replays if g else 0,
            "plan_cache": self.rt.plan_cache.stats(),
            "resilience_events": len(self.log),
        }


def generate(params, cfg: ModelConfig, prompt_tokens, *, max_new: int = 32,
             max_len: int | None = None, temperature: float = 0.0, seed: int = 0,
             mesh=None, rt: "rtm.Runtime | None" = None) -> torch.Tensor:
    """Batched generation: every row of ``prompt_tokens [B, S]`` becomes a
    request, slots equal the batch, one chunk covers the whole decode.
    ``mesh`` installs a :class:`~repro_torch.parallel.sharding.
    ShardingPolicy` on the runtime (``params`` are then this rank's shards).
    Returns int ``[B, max_new]`` on the host."""
    if mesh is not None:
        rt = rtm.resolve(rt)
        rt = rt.replace(sharding=(rt.sharding or S.ShardingPolicy()).replace(mesh=mesh))
    prompt_tokens = torch.as_tensor(prompt_tokens, dtype=torch.int64)
    b, s = prompt_tokens.shape
    eng = ServeEngine(
        params, cfg, slots=b, max_len=max_len or (s + max_new), rt=rt,
        temperature=temperature, seed=seed, chunk=max(max_new - 1, 1),
    )
    rids = [eng.submit(prompt_tokens[i], max_new=max_new) for i in range(b)]
    out = eng.run()
    return torch.tensor([out[r] for r in rids], dtype=torch.int32)
