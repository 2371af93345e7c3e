"""Fault injection + graceful degradation (port of ``repro.resilience``).

Two halves, one contract:

* :mod:`repro_torch.resilience.faults` — a deterministic, seeded
  :class:`FaultPlan` harness that injects faults at the runtime's trust
  boundaries (poisoned loss/grads/logits, corrupt plan/cache/DB metadata,
  corrupt checkpoint bytes, failed allocations, stragglers, preemption),
  replayable from one seed — the same faults as the JAX package's for the
  same plan string and seed.

* :mod:`repro_torch.resilience.log` — the structured :class:`ResilienceLog`
  every detection site reports into: fault class, detection site,
  containment action.

The train launcher (``repro_torch.launch.train``) consumes both: a
non-finite step is skipped, a straggler or repeated faults checkpoint and
abort, a preemption saves and exits, and every degradation lands in the
log.  So does the serve engine (``repro_torch.serve.engine``, driven by
``repro_torch.launch.serve``): poisoned decode logits (``poison_slots``) are
retired by its watchdog, a failed cache allocation
(``maybe_alloc_failure``) halves its slots or requeues an admission,
``step_stall`` stalls its step, and deadlines, the bounded queue and
work-budget shedding record into the same log.
"""
from repro_torch.resilience.faults import (  # noqa: F401
    DB_CORRUPTIONS,
    KINDS,
    PLAN_CORRUPTIONS,
    FaultPlan,
    FaultSpec,
    SimulatedAllocFailure,
    SimulatedFault,
    SimulatedShardFailure,
    active,
    corrupt_cache_entry,
    corrupt_db_file,
    corrupt_file,
    corrupt_plan,
    inject,
    maybe_alloc_failure,
    poison_slots,
    stall,
    train_poison,
)
from repro_torch.resilience.log import (  # noqa: F401
    ResilienceEvent,
    ResilienceLog,
    ambient_log,
    capture_warnings,
    record,
    use_log,
)

__all__ = [
    "FaultPlan", "FaultSpec", "KINDS", "PLAN_CORRUPTIONS", "DB_CORRUPTIONS",
    "SimulatedFault", "SimulatedAllocFailure", "SimulatedShardFailure",
    "inject", "active", "corrupt_plan", "corrupt_cache_entry",
    "corrupt_db_file", "corrupt_file", "poison_slots", "train_poison",
    "maybe_alloc_failure", "stall",
    "ResilienceEvent", "ResilienceLog", "use_log", "ambient_log", "record",
    "capture_warnings",
]
