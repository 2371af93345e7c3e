"""Static analysis for the sparse execution stack (port of
``repro.analysis``), none of which runs a kernel:

* :mod:`.plan_check` proves a plan's CSR metadata self-consistent
  (``verify_plan``), a transposed plan against its source
  (``verify_transpose``) and a sharded plan's queues and round trip
  (``verify_shards``); ``Runtime(validate="boundary"|"full")`` wires
  ``check_plan`` into every ``PlanCache`` store, ``edit_plan``,
  caller-provided plan and sharded launch;
* :mod:`.grid_check` re-enacts the CUDA kernels' grids on a plan
  (``check_grid``, ``check_plan_grid``) and on a sharded plan
  (``check_sharded``);
* :mod:`.lint` is the repository's AST linter
  (``python -m repro_torch.analysis.lint src/repro_torch``) for the pitfalls
  of this codebase: host syncs, above all in code a CUDA graph captures.

``python -m repro_torch.analysis`` runs the verifier's self-check.
"""
from repro_torch.analysis.grid_check import check_grid, check_plan_grid, check_sharded
from repro_torch.analysis.plan_check import (
    Finding,
    PlanVerificationError,
    check_plan,
    verify_plan,
    verify_shards,
    verify_transpose,
)

__all__ = [
    "Finding",
    "PlanVerificationError",
    "verify_plan",
    "verify_transpose",
    "verify_shards",
    "check_plan",
    "check_grid",
    "check_plan_grid",
    "check_sharded",
]
