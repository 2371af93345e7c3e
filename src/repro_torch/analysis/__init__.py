"""Static analysis of plans and kernel grids (port of the single-device part
of ``repro.analysis``): :mod:`.plan_check` proves a plan's CSR metadata
self-consistent, :mod:`.grid_check` re-enacts the CUDA kernels' grids on it.
Neither runs a kernel."""
from repro_torch.analysis.grid_check import check_grid, check_plan_grid
from repro_torch.analysis.plan_check import (
    LEVELS,
    Finding,
    PlanVerificationError,
    check_plan,
    verify_csr,
    verify_plan,
)

__all__ = [
    "LEVELS",
    "Finding",
    "PlanVerificationError",
    "verify_csr",
    "verify_plan",
    "check_plan",
    "check_grid",
    "check_plan_grid",
]
