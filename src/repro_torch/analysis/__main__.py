"""``python -m repro_torch.analysis``: the verifier's non-vacuity self-check
(a clean plan verifies clean; seeded corruptions are caught).  Run it
beside ``python -m repro_torch.analysis.lint src/repro_torch``."""
from repro_torch.analysis.plan_check import _selfcheck

raise SystemExit(_selfcheck())
